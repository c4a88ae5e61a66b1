"""Operation-level partitioning across TCCs (paper §3.5; port of
``repro.core.partition``).

For each operator: determine type -> select partition ratio (Eq. 10-13)
-> compute target core count -> communication-graph-aware placement
(composite score: current load, NoC hop distance to producers, imbalance
penalty, mesh centrality) -> split workload across the selected tiles.

Outputs per-tile load/memory maps and the load-distribution statistics that
feed the RL state (Table 2 idx 29-32, 55-58) and the heterogeneous per-TCC
derivation (repro_torch.core.hetero).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

import torch

from repro_torch.ppa import config_space as cs
from repro_torch.workload.features import (KIND_ATTENTION, KIND_CONV,
                                           KIND_MATMUL, KIND_SCAN, WL_IDX,
                                           WorkloadGraph)

PARTITIONABLE = (KIND_MATMUL, KIND_CONV, KIND_ATTENTION, KIND_SCAN)
FLOP_THRESHOLD = 1e4   # ops below this always go to a single tile


@dataclasses.dataclass
class PartitionResult:
    flops_load: np.ndarray    # [n_tiles] per-token FLOPs
    wmem_bytes: np.ndarray    # [n_tiles]
    dmem_bytes: np.ndarray    # [n_tiles]
    instr_density: np.ndarray # [n_tiles] op count hosted
    xtile_bytes: float        # estimated cross-tile traffic per token
    stats: np.ndarray         # [8] state-feature stats (see state.encode)
    op_tiles: Dict[int, np.ndarray]  # op index -> tile ids

    @property
    def n_tiles(self) -> int:
        return int(self.flops_load.shape[0])


def _stats(load: np.ndarray) -> np.ndarray:
    tot = load.sum()
    if tot <= 0:
        return np.zeros(8, np.float32)
    n = load / max(load.mean(), 1e-12)
    var = float(np.clip(n.var(), 0, 10.0) / 10.0)
    mx, mn = float(load.max()), float(max(load.min(), 1e-12))
    ratio = mx / mn
    balance = float(load.mean() / max(load.max(), 1e-12))
    srt = np.sort(load)
    cum = np.cumsum(srt) / tot
    gini = float(1.0 - 2.0 * np.trapezoid(cum, dx=1.0 / len(load)))
    return np.array([var, min(ratio, 100.0), balance, gini,
                     float(n.mean()) / 2.0, float(np.clip(n.std(), 0, 2)) / 2.0,
                     float(np.clip(n.max(), 0, 4)) / 4.0,
                     float(np.clip(n.min(), 0, 1))], np.float32)


def stats_vec(cfg: torch.Tensor, wl: torch.Tensor) -> torch.Tensor:
    """Closed-form proxy of the load-distribution stats, batched (the
    reference's ``stats_vec``; see its docstring for the model).

    cfg: (B, 30); wl: (WL_DIM,) -> (B, 8) float32 in the `_stats` layout.
    """
    n_tiles = (torch.round(cfg[:, cs.IDX["mesh_w"]])
               * torch.round(cfg[:, cs.IDX["mesh_h"]]))
    rho = lambda name: torch.clamp(
        cs.RHO_BASE + cfg[:, cs.IDX[name]] - 0.3, 0.0, 1.0)      # Eq. 10-13
    mm = wl[WL_IDX["matmul_ratio"]]
    cv = wl[WL_IDX["conv_ratio"]]
    gen = torch.clamp_min(1.0 - mm - cv, 0.0)
    c = torch.clamp_max(torch.maximum(
        mm * rho("rho_matmul") + cv * rho("rho_conv")
        + gen * rho("rho_general"), 1.0 / n_tiles), 1.0)
    lb = cfg[:, cs.IDX["lb_alpha"]]
    n_min = torch.clamp(lb * (1.0 - c), 0.0, 1.0)
    n_max = torch.clamp_min((1.0 / c) * (1.0 - 0.3 * lb), 1.0)
    var = (1.0 - c) / c * (1.0 - 0.5 * lb)
    n_std = torch.sqrt(torch.clamp_min(var, 0.0))
    ratio = torch.clamp_max(n_max / torch.clamp_min(n_min, 1e-2), 100.0)
    balance = torch.clamp(c * (1.0 + 0.3 * lb), 0.0, 1.0)
    gini = torch.clamp((1.0 - c) * (1.0 - 0.5 * lb), 0.0, 1.0)
    return torch.stack([
        torch.clamp(var, 0.0, 10.0) / 10.0, ratio, balance, gini,
        torch.full_like(c, 0.5), torch.clamp(n_std, 0.0, 2.0) / 2.0,
        torch.clamp(n_max, 0.0, 4.0) / 4.0, n_min], dim=-1).to(torch.float32)


def partition(graph: WorkloadGraph, cfg: np.ndarray, seed: int = 0
              ) -> PartitionResult:
    """Partition + place the operator graph on the configured mesh."""
    W = int(round(float(cfg[cs.IDX["mesh_w"]])))
    H = int(round(float(cfg[cs.IDX["mesh_h"]])))
    n_tiles = W * H
    rho_m = float(np.clip(cs.RHO_BASE + cfg[cs.IDX["rho_matmul"]] - 0.3, 0.0, 1.0))
    rho_c = float(np.clip(cs.RHO_BASE + cfg[cs.IDX["rho_conv"]] - 0.3, 0.0, 1.0))
    rho_g = float(np.clip(cs.RHO_BASE + cfg[cs.IDX["rho_general"]] - 0.3, 0.0, 1.0))
    lb_alpha = float(cfg[cs.IDX["lb_alpha"]])
    lb_beta = float(cfg[cs.IDX["lb_beta"]])

    xs, ys = np.meshgrid(np.arange(W), np.arange(H), indexing="ij")
    tx, ty = xs.ravel().astype(np.float64), ys.ravel().astype(np.float64)
    centr = (np.abs(tx - (W - 1) / 2) + np.abs(ty - (H - 1) / 2))
    centr = centr / max(centr.max(), 1.0)

    load = np.zeros(n_tiles)
    wmem = np.zeros(n_tiles)
    dmem = np.zeros(n_tiles)
    instr = np.zeros(n_tiles)
    # centroid position of each op's placement (for hop distances)
    op_x = np.zeros(graph.n_ops)
    op_y = np.zeros(graph.n_ops)
    op_tiles: Dict[int, np.ndarray] = {}
    xtile = 0.0

    prod = [[] for _ in range(graph.n_ops)]
    for s, d in graph.edges:
        prod[d].append(s)

    mean_flops = max(float(graph.flops.mean()), 1e-9)
    for i in range(graph.n_ops):
        k = int(graph.kind[i])
        fl = float(graph.flops[i])
        if k in PARTITIONABLE and fl > FLOP_THRESHOLD:
            rho = {KIND_MATMUL: rho_m, KIND_CONV: rho_c}.get(k, rho_g)  # Eq. 10
            n_cores_op = max(1, int(np.ceil(rho * n_tiles)))            # step 3
        else:
            n_cores_op = 1
        # ---- communication-graph-aware placement (step 4) ----------------
        if prod[i]:
            px = np.mean([op_x[p] for p in prod[i]])
            py = np.mean([op_y[p] for p in prod[i]])
            hop = np.abs(tx - px) + np.abs(ty - py)
            hop = hop / max(hop.max(), 1.0)
        else:
            hop = centr
        load_n = load / max(load.max(), 1e-12)
        imbalance = np.maximum(0.0, load_n - load_n.mean())
        score = (lb_alpha * load_n + lb_beta * hop
                 + 0.5 * imbalance + 0.1 * centr)
        sel = np.argpartition(score, n_cores_op - 1)[:n_cores_op]
        # ---- split workload (step 5) --------------------------------------
        load[sel] += fl / n_cores_op
        wmem[sel] += float(graph.weight_bytes[i]) / n_cores_op
        dmem[sel] += float(graph.out_bytes[i]) / n_cores_op
        instr[sel] += 1.0 + fl / mean_flops / n_cores_op
        op_x[i] = tx[sel].mean()
        op_y[i] = ty[sel].mean()
        op_tiles[i] = sel
        # cross-tile traffic: producer->consumer centroid Manhattan distance
        for p in prod[i]:
            d_hop = abs(op_x[i] - op_x[p]) + abs(op_y[i] - op_y[p])
            xtile += float(graph.out_bytes[p]) * min(d_hop, 1.0 + d_hop * 0.2)

    return PartitionResult(
        flops_load=load, wmem_bytes=wmem, dmem_bytes=dmem,
        instr_density=instr, xtile_bytes=xtile, stats=_stats(load),
        op_tiles=op_tiles)
