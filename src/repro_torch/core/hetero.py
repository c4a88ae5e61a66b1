"""Post-RL heterogeneous per-TCC derivation (paper §3.3 "Per-core vs.
global configuration scope").

The RL agent optimises *average* TCC parameters; this step derives per-tile
FETCH_SIZE, VLEN, DMEM, IMEM and WMEM from each tile's workload (compute
load, hazard/instruction density, weight footprint).  STANUM and
DFLIT_WIDTH stay uniform (paper).  The spread controls come from action
dims 26-29.

Also emits the per-TCC JSON artifacts + region aggregates used by the
paper's Tables 15/16 and Figures 10-12.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np

from repro_torch.core.partition import PartitionResult
from repro_torch.ppa import config_space as cs

VLEN_CHOICES = np.array([128, 256, 384, 512, 640, 768, 896, 1024, 1280,
                         1536, 1792, 2048], np.float64)


@dataclasses.dataclass
class HeteroConfig:
    mesh_w: int
    mesh_h: int
    fetch: np.ndarray     # [n_tiles] int
    vlen: np.ndarray      # [n_tiles] bits
    wmem_kb: np.ndarray   # [n_tiles]
    dmem_kb: np.ndarray   # [n_tiles]
    imem_kb: np.ndarray   # [n_tiles]
    stanum: int           # uniform (paper)
    dflit: int            # uniform (paper)

    # ------------------------------------------------------------ stats --
    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, arr in [("FETCH_SIZE", self.fetch), ("VLEN", self.vlen),
                          ("WMEM_KB", self.wmem_kb), ("DMEM_KB", self.dmem_kb),
                          ("IMEM_KB", self.imem_kb)]:
            out[name] = dict(min=float(arr.min()), max=float(arr.max()),
                             mean=float(arr.mean()), median=float(np.median(arr)),
                             std=float(arr.std()),
                             unique=int(np.unique(arr).size))
        return out

    def region_of(self) -> np.ndarray:
        """0=edge, 1=inner, 2=center (Table 15 regions)."""
        W, H = self.mesh_w, self.mesh_h
        xs, ys = np.meshgrid(np.arange(W), np.arange(H), indexing="ij")
        dx = np.minimum(xs, W - 1 - xs)
        dy = np.minimum(ys, H - 1 - ys)
        ring = np.minimum(dx, dy).ravel()
        r = np.ones(W * H, np.int32)
        r[ring == 0] = 0
        r[ring >= max(1, min(W, H) // 4)] = 2
        return r

    def region_summary(self) -> Dict[str, Dict[str, float]]:
        reg = self.region_of()
        out = {}
        for rid, rname in [(0, "edge"), (1, "inner"), (2, "center")]:
            m = reg == rid
            if not m.any():
                continue
            out[rname] = dict(
                avg_wmem_mb=float(self.wmem_kb[m].mean() / 1024.0),
                avg_dflit=float(self.dflit),
                avg_fetch=float(self.fetch[m].mean()),
                std_wmem_mb=float(self.wmem_kb[m].std() / 1024.0),
                n_tiles=int(m.sum()))
        return out

    def gini_wmem(self) -> float:
        srt = np.sort(self.wmem_kb.astype(np.float64))
        tot = srt.sum()
        if tot <= 0:
            return 0.0
        cum = np.cumsum(srt) / tot
        return float(1.0 - 2.0 * np.trapezoid(cum, dx=1.0 / len(srt)))

    def to_json(self, path: str) -> None:
        tiles = [dict(x=i // self.mesh_h, y=i % self.mesh_h,
                      fetch=int(self.fetch[i]), vlen=int(self.vlen[i]),
                      wmem_kb=float(self.wmem_kb[i]),
                      dmem_kb=float(self.dmem_kb[i]),
                      imem_kb=float(self.imem_kb[i]))
                 for i in range(len(self.fetch))]
        with open(path, "w") as f:
            json.dump(dict(mesh=[self.mesh_w, self.mesh_h],
                           stanum=self.stanum, dflit=self.dflit,
                           tiles=tiles), f)


def _spread_scale(load: np.ndarray, spread: float) -> np.ndarray:
    """Map per-tile load percentile to a multiplicative factor in
    [1-spread, 1+spread] (spread in [0,1])."""
    if load.max() <= 0:
        return np.ones_like(load)
    ranks = np.argsort(np.argsort(load)) / max(len(load) - 1, 1)
    return 1.0 + spread * (2.0 * ranks - 1.0)


def derive(cfg: np.ndarray, part: PartitionResult,
           spreads: Optional[np.ndarray] = None,
           weight_bytes_total: float = 0.0) -> HeteroConfig:
    """Derive per-tile parameters from mean config + partition loads."""
    if spreads is None:
        spreads = np.full(4, 0.6, np.float32)  # fetch, vlen, wmem, dmem
    W = int(round(float(cfg[cs.IDX["mesh_w"]])))
    H = int(round(float(cfg[cs.IDX["mesh_h"]])))
    n = W * H
    load = part.flops_load if part.n_tiles == n else np.ones(n)
    instr = part.instr_density if part.n_tiles == n else np.ones(n)

    fetch = np.clip(np.round(float(cfg[cs.IDX["fetch"]])
                             * _spread_scale(instr, float(spreads[0]))), 1, 16)
    vlen_raw = float(cfg[cs.IDX["vlen"]]) * _spread_scale(load, float(spreads[1]))
    vlen = VLEN_CHOICES[np.argmin(
        np.abs(vlen_raw[:, None] - VLEN_CHOICES[None, :]), axis=1)]

    # WMEM follows each tile's placed weight footprint (+ shared page pad);
    # guarantees Eq. 14 at tile granularity.
    wmem_mean_kb = float(cfg[cs.IDX["wmem_kb"]])
    if part.n_tiles == n and part.wmem_bytes.sum() > 0:
        w_need_kb = part.wmem_bytes / 1024.0
        scale = max(1.0, (weight_bytes_total / 1024.0)
                    / max(w_need_kb.sum(), 1.0))
        w_need_kb = w_need_kb * scale
        pad = wmem_mean_kb * (1.0 - float(spreads[2]) * 0.5)
        wmem = np.clip(np.maximum(w_need_kb * (1 + 0.1 * float(spreads[2])),
                                  0.25 * pad), 256, cs.HI[cs.IDX["wmem_kb"]])
        # renormalise toward the RL-selected mean budget, but never below
        # the Eq. 14 coverage requirement
        target = max(wmem_mean_kb * n, w_need_kb.sum() * 1.02)
        wmem = wmem * target / max(wmem.sum(), 1.0)
        wmem = np.clip(wmem, 256, cs.HI[cs.IDX["wmem_kb"]])
    else:
        wmem = np.full(n, wmem_mean_kb)
    wmem = np.round(wmem / 4.0) * 4.0   # 4 KB bank granularity

    dmem = np.clip(np.round(float(cfg[cs.IDX["dmem_kb"]])
                            * _spread_scale(part.dmem_bytes if part.n_tiles == n
                                            else load, float(spreads[3]))
                            / 16.0) * 16.0, 16, 512)
    imem = np.clip(np.round(float(cfg[cs.IDX["imem_kb"]])
                            * _spread_scale(instr, 0.5)), 1, 128)

    return HeteroConfig(
        mesh_w=W, mesh_h=H, fetch=fetch.astype(np.int32),
        vlen=vlen.astype(np.int32), wmem_kb=wmem, dmem_kb=dmem,
        imem_kb=imem.astype(np.int32),
        stanum=int(round(float(cfg[cs.IDX["stanum"]]))),
        dflit=int(round(float(cfg[cs.IDX["dflit"]]))))
