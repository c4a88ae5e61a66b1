"""The batched hardware-design MDP environment (paper §3.1; port of
``repro.core.env.VecDSEEnv``, analytic partition mode).

B environments step in lockstep on one device: action application,
projection, analytic partition stats, analytic PPA, the Eq.-34 reward and
the Table-2 encoding are torch ops over the whole batch.  Reset noise comes
from per-lane numpy streams ``seed + lane`` consumed exactly as the
reference consumes them, so reset configurations are bitwise the
reference's.  Not ported yet: ``partition_mode="exact"``, ``devices``
sharding and the scalar ``DSEEnv``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.device import to_numpy as _np
from repro_torch.core import actions as act
from repro_torch.core import reward as rw
from repro_torch.core import state as st
from repro_torch.core.partition import stats_vec
from repro_torch.core.reward import adaptive_weights
from repro_torch.ppa import config_space as cs
from repro_torch.ppa.analytic import (M_IDX, evaluate_batch, evaluate_vec,
                                      node_matrix)
from repro_torch.ppa.nodes import node_params
from repro_torch.workload.features import Workload


@dataclasses.dataclass
class VecStepInfo:
    """Per-step outputs, every field with a leading batch axis (numpy)."""
    metrics: np.ndarray          # (B, M_DIM)
    cfg: np.ndarray              # (B, 30)
    reward_parts: Dict[str, np.ndarray]
    feasible: np.ndarray         # (B,) bool
    partition_stats: np.ndarray  # (B, 8)


def step_analytic(cfg, delta_cont, a_disc, wl, node, ranges, weights):
    """The fused step over the batch: action application + projection,
    analytic PPA, Eq.-34 reward, partition-stat refresh, Table-2 encoding."""
    new_cfg = act.apply_action_vec(cfg, delta_cont, a_disc)
    metrics = evaluate_vec(new_cfg, wl, node)
    r, new_ranges, parts = rw.reward_step(metrics, ranges, node, weights)
    part_stats = stats_vec(new_cfg, wl)
    obs = st.sac_state_vec(st.encode_vec(wl, new_cfg, metrics, node,
                                         part_stats))
    return new_cfg, metrics, r, new_ranges, parts, part_stats, obs


def reset_eval_analytic(cfg, wl, node):
    metrics = evaluate_vec(cfg, wl, node)
    part_stats = stats_vec(cfg, wl)
    obs = st.sac_state_vec(st.encode_vec(wl, cfg, metrics, node, part_stats))
    return part_stats, obs


class VecDSEEnv:
    """B design-space-exploration environments stepped in lockstep on
    ``device`` (default ``"cuda"``).  ``node_nm`` may be one process node
    or a length-B sequence (mixed-node batches)."""

    def __init__(self, workload: Workload, node_nm: Union[int, Sequence[int]],
                 *, batch: int = 64, high_perf: bool = True, seed: int = 0,
                 partition_mode: str = "analytic",
                 w_perf: Optional[float] = None,
                 w_power: Optional[float] = None,
                 w_area: Optional[float] = None,
                 devices: Optional[int] = None, device="cuda"):
        if partition_mode != "analytic":
            raise NotImplementedError(
                f"partition_mode={partition_mode!r}: only 'analytic' is "
                "ported")
        if devices is not None:
            raise NotImplementedError(
                "devices: sharding the batch over several cards is not "
                "ported; leave devices=None")
        self.device = dev = device_mod.resolve(device)
        if isinstance(node_nm, (int, np.integer)):
            node_nms = [int(node_nm)] * batch
        else:
            node_nms = [int(n) for n in node_nm]
            batch = len(node_nms)
        if batch < 1:
            raise ValueError(f"VecDSEEnv needs batch >= 1, got {batch}")
        self.batch = batch
        self.workload = workload
        self.node_nms = node_nms
        self.high_perf = high_perf
        self.nodes = [node_params(n, low_power=not high_perf)
                      for n in node_nms]
        self.node_mat = torch.as_tensor(
            node_matrix(self.nodes, high_perf=high_perf), device=dev)
        self.wl_vec = torch.as_tensor(np.asarray(workload.features,
                                                 np.float32), device=dev)
        self.rngs = [np.random.default_rng(seed + i) for i in range(batch)]
        if w_perf is None:
            w_perf, w_power, w_area = ((0.4, 0.4, 0.2) if high_perf
                                       else (0.2, 0.6, 0.2))
        self.w_perf, self.w_power, self.w_area = w_perf, w_power, w_area
        self.weights = torch.tensor(
            adaptive_weights(w_perf, w_power, w_area), dtype=torch.float32,
            device=dev).expand(batch, 3).contiguous()
        self.ranges = rw.init_ranges(self.node_mat)
        self.cfg = torch.as_tensor(cs.default_config(), device=dev).expand(
            batch, cs.DIM).contiguous()
        self._part_stats = np.zeros((batch, 8), np.float32)

    def reset(self, jitter: float = 0.15) -> np.ndarray:
        base = cs.default_config()
        cfgs = np.empty((self.batch, cs.DIM), np.float32)
        for i, rng in enumerate(self.rngs):
            noise = rng.normal(0.0, jitter, base.shape).astype(np.float32)
            cfgs[i] = base + noise * (cs.HI - cs.LO) * 0.1
        self.cfg = cs.project(torch.as_tensor(cfgs, device=self.device))
        stats, obs = reset_eval_analytic(self.cfg, self.wl_vec, self.node_mat)
        self._part_stats = _np(stats)
        return _np(obs)

    def step(self, a_cont: np.ndarray, a_disc: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, VecStepInfo]:
        """a_cont: (B, 30) in [-1,1]; a_disc: (B, 4) int in [0,5)."""
        delta = torch.as_tensor(act.cont_delta(np.asarray(a_cont)),
                                device=self.device)
        a_d = torch.as_tensor(np.asarray(a_disc, np.int64),
                              device=self.device)
        (new_cfg, metrics, r, new_ranges, parts, stats,
         obs) = step_analytic(self.cfg, delta, a_d, self.wl_vec,
                              self.node_mat, self.ranges, self.weights)
        self.cfg = new_cfg
        self.ranges = new_ranges
        self._part_stats = _np(stats)
        metrics_np = _np(metrics)
        info = VecStepInfo(
            metrics=metrics_np, cfg=_np(new_cfg),
            reward_parts={k: _np(v) for k, v in parts.items()},
            feasible=metrics_np[:, M_IDX["feasible"]] > 0.5,
            partition_stats=self._part_stats.copy())
        return _np(obs), _np(r), info

    def evaluate_configs(self, cfgs: np.ndarray) -> np.ndarray:
        """Evaluate (N, 30) design vectors.  N == batch pairs cfgs with
        per-element nodes; any other N evaluates every cfg on element 0's
        node (single-node envs only)."""
        proj = cs.project(torch.as_tensor(np.asarray(cfgs, np.float32),
                                          device=self.device))
        if proj.ndim == 1:
            proj = proj[None]
        if proj.shape[0] == self.batch:
            return _np(evaluate_vec(proj, self.wl_vec, self.node_mat))
        if len(set(self.node_nms)) > 1:
            raise ValueError("cfg batch size must match env batch for "
                             "mixed-node VecDSEEnv")
        return _np(evaluate_batch(proj, self.wl_vec, self.node_mat[0]))
