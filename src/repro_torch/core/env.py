"""The hardware-design MDP environment (paper §3.1; port of
``repro.core.env``).

One environment = (workload, process node, optimization mode).  Steps apply
mixed discrete/continuous actions to the design vector, re-partition the
operator graph when the mesh changes (or periodically), evaluate the
analytic PPA model, and emit the Table-2 state + Eq.-34 reward.

:class:`DSEEnv` is the scalar engine's environment: host action
application, the host ``partition()``, the analytic evaluator on the env's
``device`` and a host :class:`~repro_torch.core.reward.RewardModel`.
:class:`VecDSEEnv` steps B environments in lockstep on one device: action
application, projection, analytic PPA, the Eq.-34 reward and the Table-2
encoding are torch ops over the whole batch; its partition stats are the
closed-form ``stats_vec`` ("analytic") or the host placement per element
("exact", the scalar env's state bit for bit).  Reset noise comes from
numpy streams (``seed``, or ``seed + lane``) consumed exactly as the
reference consumes them, so reset configurations are bitwise the
reference's.  ``devices`` splits the batch into contiguous chunks, one a
device of ``repro_torch.distributed.sharding.batch_mesh``, as the
reference's ``shard_map`` path does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.device import to_numpy as _np
from repro_torch.core import actions as act
from repro_torch.core import reward as rw
from repro_torch.core import state as st
from repro_torch.core.partition import PartitionResult, partition, stats_vec
from repro_torch.core.reward import RewardModel, adaptive_weights
from repro_torch.distributed.sharding import batch_mesh, shard_call
from repro_torch.ppa import config_space as cs
from repro_torch.ppa.analytic import (M_IDX, evaluate, evaluate_batch,
                                      evaluate_vec, node_matrix, node_vector)
from repro_torch.ppa.nodes import node_params
from repro_torch.workload.features import Workload

# partition-cache key fields (must match DSEEnv._repartition's key)
_PART_KEY_FIELDS = ("mesh_w", "mesh_h", "rho_matmul", "rho_conv",
                    "rho_general", "lb_alpha", "lb_beta")
_PART_KEY_IDX = np.array([cs.IDX[n] for n in _PART_KEY_FIELDS])


def _part_key(row: np.ndarray) -> tuple:
    """The partition cache's key: mesh + ratios + lb weights, coarsely
    quantised (mesh deltas happen nearly every step, and re-running the
    full placement would dominate episode cost)."""
    return (int(row[cs.IDX["mesh_w"]]), int(row[cs.IDX["mesh_h"]]),
            round(float(row[cs.IDX["rho_matmul"]]), 1),
            round(float(row[cs.IDX["rho_conv"]]), 1),
            round(float(row[cs.IDX["rho_general"]]), 1),
            round(float(row[cs.IDX["lb_alpha"]]), 1),
            round(float(row[cs.IDX["lb_beta"]]), 1))


@dataclasses.dataclass
class StepInfo:
    metrics: np.ndarray
    cfg: np.ndarray
    reward_parts: Dict[str, float]
    feasible: bool
    partition_stats: np.ndarray


class DSEEnv:
    """Single-workload, single-node design-space exploration environment;
    the analytic evaluator runs on ``device`` (default ``"cuda"``)."""

    def __init__(self, workload: Workload, node_nm: int, *,
                 high_perf: bool = True, seed: int = 0,
                 partition_period: int = 25,
                 w_perf: Optional[float] = None,
                 w_power: Optional[float] = None,
                 w_area: Optional[float] = None, device="cuda"):
        self.device = device_mod.resolve(device)
        self.workload = workload
        self.node_nm = node_nm
        self.high_perf = high_perf
        self.node = node_params(node_nm, low_power=not high_perf)
        self.node_np = node_vector(self.node, high_perf=high_perf)
        self.node_vec = torch.as_tensor(self.node_np, device=self.device)
        self.wl_np = np.asarray(workload.features, np.float32)
        self.wl_vec = torch.as_tensor(self.wl_np, device=self.device)
        self.rng = np.random.default_rng(seed)
        self.partition_period = partition_period
        # PPA weight profiles (paper §5.4): high-perf (.4,.4,.2),
        # low-power (.2,.6,.2)
        if w_perf is None:
            w_perf, w_power, w_area = ((0.4, 0.4, 0.2) if high_perf
                                       else (0.2, 0.6, 0.2))
        self.reward_model = RewardModel(
            power_budget_mw=self.node.power_budget_mw,
            area_budget_mm2=self.node.area_budget_mm2,
            w_perf=w_perf, w_power=w_power, w_area=w_area)
        self.cfg: np.ndarray = cs.default_config()
        self._part: Optional[PartitionResult] = None
        self._part_cache: Dict[tuple, PartitionResult] = {}
        self._steps_since_partition = 10 ** 9
        self._t = 0

    # ------------------------------------------------------------------ api
    def reset(self, jitter: float = 0.15) -> np.ndarray:
        cfg = cs.default_config()
        noise = self.rng.normal(0.0, jitter, cfg.shape).astype(np.float32)
        cfg = cfg + noise * (cs.HI - cs.LO) * 0.1
        self.cfg = cs.project(torch.as_tensor(cfg)).numpy()
        self._repartition()
        metrics = self._evaluate(self.cfg)
        self._t = 0
        return self._encode(metrics)

    def step(self, a_cont: np.ndarray, a_disc: np.ndarray
             ) -> Tuple[np.ndarray, float, StepInfo]:
        old_mesh = (self.cfg[cs.IDX["mesh_w"]], self.cfg[cs.IDX["mesh_h"]])
        self.cfg = act.apply_action(self.cfg, a_cont, a_disc)
        new_mesh = (self.cfg[cs.IDX["mesh_w"]], self.cfg[cs.IDX["mesh_h"]])
        self._steps_since_partition += 1
        if (new_mesh != old_mesh
                or self._steps_since_partition >= self.partition_period):
            self._repartition()
        metrics = self._evaluate(self.cfg)
        r, parts = self.reward_model(metrics)
        s2 = self._encode(metrics)
        self._t += 1
        info = StepInfo(metrics=metrics, cfg=self.cfg.copy(),
                        reward_parts=parts,
                        feasible=bool(metrics[M_IDX["feasible"]] > 0.5),
                        partition_stats=self._part_stats())
        return s2, r, info

    def evaluate_config(self, cfg: np.ndarray) -> np.ndarray:
        """Evaluate an arbitrary design vector (search baselines)."""
        return self._evaluate(cs.project(torch.as_tensor(
            np.asarray(cfg, np.float32))).numpy())

    # -------------------------------------------------------------- internals
    def _evaluate(self, cfg: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return _np(evaluate(torch.as_tensor(np.asarray(cfg, np.float32),
                                                device=self.device),
                                self.wl_vec, self.node_vec))

    def _repartition(self) -> None:
        key = _part_key(self.cfg)
        hit = self._part_cache.get(key)
        if hit is None:
            hit = partition(self.workload.graph, self.cfg)
            if len(self._part_cache) > 512:
                self._part_cache.pop(next(iter(self._part_cache)))
            self._part_cache[key] = hit
        self._part = hit
        self._steps_since_partition = 0

    def _part_stats(self) -> np.ndarray:
        return (self._part.stats if self._part is not None
                else np.zeros(8, np.float32))

    def _encode(self, metrics: np.ndarray) -> np.ndarray:
        s73 = st.encode(self.wl_np, self.cfg, metrics, self.node_np,
                        self._part_stats())
        return st.sac_state(s73)

    @property
    def partition_result(self) -> Optional[PartitionResult]:
        return self._part


@dataclasses.dataclass
class VecStepInfo:
    """Per-step outputs, every field with a leading batch axis (numpy)."""
    metrics: np.ndarray          # (B, M_DIM)
    cfg: np.ndarray              # (B, 30)
    reward_parts: Dict[str, np.ndarray]
    feasible: np.ndarray         # (B,) bool
    partition_stats: np.ndarray  # (B, 8)


def step_core(cfg, delta_cont, a_disc, wl, node, ranges, weights):
    """The batched step without partition stats or encoding ("exact" mode:
    those wait for the host placement): action application + projection,
    analytic PPA and the Eq.-34 reward."""
    new_cfg = act.apply_action_vec(cfg, delta_cont, a_disc)
    metrics = evaluate_vec(new_cfg, wl, node)
    r, new_ranges, parts = rw.reward_step(metrics, ranges, node, weights)
    return new_cfg, metrics, r, new_ranges, parts


def encode(wl, cfg, metrics, node, part_stats):
    """The Table-2 encoding reduced to the SAC state, over the batch."""
    return st.sac_state_vec(st.encode_vec(wl, cfg, metrics, node, part_stats))


def step_analytic(cfg, delta_cont, a_disc, wl, node, ranges, weights):
    """The fused step over the batch: :func:`step_core`, then the analytic
    partition-stat refresh and the Table-2 encoding."""
    new_cfg, metrics, r, new_ranges, parts = step_core(
        cfg, delta_cont, a_disc, wl, node, ranges, weights)
    part_stats = stats_vec(new_cfg, wl)
    obs = encode(wl, new_cfg, metrics, node, part_stats)
    return new_cfg, metrics, r, new_ranges, parts, part_stats, obs


def reset_eval_analytic(cfg, wl, node):
    metrics = evaluate_vec(cfg, wl, node)
    part_stats = stats_vec(cfg, wl)
    return part_stats, encode(wl, cfg, metrics, node, part_stats)


class VecDSEEnv:
    """B design-space-exploration environments stepped in lockstep on
    ``device`` (default ``"cuda"``).  ``node_nm`` may be one process node
    or a length-B sequence (mixed-node batches).

    partition_mode:
      * "analytic" (default) — the 8 load-distribution state features come
        from the closed-form ``stats_vec`` inside the batched step; the host
        placement never runs.  PPA metrics, reward and feasibility never
        read partition stats; only those 8 observation dims differ from the
        scalar env.
      * "exact" — the scalar env's host partitioner with per-element
        refresh triggers and caches; the full state then matches
        :class:`DSEEnv` element by element.

    ``devices``: split the batch into ``devices`` contiguous chunks, step
    each on its device of ``batch_mesh(devices, device=device)`` and gather
    the results on ``device`` (the reference's ``shard_map`` path, with its
    error for a batch that ``devices`` does not divide).  The step is
    element-wise over the batch, so the chunked engine is bitwise the
    unchunked one; ``devices=1`` runs the chunked path with one chunk and
    ``None`` the plain one.  On the CPU the chunks share the one device."""

    def __init__(self, workload: Workload, node_nm: Union[int, Sequence[int]],
                 *, batch: int = 64, high_perf: bool = True, seed: int = 0,
                 partition_period: int = 25, partition_mode: str = "analytic",
                 w_perf: Optional[float] = None,
                 w_power: Optional[float] = None,
                 w_area: Optional[float] = None,
                 devices: Optional[int] = None, device="cuda"):
        if partition_mode not in ("analytic", "exact"):
            raise ValueError(f"unknown partition_mode {partition_mode!r}")
        self.partition_mode = partition_mode
        self.device = dev = device_mod.resolve(device)
        if isinstance(node_nm, (int, np.integer)):
            node_nms = [int(node_nm)] * batch
        else:
            node_nms = [int(n) for n in node_nm]
            batch = len(node_nms)
        if batch < 1:
            raise ValueError(f"VecDSEEnv needs batch >= 1, got {batch}")
        self.batch = batch
        self.devices = devices
        self.mesh = None
        if devices is not None:
            n = int(devices)
            if batch % max(n, 1):
                raise ValueError(
                    f"VecDSEEnv batch ({batch}) must divide evenly over "
                    f"devices ({n})")
            self.mesh = batch_mesh(n, device=dev)   # raises if n > cards
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
        self.partition_period = partition_period
        # host-side partition state ("exact": per element, as DSEEnv's)
        self._part_caches: List[Dict[tuple, PartitionResult]] = [
            {} for _ in range(batch)]
        self._part_memo: Dict[tuple, PartitionResult] = {}
        self._parts: List[Optional[PartitionResult]] = [None] * batch
        self._part_stats = np.zeros((batch, 8), np.float32)
        self._steps_since = np.full(batch, 10 ** 9, np.int64)
        self._last_mesh = np.zeros((batch, 2), np.float32)

    def reset(self, jitter: float = 0.15) -> np.ndarray:
        base = cs.default_config()
        cfgs = np.empty((self.batch, cs.DIM), np.float32)
        for i, rng in enumerate(self.rngs):
            noise = rng.normal(0.0, jitter, base.shape).astype(np.float32)
            cfgs[i] = base + noise * (cs.HI - cs.LO) * 0.1
        self.cfg = cs.project(torch.as_tensor(cfgs, device=self.device))
        if self.partition_mode == "analytic":
            stats, obs = self._call(reset_eval_analytic, self.cfg,
                                    self.wl_vec, self.node_mat, rep=(1,))
            self._part_stats = _np(stats)
            return _np(obs)
        cfg_np = _np(self.cfg)
        self._refresh_partitions(cfg_np, np.ones(self.batch, bool))
        self._last_mesh = cfg_np[:, _PART_KEY_IDX[:2]].copy()
        metrics = evaluate_vec(self.cfg, self.wl_vec, self.node_mat)
        return _np(self._encode(self.cfg, metrics))

    def step(self, a_cont: np.ndarray, a_disc: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, VecStepInfo]:
        """a_cont: (B, 30) in [-1,1]; a_disc: (B, 4) int in [0,5)."""
        delta = torch.as_tensor(act.cont_delta(np.asarray(a_cont)),
                                device=self.device)
        a_d = torch.as_tensor(np.asarray(a_disc, np.int64),
                              device=self.device)
        if self.partition_mode == "analytic":
            (new_cfg, metrics, r, new_ranges, parts, stats,
             obs) = self._call(step_analytic, self.cfg, delta, a_d,
                               self.wl_vec, self.node_mat, self.ranges,
                               self.weights, rep=(3,))
            self._part_stats = _np(stats)
        else:
            new_cfg, metrics, r, new_ranges, parts = self._call(
                step_core, self.cfg, delta, a_d, self.wl_vec, self.node_mat,
                self.ranges, self.weights, rep=(3,))
            cfg_np = _np(new_cfg)
            mesh = cfg_np[:, _PART_KEY_IDX[:2]]
            self._steps_since += 1
            need = (np.any(mesh != self._last_mesh, axis=1)
                    | (self._steps_since >= self.partition_period))
            self._refresh_partitions(cfg_np, need)
            self._last_mesh = mesh.copy()
            obs = self._encode(new_cfg, metrics)
        self.cfg = new_cfg
        self.ranges = new_ranges
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

    # -------------------------------------------------------------- internals
    def _call(self, fn, *args, rep=()):
        """``fn(*args)``, chunked over the mesh when ``devices`` is set
        (``rep``: the positions of the operands every chunk takes whole)."""
        if self.mesh is None:
            return fn(*args)
        return shard_call(fn, self.mesh, args, replicated=rep,
                          out_device=self.device)

    def _encode(self, cfg: torch.Tensor, metrics: torch.Tensor
                ) -> torch.Tensor:
        stats = torch.as_tensor(self._part_stats, device=self.device)
        return self._call(encode, self.wl_vec, cfg, metrics, self.node_mat,
                          stats, rep=(0,))

    def _refresh_partitions(self, cfg_np: np.ndarray,
                            need: np.ndarray) -> None:
        for i in np.nonzero(need)[0]:
            row = cfg_np[i]
            key = _part_key(row)
            cache = self._part_caches[i]
            hit = cache.get(key)
            if hit is None:
                # share the placement across elements whose partition
                # fields coincide exactly (it is deterministic)
                memo_key = tuple(row[_PART_KEY_IDX].tolist())
                hit = self._part_memo.get(memo_key)
                if hit is None:
                    hit = partition(self.workload.graph, row)
                    if len(self._part_memo) > 4096:
                        self._part_memo.pop(next(iter(self._part_memo)))
                    self._part_memo[memo_key] = hit
                if len(cache) > 512:
                    cache.pop(next(iter(cache)))
                cache[key] = hit
            self._parts[i] = hit
            self._part_stats[i] = hit.stats
            self._steps_since[i] = 0

    @property
    def partition_results(self) -> List[Optional[PartitionResult]]:
        return self._parts
