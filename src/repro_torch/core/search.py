"""Algorithm 1 on the batched engine (port of ``repro.core.search``):
epsilon-greedy SAC with PER, online world-model training, MPC refinement
during exploitation (eps < 0.15), surrogate-gated K-candidate screening,
Pareto archiving of every feasible configuration, and post-convergence
scalarized selection.

Host randomness (env resets, random actions, eps-greedy, PER sampling, the
screen stream) is numpy, consumed exactly as the reference consumes it.
Device randomness (policy, update and MPC noise) comes from two seeded
``torch.Generator``s on the run's device: the main one, and a dedicated
screen one that is drawn only while some gate is open, so a run whose
gates never open is bitwise the ``surrogate_gate=False`` run.

Not ported yet: checkpoint/resume, ``devices``, ``warm_start``,
``save_weights_to``, ``scenario`` (SLO selection), telemetry, and the
scalar ``run_sac`` / ``run_random`` / ``run_grid`` baselines.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.device import to_numpy as _np
from repro_torch.core import actions as act
from repro_torch.core import mpc as mpc_mod
from repro_torch.core import sac as sac_mod
from repro_torch.core import world_model as wm_mod
from repro_torch.core.env import VecDSEEnv
from repro_torch.core.exploration import EpsilonSchedule
from repro_torch.core.hetero import HeteroConfig, derive
from repro_torch.core.pareto import ArchiveEntry, ParetoArchive
from repro_torch.core.partition import partition
from repro_torch.core.replay import PERBuffer
from repro_torch.core.state import SAC_STATE_DIM
from repro_torch.ppa import config_space as cs
from repro_torch.ppa import surrogate as sur_mod
from repro_torch.ppa.analytic import M_IDX, evaluate_vec
from repro_torch.workload.features import Workload

SCREEN_SEED_OFFSET = 7919   # the reference's dedicated screen-stream seed


@dataclasses.dataclass
class SearchConfig:
    episodes: int = 4613          # paper Table 14 per-node budget
    warmup: int = 1000            # SAC warmup (Table 6)
    batch_size: int = 256
    eps0: float = 0.5
    eps_min: float = 0.1
    mpc_eps_gate: float = 0.15    # MPC active when eps < 0.15 (§3.16)
    reset_period: int = 500
    seed: int = 0
    early_stop_patience: int = 1500
    wm_batch: int = 256
    surrogate_every: int = 8
    verbose: bool = False
    updates_per_dispatch: int = 4
    surrogate_gate: bool = True
    screen_k: int = 4
    gate_threshold: float = sur_mod.TAU_SUR_DEFAULT


@dataclasses.dataclass
class TracePoint:
    episode: int
    reward: float
    best_score: float
    eps: float
    entropy: float
    unique_configs: int
    feasible_count: int
    tok_s: float


@dataclasses.dataclass
class SearchResult:
    method: str
    node_nm: int
    best_cfg: Optional[np.ndarray]
    best_metrics: Optional[np.ndarray]
    best_score: float
    archive: ParetoArchive
    trace: List[TracePoint]
    hetero: Optional[HeteroConfig]
    episodes_run: int
    feasible_count: int
    unique_configs: int
    wall_s: float
    gate_open_episode: Optional[int] = None
    screened: int = 0
    evaluated: int = 0
    # host-clock seconds of each dispatch (each ends in a device->host copy,
    # so the clock covers the device work), and how many dispatches ran MPC;
    # shared by all cells of a run
    dispatch_s: List[float] = dataclasses.field(default_factory=list)
    mpc_dispatches: int = 0

    def metric(self, name: str) -> float:
        if self.best_metrics is None:
            return float("nan")
        return float(self.best_metrics[M_IDX[name]])


def _cfg_key(cfg: np.ndarray) -> tuple:
    return tuple(np.round(np.asarray(cfg, np.float64), 3).tolist())


def run_search_cells(workload: Workload, node_nms: Sequence[int], *,
                     high_perf: bool = True,
                     search: Optional[SearchConfig] = None,
                     lanes_per_cell: int = 64,
                     device="cuda") -> List[SearchResult]:
    """Algorithm 1 over a mixed-node cell batch: every entry of
    ``node_nms`` is one search cell with ``lanes_per_cell`` environments,
    all sharing one policy, PER buffer, world model and surrogate.
    ``sc.episodes`` is the per-cell env-step budget.  Returns one
    :class:`SearchResult` per cell, in ``node_nms`` order."""
    sc = search or SearchConfig()
    dev = device_mod.resolve(device)
    n_cells = len(node_nms)
    if n_cells < 1:
        raise ValueError("run_search_cells needs >= 1 cell")
    lanes = lanes_per_cell
    b = n_cells * lanes
    t0 = time.time()
    env = VecDSEEnv(workload, np.repeat(node_nms, lanes).tolist(),
                    high_perf=high_perf, seed=sc.seed, device=dev)
    rng = np.random.default_rng(sc.seed)
    gen = torch.Generator(device=dev).manual_seed(sc.seed)

    sac_state = sac_mod.create(sc.seed, dev)
    wm_state = wm_mod.create(sc.seed + 1, dev)
    surrogate = sur_mod.Surrogate.create(SAC_STATE_DIM + act.N_CONT,
                                         seed=sc.seed + 2, device=dev)
    buf = PERBuffer(SAC_STATE_DIM, act.N_CONT, act.N_DISC, seed=sc.seed)
    eps_sched = EpsilonSchedule(sc.eps0, sc.eps_min, sc.episodes)
    gate = sur_mod.ScreenGate.create(n_cells, sc.gate_threshold)
    gate_on = bool(sc.surrogate_gate) and sc.screen_k > 1
    screen_rng = np.random.default_rng(sc.seed + SCREEN_SEED_OFFSET)
    screen_gen = torch.Generator(device=dev).manual_seed(
        sc.seed + SCREEN_SEED_OFFSET)
    archives = [ParetoArchive() for _ in range(n_cells)]
    traces: List[List[TracePoint]] = [[] for _ in range(n_cells)]
    seen: List[set] = [set() for _ in range(n_cells)]
    best: List[tuple] = [(np.inf, None, None) for _ in range(n_cells)]
    feasible_count = np.zeros(n_cells, np.int64)
    last_entropy = 0.0
    no_improve = 0
    sur_x: deque = deque(maxlen=4)
    sur_y: deque = deque(maxlen=4)
    dispatch_s: List[float] = []
    mpc_dispatches = 0

    n_steps = max(1, sc.episodes // lanes)
    reset_every = max(1, sc.reset_period)
    trace_every = max(1, 50 // lanes)
    t_env = 0
    to_dev = lambda x: torch.as_tensor(x, device=dev)

    s = env.reset()      # (B, 52)
    t = 0
    for t in range(n_steps):
        _dt0 = time.time()
        # ---- action selection: per-element eps-greedy (Alg. 1 l.6) -------
        a_c_rand, a_d_rand = act.random_action_batch(rng, b)
        s_dev = to_dev(s)
        a_c_pol, a_d_pol = sac_mod.policy_act_batch(
            sac_state.params.actor, s_dev, gen=gen)
        a_c_pol, a_d_pol = _np(a_c_pol), _np(a_d_pol)
        if (eps_sched.eps < sc.mpc_eps_gate and surrogate.accepted
                and wm_mod.trained(wm_state)):
            a_mpc = _np(mpc_mod.plan(sac_state.params.actor, wm_state.params,
                                     surrogate.params, s_dev, gen=gen))
            mpc_dispatches += 1
            blend = (mpc_mod.BLEND_MPC * a_mpc
                     + (1.0 - mpc_mod.BLEND_MPC) * a_c_pol)
            a_c_pol[:, :mpc_mod.TCC_ACTION_DIMS] = \
                blend[:, :mpc_mod.TCC_ACTION_DIMS]
        explore = rng.random(b) < eps_sched.eps
        a_c = np.where(explore[:, None], a_c_rand, a_c_pol).astype(np.float32)
        a_d = np.where(explore[:, None], a_d_rand, a_d_pol).astype(np.int32)
        # ---- surrogate-gated screening (Eq. 67): candidate 0 is the exact
        # ungated action; extra candidates draw from the screen streams
        if gate_on and gate.open.any():
            kk = sc.screen_k
            cand_c = np.empty((b, kk, act.N_CONT), np.float32)
            cand_d = np.empty((b, kk, act.N_DISC), np.int32)
            cand_c[:, 0], cand_d[:, 0] = a_c, a_d
            p_c, p_d = sac_mod.policy_act_batch(
                sac_state.params.actor,
                to_dev(np.repeat(s, kk - 1, axis=0)), gen=screen_gen)
            r_c, r_d = act.random_action_batch(screen_rng, b * (kk - 1))
            expl = screen_rng.random(b * (kk - 1)) < eps_sched.eps
            cand_c[:, 1:] = np.where(expl[:, None], r_c,
                                     _np(p_c)).reshape(b, kk - 1, -1)
            cand_d[:, 1:] = np.where(expl[:, None], r_d,
                                     _np(p_d)).reshape(b, kk - 1, -1)
            pick = _np(sur_mod.screen_batch(
                surrogate.params, s_dev, to_dev(cand_c), env.weights,
                to_dev(np.repeat(gate.open, lanes))))
            a_c = cand_c[np.arange(b), pick]
            a_d = cand_d[np.arange(b), pick]
        # ---- env transition: one batched step for B env-steps ------------
        s2, r, info = env.step(a_c, a_d)
        buf.add_batch(s, a_c, a_d, r, s2, np.zeros(b, np.float32))
        sur_x.append(np.concatenate([s, a_c], axis=1).astype(np.float32))
        sur_y.append(info.metrics.astype(np.float32))
        # ---- per-cell best tracking + batched Pareto insert (l.15) -------
        improved = False
        scores = info.metrics[:, M_IDX["ppa_score"]]
        for c in range(n_cells):
            lo, hi = c * lanes, (c + 1) * lanes
            feas_idx = lo + np.nonzero(info.feasible[lo:hi])[0]
            archives[c].insert_batch([
                ArchiveEntry.from_metrics(info.cfg[i], info.metrics[i],
                                          episode=t_env + int(i) - lo)
                for i in feas_idx])
            if feas_idx.size:
                j = int(feas_idx[np.argmin(scores[feas_idx])])
                if float(scores[j]) < best[c][0]:
                    best[c] = (float(scores[j]), info.cfg[j].copy(),
                               info.metrics[j].copy())
                    improved = True
            feasible_count[c] += int(info.feasible[lo:hi].sum())
            for i in range(lo, hi):
                seen[c].add(_cfg_key(info.cfg[i]))
        t_env += lanes
        no_improve = 0 if improved else no_improve + lanes
        # ---- gate accounting + online per-cell calibration (Eq. 66) ------
        if gate_on:
            gate.count(lanes, sc.screen_k)
            if surrogate.n_updates > 0 and not gate.open.all():
                errs = _np(sur_mod.calib_errors(
                    surrogate.params, to_dev(sur_x[-1]),
                    to_dev(info.metrics)))
                gate.observe(errs.reshape(n_cells, lanes).mean(axis=1), t_env)
        else:
            gate.count(lanes, 1)
        # ---- learn (Alg. 1 l.12-13) --------------------------------------
        if buf.size >= max(sc.batch_size, min(sc.warmup, sc.episodes // 4)):
            for _ in range(sc.updates_per_dispatch):
                batch_np, idx = buf.sample(sc.batch_size)
                batch = sac_mod.Batch(**{k: to_dev(v)
                                         for k, v in batch_np.items()})
                sac_state, td_abs, met = sac_mod.update(sac_state, batch,
                                                        gen=gen)
                buf.update_priorities(idx, _np(td_abs))
                last_entropy = float(met["entropy"])
            wmb = buf.recent(sc.wm_batch)
            wm_state, _ = wm_mod.train_step(
                wm_state, to_dev(wmb["s"]), to_dev(wmb["a_cont"]),
                to_dev(wmb["s2"]))
            if t % max(1, sc.surrogate_every // lanes) == 0 and len(sur_x):
                xs = np.concatenate(list(sur_x), axis=0)
                ys = np.concatenate(list(sur_y), axis=0)
                pick = rng.integers(0, len(xs), size=min(256, len(xs)))
                surrogate.update(xs[pick], ys[pick])
        dispatch_s.append(time.time() - _dt0)
        # ---- epsilon decay: one per per-cell env-step (Eq. 9) ------------
        found = bool(feasible_count.sum() > 0)
        for _ in range(lanes):
            eps_sched.step(found_feasible=found)
        if t % trace_every == 0 or t == n_steps - 1:
            for c in range(n_cells):
                lo, hi = c * lanes, (c + 1) * lanes
                traces[c].append(TracePoint(
                    episode=t_env, reward=float(np.mean(r[lo:hi])),
                    best_score=float(best[c][0]), eps=eps_sched.eps,
                    entropy=last_entropy, unique_configs=len(seen[c]),
                    feasible_count=int(feasible_count[c]),
                    tok_s=float(np.mean(
                        info.metrics[lo:hi, M_IDX["tok_s"]]))))
            if sc.verbose:
                bb = min(float(best[c][0]) for c in range(n_cells))
                print(f"  step {t:5d} (ep {t_env}) r={float(np.mean(r)):+.3f} "
                      f"best={bb:.4f} eps={eps_sched.eps:.3f} "
                      f"feas={int(feasible_count.sum())}")
        if t % reset_every == reset_every - 1:
            s = env.reset()
        else:
            s = s2
        if (no_improve > sc.early_stop_patience
                and eps_sched.eps <= sc.eps_min + 1e-6):
            break

    # ---- final selection per cell: Pareto-scalarized (paper §3.10) -------
    results = []
    wall = time.time() - t0
    for c, node_nm in enumerate(node_nms):
        sel = archives[c].select(env.w_perf, env.w_power, env.w_area)
        best_cfg = sel.cfg if sel is not None else best[c][1]
        best_metrics = None
        hetero = None
        if best_cfg is not None:
            with torch.no_grad():
                best_metrics = _np(evaluate_vec(
                    cs.project(to_dev(np.asarray(best_cfg, np.float32)))[None],
                    env.wl_vec, env.node_mat[c * lanes][None]))[0]
            part = partition(workload.graph, best_cfg)
            hetero = derive(best_cfg, part,
                            weight_bytes_total=workload.f("weight_mb") * 1e6)
        results.append(SearchResult(
            method="sac-vec", node_nm=int(node_nm), best_cfg=best_cfg,
            best_metrics=best_metrics,
            best_score=(float(best_metrics[M_IDX["ppa_score"]])
                        if best_metrics is not None else float("inf")),
            archive=archives[c], trace=traces[c], hetero=hetero,
            episodes_run=t_env, feasible_count=int(feasible_count[c]),
            unique_configs=len(seen[c]), wall_s=wall,
            gate_open_episode=(int(gate.open_at[c])
                               if gate.open_at[c] >= 0 else None),
            screened=int(gate.screened[c]),
            evaluated=int(gate.evaluated[c]), dispatch_s=dispatch_s,
            mpc_dispatches=mpc_dispatches))
    return results


def run_search(workload: Workload, node_nm: int, *, high_perf: bool = True,
               search: Optional[SearchConfig] = None, n_envs: int = 64,
               device="cuda") -> SearchResult:
    """Algorithm 1 on the batched engine: ``n_envs`` parallel episodes per
    dispatch (the single-cell view of :func:`run_search_cells`)."""
    return run_search_cells(workload, [node_nm], high_perf=high_perf,
                            search=search, lanes_per_cell=n_envs,
                            device=device)[0]


def search_all_nodes(workload: Workload, nodes: Sequence[int], *,
                     high_perf: bool = True,
                     search: Optional[SearchConfig] = None,
                     n_envs: int = 64, device="cuda") -> Dict[int, SearchResult]:
    """Algorithm 1 outer loop on the batched engine (Eq. 50)."""
    return {n: run_search(workload, n, high_perf=high_perf, search=search,
                          n_envs=n_envs, device=device) for n in nodes}
