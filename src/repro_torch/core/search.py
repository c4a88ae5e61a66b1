"""Algorithm 1 (port of ``repro.core.search``): epsilon-greedy SAC with
PER, online world-model training, MPC refinement during exploitation
(eps < 0.15), surrogate-gated K-candidate screening (batched engine),
Pareto archiving of every feasible configuration, and post-convergence
scalarized (or, under a serving scenario, SLO-aware) selection.  Also the
scalar production loop (:func:`run_sac`, one environment per step) and the
random-search and grid-search baselines of Table 21.

Host randomness (env resets, random actions, eps-greedy, PER sampling, the
screen stream) is numpy, consumed exactly as the reference consumes it.
Device randomness (policy, update and MPC noise) comes from two seeded
``torch.Generator``s on the run's device: the main one, and a dedicated
screen one that is drawn only while some gate is open, so a run whose
gates never open is bitwise the ``surrogate_gate=False`` run.

The PER buffer lives on the run's device (``core.replay``), its sum-tree
written through the ``sumtree`` kernel; surrogate calibration and the MPC
rollouts run through ``fused_mlp``.  Checkpoint/resume and the final
weights snapshot use the reference's layout and leaf names
(``checkpoint.manager``); the torch generators' states are saved as
``device/gen`` and ``device/screen_gen`` in place of the reference's
``device/key`` and ``device/screen_key``.

The scalar loop keeps its PER on the run's device too (one ``sumtree``
launch an insert, ``sumtree_sample`` an update) and acts through the
``actor_moe`` kernel at B = 1; its numpy streams are the reference's, so
:func:`run_random` draws the reference's configurations and
:func:`run_grid` walks its lattice.

Telemetry (``repro_torch.obs``) is wired where the reference wires it:
registry taps fed once a dispatch from host values the loop already holds
(no device synchronisation the untraced loop does not do), the
``first_dispatch`` and ``checkpoint`` spans, the ``search`` counters and
the ``run_search_cells`` span.  It reads clocks and counters only, so a
traced search is bitwise an untraced one.  ``devices`` chunks the env
batch over a ``batch_mesh`` (``core.env``); ``warm_start`` seeds a fresh
batch from a donor campaign (``campaign.transfer``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import manager as ckpt_mod
from repro_torch.device import to_numpy as _np
from repro_torch.core import actions as act
from repro_torch.core import mpc as mpc_mod
from repro_torch.core import sac as sac_mod
from repro_torch.core import world_model as wm_mod
from repro_torch.core import reward as rwd
from repro_torch.core.env import DSEEnv, VecDSEEnv
from repro_torch.core.exploration import EpsilonSchedule
from repro_torch.core.hetero import HeteroConfig, derive
from repro_torch.core.pareto import ArchiveEntry, ParetoArchive
from repro_torch.core.partition import partition
from repro_torch.core.replay import PERBuffer
from repro_torch.core.state import SAC_STATE_DIM
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.ppa import config_space as cs
from repro_torch.ppa import surrogate as sur_mod
from repro_torch.ppa.analytic import (M_DIM, M_IDX, evaluate_batch,
                                      evaluate_vec)
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
    update_every: int = 1         # scalar loop: env-steps between updates
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
    # SLO-aware scenario selection (set only when run_search_cells got a
    # ``scenario``): prefill-phase TTFT of the chosen design and whether it
    # met both SLO targets
    ttft_ms: Optional[float] = None
    slo_ok: Optional[bool] = None
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


def _update_best(best, metrics, cfg, archive, episode):
    """paper line 15: if PPA < s* and feasible -> keep."""
    score = float(metrics[M_IDX["ppa_score"]])
    feas = metrics[M_IDX["feasible"]] > 0.5
    if feas:
        archive.insert(ArchiveEntry(
            cfg=cfg.copy(), power_mw=float(metrics[M_IDX["power_mw"]]),
            perf_gops=float(metrics[M_IDX["perf_gops"]]),
            area_mm2=float(metrics[M_IDX["area_mm2"]]),
            tok_s=float(metrics[M_IDX["tok_s"]]),
            ppa_score=score, episode=episode))
        if score < best[0]:
            return (score, cfg.copy(), metrics.copy()), True
    return best, feas


def run_sac(workload: Workload, node_nm: int, *, high_perf: bool = True,
            search: Optional[SearchConfig] = None,
            device="cuda") -> SearchResult:
    """The paper's production flow on one environment (the scalar
    engine): SAC + MoE + PER + world model + MPC, one env-step and (from
    the warm-up on, every ``update_every`` steps) one SAC update at a time.

    Host randomness (eps-greedy, random actions, env resets, PER uniforms,
    surrogate minibatches) is the reference's numpy streams; device noise
    comes from one ``torch.Generator`` seeded with ``sc.seed`` on the run's
    device, so two same-seed runs on one device are identical."""
    sc = search or SearchConfig()
    dev = device_mod.resolve(device)
    t0 = time.time()
    env = DSEEnv(workload, node_nm, high_perf=high_perf, seed=sc.seed,
                 device=dev)
    rng = np.random.default_rng(sc.seed)
    gen = torch.Generator(device=dev).manual_seed(sc.seed)
    to_dev = lambda x: torch.as_tensor(x, device=dev)

    sac_state = sac_mod.create(sc.seed, dev)
    wm_state = wm_mod.create(sc.seed + 1, dev)
    surrogate = sur_mod.Surrogate.create(SAC_STATE_DIM + act.N_CONT,
                                         seed=sc.seed + 2, device=dev)
    buf = PERBuffer(SAC_STATE_DIM, act.N_CONT, act.N_DISC, seed=sc.seed,
                    device=dev)
    eps_sched = EpsilonSchedule(sc.eps0, sc.eps_min, sc.episodes)
    archive = ParetoArchive()
    trace: List[TracePoint] = []
    seen: set = set()
    best = (np.inf, None, None)
    feasible_count = 0
    last_entropy = 0.0
    no_improve = 0
    mpc_steps = 0
    step_s: List[float] = []

    sur_x: List[np.ndarray] = []
    sur_y: List[np.ndarray] = []

    s = env.reset()
    t = 0
    for t in range(sc.episodes):
        _dt0 = time.time()
        # ---- action selection: eps-greedy over SAC policy (Alg. 1 l.6) ----
        if rng.random() < eps_sched.eps:
            a_c, a_d = act.random_action(rng)
        else:
            s_dev = to_dev(s)
            a_c_t, a_d_t = sac_mod.policy_act(sac_state.params.actor, s_dev,
                                              gen=gen)
            # MPC refinement during exploitation (Alg. 1 l.14)
            if (eps_sched.eps < sc.mpc_eps_gate and surrogate.accepted
                    and wm_mod.trained(wm_state)):
                a_mpc = mpc_mod.plan(sac_state.params.actor, wm_state.params,
                                     surrogate.params, s_dev[None],
                                     gen=gen)[0]
                a_c_t = mpc_mod.refine(a_c_t, a_mpc)
                mpc_steps += 1
            a_c, a_d = _np(a_c_t), _np(a_d_t).astype(np.int32)
        # ---- env transition (Alg. 1 l.7-10) -------------------------------
        s2, r, info = env.step(a_c, a_d)
        buf.add_batch(s[None], a_c[None], a_d[None],
                      np.asarray([r], np.float32), s2[None],
                      np.zeros(1, np.float32))
        sur_x.append(np.concatenate([s, a_c]).astype(np.float32))
        sur_y.append(info.metrics.astype(np.float32))
        prev_best_score = best[0]
        best, feas = _update_best(best, info.metrics, info.cfg, archive, t)
        feasible_count += int(feas)
        seen.add(_cfg_key(info.cfg))
        no_improve = 0 if best[0] < prev_best_score else no_improve + 1
        # ---- learn (Alg. 1 l.12-13) ---------------------------------------
        if buf.size >= max(sc.batch_size, min(sc.warmup, sc.episodes // 4)) \
                and t % sc.update_every == 0:
            batch_d, idx = buf.sample(sc.batch_size)
            sac_state, td_abs, met = sac_mod.update(
                sac_state, sac_mod.Batch(**batch_d), gen=gen)
            buf.update_priorities(idx, td_abs)
            last_entropy = float(met["entropy"])
            wmb = buf.recent(sc.wm_batch)
            wm_state, _ = wm_mod.train_step(wm_state, wmb["s"],
                                            wmb["a_cont"], wmb["s2"])
            if t % sc.surrogate_every == 0 and len(sur_x) >= 64:
                pick = rng.integers(0, len(sur_x), size=min(256, len(sur_x)))
                surrogate.update(np.stack([sur_x[i] for i in pick]),
                                 np.stack([sur_y[i] for i in pick]))
                if len(sur_x) > 20_000:   # bound host memory
                    sur_x = sur_x[-10_000:]
                    sur_y = sur_y[-10_000:]
        step_s.append(time.time() - _dt0)
        # ---- epsilon decay (Eq. 9) ----------------------------------------
        eps_sched.step(found_feasible=feasible_count > 0)
        if t % 50 == 0 or t == sc.episodes - 1:
            trace.append(TracePoint(
                episode=t, reward=r, best_score=float(best[0]),
                eps=eps_sched.eps, entropy=last_entropy,
                unique_configs=len(seen), feasible_count=feasible_count,
                tok_s=float(info.metrics[M_IDX["tok_s"]])))
            if sc.verbose:
                print(f"  ep {t:5d} r={r:+.3f} best={best[0]:.4f} "
                      f"eps={eps_sched.eps:.3f} feas={feasible_count}")
        if t % sc.reset_period == sc.reset_period - 1:
            s = env.reset()
        else:
            s = s2
        if (no_improve > sc.early_stop_patience
                and eps_sched.eps <= sc.eps_min + 1e-6):
            break

    # ---- final selection: Pareto-scalarized (paper §3.10) ----------------
    sel = archive.select(env.reward_model.w_perf, env.reward_model.w_power,
                         env.reward_model.w_area)
    best_cfg = sel.cfg if sel is not None else best[1]
    best_metrics = (env.evaluate_config(best_cfg)
                    if best_cfg is not None else None)
    hetero = None
    if best_cfg is not None:
        env.cfg = best_cfg.copy()
        env._repartition()
        hetero = derive(best_cfg, env.partition_result,
                        weight_bytes_total=workload.f("weight_mb") * 1e6)
    return SearchResult(
        method="sac", node_nm=node_nm, best_cfg=best_cfg,
        best_metrics=best_metrics,
        best_score=(float(best_metrics[M_IDX["ppa_score"]])
                    if best_metrics is not None else float("inf")),
        archive=archive, trace=trace, hetero=hetero, episodes_run=t + 1,
        feasible_count=feasible_count, unique_configs=len(seen),
        wall_s=time.time() - t0, screened=t + 1, evaluated=t + 1,
        dispatch_s=step_s, mpc_dispatches=mpc_steps)


def _restore_np_rng(state: Dict) -> np.random.Generator:
    g = np.random.default_rng()
    g.bit_generator.state = state
    return g


def _save_search_ckpt(ckpt_dir: str, step: int, tree: Dict, extra: Dict,
                      *, keep: int = 2) -> str:
    """Checkpoint hook: atomic save of the full search loop state.

    Module-level so the kill/resume tests can wrap it; the campaign runner
    points ``checkpoint_dir`` at its per-batch directory."""
    return ckpt_mod.save(tree, ckpt_dir, step, keep=keep, extra=extra)


def run_search_cells(workload: Workload, node_nms: Sequence[int], *,
                     high_perf: bool = True,
                     search: Optional[SearchConfig] = None,
                     lanes_per_cell: int = 64,
                     checkpoint_dir: Optional[str] = None,
                     checkpoint_every: int = 0,
                     resume: bool = False,
                     devices: Optional[int] = None,
                     warm_start: Optional[Dict] = None,
                     save_weights_to: Optional[str] = None,
                     scenario: Optional[Dict] = None,
                     device="cuda") -> List[SearchResult]:
    """Algorithm 1 over a mixed-node cell batch: every entry of
    ``node_nms`` is one search cell with ``lanes_per_cell`` environments,
    all sharing one policy, PER buffer, world model and surrogate.
    ``sc.episodes`` is the per-cell env-step budget.  Returns one
    :class:`SearchResult` per cell, in ``node_nms`` order.

    With ``checkpoint_dir`` set and ``checkpoint_every > 0`` the whole loop
    state (learner, world model and surrogate with their optimizers, the
    PER arrays and float64 tree, archives, incumbents, epsilon, gate state,
    every numpy stream and both torch generators) is checkpointed every
    ``checkpoint_every`` dispatches; ``resume=True`` restarts from the
    latest checkpoint and reproduces the uninterrupted run bit-for-bit.
    ``save_weights_to`` snapshots the final SAC and surrogate parameters
    there (``keep=1``).

    ``scenario`` (SLO-aware phase combination): a dict with ``aux_wl``
    (the prefill-phase :class:`Workload` paired with the decode search
    workload), ``slo`` (resolved ``{"ttft_ms", "tok_s"}`` targets),
    ``seq_len`` and ``batch``.  Final selection then minimises
    ``reward.slo_objective`` over each cell's Pareto archive — TTFT from
    the prefill evaluation on the run's device, tokens/s from decode —
    instead of the plain scalarisation, and the results carry
    ``ttft_ms``/``slo_ok``.  Strictly post-loop: ``scenario=None`` is the
    engine without it, bit for bit.

    ``devices``: chunk the B = cells x lanes batch of the env step over a
    ``batch_mesh(devices)`` (``VecDSEEnv``); the step is element-wise over
    the batch, so every result is bitwise the ``devices=None`` run's.

    ``warm_start`` (cross-campaign transfer, ``campaign.transfer``)
    seeds a fresh start: ``warm_start["flat"]`` holds donor leaves named
    ``sac/...`` and ``sur_params/...`` (a batch's final-weights snapshot,
    of either package) that replace the SAC state and the surrogate's
    parameters, each leaf a tensor of its own on the run's device; and
    ``warm_start["cells"][c]`` may carry ``entries`` (re-evaluated donor
    designs) and ``best`` (``(score, cfg, metrics)``) inserted into cell
    c's archive and incumbent before the first reset.  A checkpoint
    resume ignores it: the checkpoint already holds the warmed state."""
    sc = search or SearchConfig()
    dev = device_mod.resolve(device)
    n_cells = len(node_nms)
    if n_cells < 1:
        raise ValueError("run_search_cells needs >= 1 cell")
    lanes = lanes_per_cell
    b = n_cells * lanes
    t0 = time.time()
    env = VecDSEEnv(workload, np.repeat(node_nms, lanes).tolist(),
                    high_perf=high_perf, seed=sc.seed, devices=devices,
                    device=dev)
    rng = np.random.default_rng(sc.seed)
    gen = torch.Generator(device=dev).manual_seed(sc.seed)

    sac_state = sac_mod.create(sc.seed, dev)
    wm_state = wm_mod.create(sc.seed + 1, dev)
    surrogate = sur_mod.Surrogate.create(SAC_STATE_DIM + act.N_CONT,
                                         seed=sc.seed + 2, device=dev)
    buf = PERBuffer(SAC_STATE_DIM, act.N_CONT, act.N_DISC, seed=sc.seed,
                    device=dev)
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
    start_t = 0
    t_env = 0            # per-cell env-steps completed
    to_dev = lambda x: torch.as_tensor(x, device=dev)

    if resume and checkpoint_dir and ckpt_mod.latest_step(checkpoint_dir):
        flat, manifest = ckpt_mod.restore_flat(checkpoint_dir)
        ex = manifest["extra"]
        if (list(ex["node_nms"]) != [int(n) for n in node_nms]
                or ex["lanes"] != lanes or ex["episodes"] != sc.episodes
                or bool(ex["high_perf"]) != bool(high_perf)
                or int(ex["seed"]) != sc.seed):
            raise ValueError(
                f"checkpoint in {checkpoint_dir} was written for cells "
                f"{ex['node_nms']} x{ex['lanes']} lanes @{ex['episodes']} ep "
                f"(high_perf={ex['high_perf']}, seed={ex['seed']}); got "
                f"{list(node_nms)} x{lanes} @{sc.episodes} "
                f"(high_perf={high_perf}, seed={sc.seed})")
        gc = ex["gate_cfg"]
        if (bool(gc["surrogate_gate"]) != bool(sc.surrogate_gate)
                or int(gc["screen_k"]) != sc.screen_k
                or float(gc["gate_threshold"]) != sc.gate_threshold):
            raise ValueError(
                f"checkpoint in {checkpoint_dir} was written with gate "
                f"settings {gc}; got surrogate_gate={sc.surrogate_gate}, "
                f"screen_k={sc.screen_k}, gate_threshold="
                f"{sc.gate_threshold} — resuming with different gate "
                "settings would break bit-exact resume")
        if "device/gen" not in flat:
            raise ValueError(
                f"checkpoint in {checkpoint_dir} holds no torch generator "
                "state (written by the JAX package?); the port resumes "
                "only its own search checkpoints")
        unflat = lambda prefix, tmpl: ckpt_mod.unflatten_from(flat, prefix,
                                                              tmpl)
        sac_state = unflat("device/sac", sac_state)
        wm_state = unflat("device/wm", wm_state)
        surrogate.params = unflat("device/sur_params", surrogate.params)
        surrogate.opt_state = unflat("device/sur_opt", surrogate.opt_state)
        surrogate.resid_var = float(ex["sur_resid_var"])
        surrogate.n_updates = int(ex["sur_n_updates"])
        gen.set_state(torch.as_tensor(flat["device/gen"]))
        screen_gen.set_state(torch.as_tensor(flat["device/screen_gen"]))
        for name in PERBuffer.FIELDS:
            getattr(buf, name).copy_(to_dev(flat[f"host/per_{name}"]))
        buf.tree.copy_(to_dev(flat["host/per_tree"]))
        buf.pos, buf.size = int(ex["buf_pos"]), int(ex["buf_size"])
        buf.max_priority = float(ex["buf_max_priority"])
        buf.beta = float(ex["buf_beta"])
        buf.rng = _restore_np_rng(ex["buf_rng"])
        rng = _restore_np_rng(ex["rng"])
        env.rngs = [_restore_np_rng(st) for st in ex["env_rngs"]]
        env.cfg = to_dev(flat["host/env_cfg"])
        env.ranges = to_dev(flat["host/env_ranges"])
        s = flat["host/obs"]
        for k in range(int(ex["sur_len"])):
            sur_x.append(flat["host/sur_x"][k])
            sur_y.append(flat["host/sur_y"][k])
        archives = [ParetoArchive.from_dict(d) for d in ex["archives"]]
        traces = [[TracePoint(**tp) for tp in tr] for tr in ex["traces"]]
        for row, c in zip(flat["host/seen_keys"], flat["host/seen_cell"]):
            seen[int(c)].add(tuple(row.tolist()))
        for c in range(n_cells):
            if ex["best_has"][c]:
                best[c] = (float(ex["best_score"][c]),
                           flat["host/best_cfg"][c].copy(),
                           flat["host/best_metrics"][c].copy())
        feasible_count = np.asarray(ex["feasible_count"], np.int64)
        no_improve = int(ex["no_improve"])
        last_entropy = float(ex["last_entropy"])
        eps_sched.eps = float(ex["eps"])
        gate = sur_mod.ScreenGate.from_dict(ex["gate"])
        screen_rng = _restore_np_rng(ex["screen_rng"])
        mpc_dispatches = int(ex.get("mpc_dispatches", 0))
        start_t = int(manifest["step"])
        t_env = start_t * lanes
    else:
        if warm_start is not None:
            ws_flat = warm_start.get("flat")
            if ws_flat:
                sac_state = ckpt_mod.unflatten_from(ws_flat, "sac",
                                                    sac_state)
                surrogate.params = ckpt_mod.unflatten_from(
                    ws_flat, "sur_params", surrogate.params)
            for c, seed_cell in enumerate(warm_start.get("cells") or []):
                if c >= n_cells or not seed_cell:
                    continue
                archives[c].insert_batch(list(seed_cell.get("entries")
                                              or []))
                sb = seed_cell.get("best")
                if sb is not None:
                    best[c] = (float(sb[0]),
                               np.asarray(sb[1], np.float32).copy(),
                               np.asarray(sb[2], np.float32).copy())
        s = env.reset()      # (B, 52)

    # ---- telemetry: read-only taps on the loop's own state ---------------
    # Handles hoisted out of the hot loop.  Everything fed below is a host
    # value the loop already holds (clocks, numpy counters, python floats):
    # no RNG stream, no checkpoint content and no device synchronisation
    # of its own, so results are bitwise identical with telemetry on or
    # off, and the heartbeat thread that snapshots the registry never
    # touches a CUDA tensor.
    _reg = obs_metrics.global_registry()
    _m_steps = _reg.counter("env_steps_total")
    _m_screened = _reg.counter("screened_total")
    _m_evaluated = _reg.counter("evaluated_total")
    _m_sps = _reg.gauge("env_steps_per_s")
    _m_gate = _reg.gauge("gate_open_frac")
    _m_eps = _reg.gauge("search_eps")
    _m_ent = _reg.gauge("sac_entropy")
    _m_prio = _reg.gauge("per_max_priority")
    _m_size = _reg.gauge("per_size")
    _m_beta = _reg.gauge("per_beta")
    _m_best = _reg.gauge("best_score")
    _m_disp = _reg.histogram("dispatch_seconds")
    # screened/evaluated are cumulative in the gate (and survive resume):
    # counters track the delta per dispatch so fleet aggregation sums
    _prev_scr = float(gate.screened.sum())
    _prev_ev = float(gate.evaluated.sum())

    def _checkpoint(t_next: int) -> None:
        seen_keys = [k for c in range(n_cells) for k in seen[c]]
        seen_cell = [c for c in range(n_cells) for _ in seen[c]]
        xdim = SAC_STATE_DIM + act.N_CONT
        tree = dict(
            device=dict(sac=sac_state, wm=wm_state,
                        sur_params=surrogate.params,
                        sur_opt=surrogate.opt_state, gen=gen.get_state(),
                        screen_gen=screen_gen.get_state()),
            host=dict(
                **{f"per_{name}": getattr(buf, name)
                   for name in PERBuffer.FIELDS},
                per_tree=buf.tree, env_cfg=env.cfg, env_ranges=env.ranges,
                obs=np.asarray(s),
                sur_x=(np.stack(list(sur_x)) if sur_x
                       else np.zeros((0, b, xdim), np.float32)),
                sur_y=(np.stack(list(sur_y)) if sur_y
                       else np.zeros((0, b, 1), np.float32)),
                seen_keys=(np.asarray(seen_keys, np.float64)
                           if seen_keys else np.zeros((0, cs.DIM))),
                seen_cell=np.asarray(seen_cell, np.int64),
                best_cfg=np.stack([
                    best[c][1] if best[c][1] is not None
                    else np.zeros(cs.DIM, np.float32) for c in range(n_cells)]),
                best_metrics=np.stack([
                    best[c][2] if best[c][2] is not None
                    else np.zeros(M_DIM, np.float32)
                    for c in range(n_cells)]),
            ))
        extra = dict(
            node_nms=[int(n) for n in node_nms], lanes=lanes,
            episodes=sc.episodes, high_perf=high_perf, seed=sc.seed,
            eps=eps_sched.eps, rng=rng.bit_generator.state,
            buf_rng=buf.rng.bit_generator.state,
            env_rngs=[g.bit_generator.state for g in env.rngs],
            buf_pos=buf.pos, buf_size=buf.size,
            buf_max_priority=buf.max_priority, buf_beta=buf.beta,
            sur_resid_var=surrogate.resid_var,
            sur_n_updates=surrogate.n_updates, sur_len=len(sur_x),
            archives=[a.to_dict() for a in archives],
            traces=[[dataclasses.asdict(tp) for tp in tr] for tr in traces],
            best_has=[best[c][1] is not None for c in range(n_cells)],
            best_score=[float(best[c][0]) for c in range(n_cells)],
            feasible_count=feasible_count.tolist(), no_improve=no_improve,
            last_entropy=last_entropy, gate=gate.to_dict(),
            gate_cfg=dict(surrogate_gate=bool(sc.surrogate_gate),
                          screen_k=sc.screen_k,
                          gate_threshold=sc.gate_threshold),
            screen_rng=screen_rng.bit_generator.state,
            mpc_dispatches=mpc_dispatches)
        _save_search_ckpt(checkpoint_dir, t_next, tree, extra)

    t = start_t
    for t in range(start_t, n_steps):
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
                batch_d, idx = buf.sample(sc.batch_size)
                batch = sac_mod.Batch(**batch_d)
                sac_state, td_abs, met = sac_mod.update(sac_state, batch,
                                                        gen=gen)
                buf.update_priorities(idx, td_abs)
                last_entropy = float(met["entropy"])
            wmb = buf.recent(sc.wm_batch)
            wm_state, _ = wm_mod.train_step(wm_state, wmb["s"],
                                            wmb["a_cont"], wmb["s2"])
            if t % max(1, sc.surrogate_every // lanes) == 0 and len(sur_x):
                xs = np.concatenate(list(sur_x), axis=0)
                ys = np.concatenate(list(sur_y), axis=0)
                pick = rng.integers(0, len(xs), size=min(256, len(xs)))
                surrogate.update(xs[pick], ys[pick])
        _td = time.time() - _dt0
        dispatch_s.append(_td)
        # ---- telemetry feed: clocks + loop counters only -----------------
        _m_disp.observe(_td)
        _m_steps.inc(b)
        _m_sps.set(b / _td if _td > 0 else 0.0)
        _m_gate.set(float(np.mean(gate.open)))
        _m_eps.set(eps_sched.eps)
        _m_ent.set(last_entropy)
        _m_prio.set(float(buf.max_priority))
        _m_size.set(float(buf.size))
        _m_beta.set(float(buf.beta))
        _bb = min(best[c][0] for c in range(n_cells))
        if np.isfinite(_bb):
            _m_best.set(float(_bb))
        _scr, _ev = float(gate.screened.sum()), float(gate.evaluated.sum())
        _m_screened.inc(_scr - _prev_scr)
        _m_evaluated.inc(_ev - _prev_ev)
        _prev_scr, _prev_ev = _scr, _ev
        if t == start_t:
            # the first dispatch builds the kernels and warms the caches —
            # worth a span of its own on the timeline
            obs_trace.complete("first_dispatch", _dt0, _td, cat="search",
                               cells=n_cells, lanes=lanes)
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
            obs_trace.counter("search", env_steps_s=(b / _td if _td > 0
                                                     else 0.0),
                              eps=eps_sched.eps,
                              gate_open_frac=float(np.mean(gate.open)),
                              feasible=float(feasible_count.sum()))
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
        # checkpoint only live continuations (after the early-stop check:
        # a resumed run must never execute dispatches the original skipped)
        if checkpoint_dir and checkpoint_every > 0 \
                and (t + 1) % checkpoint_every == 0 and t + 1 < n_steps:
            with obs_trace.span("checkpoint", cat="search", step=t + 1):
                _checkpoint(t + 1)

    if save_weights_to:
        # final-weights snapshot for cross-campaign warm-starts; plain
        # ckpt_mod.save (not the _save_search_ckpt hook) and derived purely
        # from loop state, so a resumed finish re-writes identical bytes
        ckpt_mod.save(dict(sac=sac_state, sur_params=surrogate.params),
                      save_weights_to, max(1, t_env), keep=1,
                      extra=dict(kind="batch_weights",
                                 node_nms=[int(n) for n in node_nms],
                                 seed=sc.seed, high_perf=bool(high_perf)))

    # ---- final selection per cell: Pareto-scalarized (paper §3.10) -------
    results = []
    wall = time.time() - t0
    obs_trace.complete("run_search_cells", t0, wall, cat="search",
                       cells=n_cells, lanes=lanes, episodes=sc.episodes,
                       env_steps=t_env * n_cells)
    for c, node_nm in enumerate(node_nms):
        sel = archives[c].select(env.w_perf, env.w_power, env.w_area)
        best_cfg = sel.cfg if sel is not None else best[c][1]
        ttft = slo_ok = None
        # SLO-aware scenario selection: re-evaluate the cell's Pareto
        # archive under the paired prefill workload and pick the entry
        # minimising the combined objective (decode ppa_score + SLO hinge
        # penalties).  Strictly after the loop, so checkpoints and the
        # scenario=None path are untouched.
        if scenario is not None and archives[c].entries:
            ents = archives[c].entries
            with torch.no_grad():
                pre = _np(evaluate_batch(
                    cs.project(to_dev(np.stack([e.cfg for e in ents])
                                      .astype(np.float32))),
                    to_dev(np.asarray(scenario["aux_wl"].features,
                                      np.float32)),
                    env.node_mat[c * lanes]))
            slo = scenario["slo"]
            ttfts = [rwd.ttft_ms(pre[i, M_IDX["tok_s"]],
                                 scenario["seq_len"], scenario["batch"])
                     for i in range(len(ents))]
            objs = [rwd.slo_objective(e.ppa_score, e.tok_s, tt, slo)
                    for e, tt in zip(ents, ttfts)]
            pick = int(np.argmin(objs))
            best_cfg = ents[pick].cfg
            ttft = float(ttfts[pick])
            slo_ok = bool(
                (not slo.get("tok_s") or ents[pick].tok_s >= slo["tok_s"])
                and (not slo.get("ttft_ms") or ttft <= slo["ttft_ms"]))
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
            evaluated=int(gate.evaluated[c]), ttft_ms=ttft, slo_ok=slo_ok,
            dispatch_s=dispatch_s, mpc_dispatches=mpc_dispatches))
    return results


def run_search(workload: Workload, node_nm: int, *, high_perf: bool = True,
               search: Optional[SearchConfig] = None, n_envs: int = 64,
               devices: Optional[int] = None, device="cuda") -> SearchResult:
    """Algorithm 1 on the batched engine: ``n_envs`` parallel episodes per
    dispatch (the single-cell view of :func:`run_search_cells`), the env
    batch chunked over ``devices`` when given."""
    return run_search_cells(workload, [node_nm], high_perf=high_perf,
                            search=search, lanes_per_cell=n_envs,
                            devices=devices, device=device)[0]


def search_all_nodes(workload: Workload, nodes: Sequence[int], *,
                     high_perf: bool = True,
                     search: Optional[SearchConfig] = None,
                     n_envs: int = 64, device="cuda") -> Dict[int, SearchResult]:
    """Algorithm 1 outer loop on the batched engine (Eq. 50)."""
    return {n: run_search(workload, n, high_perf=high_perf, search=search,
                          n_envs=n_envs, device=device) for n in nodes}



# --------------------------------------------------------------------------
def run_random(workload: Workload, node_nm: int, *, high_perf: bool = True,
               episodes: int = 4613, seed: int = 0,
               device="cuda") -> SearchResult:
    """Random-search baseline (Table 21): the reference's numpy draws, each
    configuration evaluated on the run's device."""
    t0 = time.time()
    env = DSEEnv(workload, node_nm, high_perf=high_perf, seed=seed,
                 device=device)
    rng = np.random.default_rng(seed)
    archive = ParetoArchive()
    best = (np.inf, None, None)
    feas_count = 0
    seen = set()
    trace = []
    for t in range(episodes):
        cfg = cs.random_config(rng)
        m = env.evaluate_config(cfg)
        best, feas = _update_best(best, m, cfg, archive, t)
        feas_count += int(feas)
        seen.add(_cfg_key(cfg))
        if t % 50 == 0:
            trace.append(TracePoint(t, 0.0, float(best[0]), 1.0, 0.0,
                                    len(seen), feas_count,
                                    float(m[M_IDX["tok_s"]])))
    return SearchResult("random", node_nm, best[1], best[2], float(best[0]),
                        archive, trace, None, episodes, feas_count,
                        len(seen), time.time() - t0,
                        screened=episodes, evaluated=episodes)


def run_grid(workload: Workload, node_nm: int, *, high_perf: bool = True,
             episodes: int = 4613, seed: int = 0,
             device="cuda") -> SearchResult:
    """Grid-search baseline (Table 21): the reference's lattice over the
    dominant axes, in its order, each point evaluated on the run's
    device."""
    t0 = time.time()
    env = DSEEnv(workload, node_nm, high_perf=high_perf, seed=seed,
                 device=device)
    archive = ParetoArchive()
    best = (np.inf, None, None)
    feas_count = 0
    seen = set()
    trace = []
    # lattice sized to the episode budget
    meshes = np.unique(np.linspace(2, 64, 14).astype(int))
    vlens = np.array([256, 512, 1024, 1536, 2048])
    wmems = np.array([1024, 4096, 9800, 16384, 32768, 65536])
    freqs = np.array([0.25, 0.5, 1.0])
    t = 0
    for mw in meshes:
        for vl in vlens:
            for wm in wmems:
                for fq in freqs:
                    if t >= episodes:
                        break
                    cfg = cs.default_config()
                    cfg[cs.IDX["mesh_w"]] = mw
                    cfg[cs.IDX["mesh_h"]] = mw
                    cfg[cs.IDX["vlen"]] = vl
                    cfg[cs.IDX["wmem_kb"]] = wm
                    cfg[cs.IDX["freq_frac"]] = fq
                    m = env.evaluate_config(cfg)
                    best, feas = _update_best(best, m, cfg, archive, t)
                    feas_count += int(feas)
                    seen.add(_cfg_key(cfg))
                    if t % 50 == 0:
                        trace.append(TracePoint(
                            t, 0.0, float(best[0]), 0.0, 0.0, len(seen),
                            feas_count, float(m[M_IDX["tok_s"]])))
                    t += 1
    return SearchResult("grid", node_nm, best[1], best[2], float(best[0]),
                        archive, trace, None, t, feas_count, len(seen),
                        time.time() - t0, screened=t, evaluated=t)


def run_all_nodes(workload: Workload, nodes: Sequence[int], *,
                  high_perf: bool = True,
                  search: Optional[SearchConfig] = None,
                  device="cuda") -> Dict[int, SearchResult]:
    """Algorithm 1 outer loop: sequential per-node optimisation (Eq. 50)
    on the scalar engine."""
    return {n: run_sac(workload, n, high_perf=high_perf, search=search,
                       device=device) for n in nodes}
