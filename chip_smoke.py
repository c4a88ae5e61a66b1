#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the design-space search on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
  2. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` from source
     (``-Xptxas -v`` shows registers, shared memory and spills);
  3. parity on the card: each kernel against its plain PyTorch version at
     the main path's shapes and a ragged batch (rtol 1e-4, atol 1e-5), the
     actor also with heads, biases and gate set so that both log_std clips,
     the saturated tanh and a peaked gate are reached; the batched env step
     and the MPC rollouts on the card against the same on the CPU;
  4. timing: device time of each kernel and of its plain version (200
     calls replayed from a CUDA graph, between CUDA events), the eager call
     time with the host's work, and the least time the card could take;
  5. the main path: ``repro_torch.launch.dse.run`` on ``cuda`` (Llama 3.1 8B
     decode, seq 2048, batch 3, high-performance mode, node 3, 4,613
     episodes, 64 envs, seed 0, gate threshold ``GATE_THRESHOLD``) with the
     kernels' launch counts read around it; the chosen design is re-evaluated on the CPU by the plain
     evaluator; two short same-seed runs must be identical, and a gate that
     never opens must equal the ungated engine;
  6. one JSON line per kernel set, then the result line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
OUT = os.path.join(ROOT, "experiments", "dse", "chip_smoke")  # git-ignored
RTOL, ATOL = 1e-4, 1e-5          # kernel vs plain: fp32, other sum order
# H100 SXM published peaks (NVIDIA data sheet): fp32 without tensor cores,
# and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
EPISODES, N_ENVS, NODE, SEED = 4613, 64, 3, 0
# The default Eq.-67 threshold (0.05) never opens the screening gate in this
# cell, in the JAX reference as in the port (scripts/gate_check.py, both on
# the CPU).  The main path is driven with this threshold instead, large
# enough that the first calibration opens it, so that screen_score runs.
GATE_THRESHOLD = 1e3


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def _events_ms(run, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def call_ms(fn, n: int = 200, warm: int = 20) -> float:
    """Time of one eager call, host work included: CUDA events around
    ``n`` back-to-back calls (the rate a Python caller sees)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    return _events_ms(fn, n)


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so the host's launch
    and Python work drop out (200 calls in all)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, replays) / calls


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def actor_work(b: int, w_bytes: int) -> tuple:
    """FLOPs (2 per multiply-add) and bytes (each input read once, each
    output written once) of one ``actor_moe`` call on B rows."""
    s, h, e, no = 52, 256, 4, 80
    flops = b * (2 * s * e + e * 2 * (s * h + h * h + h * no) + 2 * e * no)
    return flops, w_bytes + b * s * 4 + b * (20 + 30 + 30 + 4) * 4


def screen_work(b: int, k: int, w_bytes: int) -> tuple:
    """The same for one ``screen_score`` call on B envs x K candidates."""
    flops = b * k * 2 * (82 * 128 + 128 * 64 + 64 * 3)
    return flops, w_bytes + (b * 52 + b * k * 30 + b * 3 + b * k) * 4


def main() -> None:
    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from the repo")
    sys.path.insert(0, SRC)
    from repro_torch import device as device_mod
    from repro_torch.configs import get_config
    from repro_torch.core import mpc, sac
    from repro_torch.core import world_model as wm
    from repro_torch.core.networks import to_device
    from repro_torch.core.env import VecDSEEnv
    from repro_torch.core.search import SearchConfig, run_search
    from repro_torch.kernels import actor_moe, build, ops, screen_score
    from repro_torch.launch import dse
    from repro_torch.optim.adam import tree_leaves
    from repro_torch.ppa import analytic as an
    from repro_torch.ppa import config_space as cs
    from repro_torch.ppa import surrogate as sur
    from repro_torch.ppa.nodes import node_params
    from repro_torch.workload.extract import extract

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = device_mod.resolve("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} device(s); TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.time()
    lib_path = build.build(verbose=True, force=True)
    log(f"built {os.path.relpath(lib_path, ROOT)} in {time.time() - t0:.1f} s")
    print(build.last_build_log, flush=True)
    build.library()

    # ---- 3. parity on the card -------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    actor = sac.create(SEED, dev).params.actor
    sur_params = sur.Surrogate.create(82, seed=SEED + 2, device=dev).params
    errs = {"actor_moe": 0.0, "screen_score": 0.0}
    names = ("disc", "mu", "log_std", "gate")
    # a fresh actor's heads (x1e-2) and gate (x0.01) keep every output near
    # 0.  "hot" scales the heads x5 and the gate x100 (one expert takes most
    # of the weight) and sets the head biases so that a third of the
    # log_std columns straddle each clip and a third of the mu columns sit
    # in the tanh's saturated tails.  Larger head weights would put the
    # outputs there too, but fp32 rounding grows with the summed terms and
    # would exceed the tolerance for any order of summation.
    hot = {k: ({"w": v["w"] * 5.0, "b": v["b"].clone()} if k in (
        "disc", "mu", "log_std") else v) for k, v in actor.items()}
    hot["gate"] = actor["gate"] * 100.0
    col = torch.arange(30, device=dev) % 3
    hot["log_std"]["b"][:, col == 0] = -20.0
    hot["log_std"]["b"][:, col == 2] = 2.0
    hot["mu"]["b"][:, col == 0] = -4.0
    hot["mu"]["b"][:, col == 2] = 4.0
    for label, params in (("init", actor), ("hot", hot)):
        for b in (33, 64, 192):
            s = torch.randn((b, 52), generator=gen, device=dev)
            got = actor_moe.actor_forward_cuda(params, s)
            torch.cuda.synchronize()
            with torch.no_grad():
                want = actor_moe.actor_forward_plain(params, s)
                # the plain version in fp64: how far fp32 rounding alone
                # moves the result
                exact = actor_moe.actor_forward_plain(
                    to_device(params, torch.float64), s.double())
            for name, g, w, x in zip(names, got, want, exact):
                err = float((g - w).abs().max())
                errs["actor_moe"] = max(errs["actor_moe"], err)
                log(f"parity actor_moe {label} B={b} {name}: max abs err "
                    f"{err:.3e} (plain fp32 vs fp64 "
                    f"{float((w.double() - x).abs().max()):.3e})")
                if not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
                    fail(f"actor_moe {label} B={b} {name} disagrees with "
                         f"the plain version (max abs err {err:.3e})")
            _, mu, log_std, gate = want
            shares = dict(
                log_std_at_min=float((log_std == -20.0).float().mean()),
                log_std_at_max=float((log_std == 2.0).float().mean()),
                tanh_saturated=float((mu.abs() > 0.999).float().mean()),
                gate_top=float(gate.max(-1).values.mean()))
            log(f"parity actor_moe {label} B={b} inputs: "
                + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()))
            if label == "hot" and min(shares["log_std_at_min"],
                                       shares["log_std_at_max"],
                                       shares["tanh_saturated"]) == 0.0:
                fail(f"actor_moe hot B={b}: the inputs miss a clip or "
                     "the tanh's saturated region")
    for b, k in ((33, 4), (64, 4)):
        s = torch.randn((b, 52), generator=gen, device=dev)
        cand = torch.rand((b, k, 30), generator=gen, device=dev) * 2 - 1
        w = torch.softmax(torch.randn((b, 3), generator=gen, device=dev), -1)
        got = screen_score.screen_scores_cuda(sur_params, s, cand, w)
        torch.cuda.synchronize()
        with torch.no_grad():
            want = screen_score.screen_scores_plain(sur_params, s, cand, w)
        err = float((got - want).abs().max())
        errs["screen_score"] = max(errs["screen_score"], err)
        log(f"parity screen_score B={b} K={k}: max abs err {err:.3e}")
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"screen_score B={b} K={k} disagrees with the plain version "
                 f"(max abs err {err:.3e})")
    # the batched env step on the card against the same step on the CPU
    wl = extract(get_config("llama3.1-8b"), seq_len=2048, batch=3)
    env_gpu = VecDSEEnv(wl, NODE, batch=N_ENVS, seed=SEED, device=dev)
    env_cpu = VecDSEEnv(wl, NODE, batch=N_ENVS, seed=SEED, device="cpu")
    o_g, o_c = env_gpu.reset(), env_cpu.reset()
    if not (torch.equal(env_gpu.cfg.cpu(), env_cpu.cfg)
            and np.allclose(o_g, o_c, rtol=1e-5, atol=1e-6)):
        fail("env reset on the card disagrees with the CPU")
    rng = np.random.default_rng(SEED)
    for step in range(5):
        a_c = rng.uniform(-1, 1, (N_ENVS, 30)).astype(np.float32)
        a_d = rng.integers(0, 5, (N_ENVS, 4)).astype(np.int32)
        s_g, r_g, i_g = env_gpu.step(a_c, a_d)
        s_c, r_c, i_c = env_cpu.step(a_c, a_d)
        keep = np.arange(an.M_DIM) != an.M_IDX["mem_overuse_mb"]
        ok = (np.array_equal(i_g.feasible, i_c.feasible)
              and np.allclose(s_g, s_c, rtol=1e-5, atol=1e-6)
              and np.allclose(r_g, r_c, rtol=1e-5, atol=1e-6)
              and np.allclose(i_g.metrics[:, keep], i_c.metrics[:, keep],
                              rtol=1e-5, atol=1e-6))
        if not ok:
            fail(f"env step {step} on the card disagrees with the CPU")
    log("parity env step: card == CPU over 5 steps (rtol 1e-5, atol 1e-6)")
    # MPC rollouts (plain ops) on the card against the CPU, same noise
    nets_cpu = [sac.create(SEED, "cpu").params.actor,
                wm.create(SEED + 1, "cpu").params,
                sur.Surrogate.create(82, seed=SEED + 2).params]
    g_cpu = torch.Generator().manual_seed(SEED)
    s_cpu = torch.randn((N_ENVS, 52), generator=g_cpu)
    noise = torch.randn((N_ENVS, mpc.K_CANDIDATES, 30), generator=g_cpu)
    a_cpu = mpc.plan(*nets_cpu, s_cpu, noise=noise)
    a_gpu = mpc.plan(*[to_device(t, dev) for t in nets_cpu], s_cpu.to(dev),
                     noise=noise.to(dev)).cpu()
    if not torch.allclose(a_gpu, a_cpu, rtol=RTOL, atol=ATOL):
        fail("mpc.plan on the card picks other candidates than on the CPU")
    log(f"parity mpc.plan: card == CPU for {N_ENVS} states x "
        f"{mpc.K_CANDIDATES} candidates")

    # ---- 4. timing --------------------------------------------------------
    timings = {}
    nbytes = lambda tree: sum(t.numel() * 4 for t in tree_leaves(tree))

    def timed(key, shape, kernel, plain, work):
        with torch.no_grad():
            ms, plain_ms = device_ms(kernel), device_ms(plain)
            call, plain_call = call_ms(kernel), call_ms(plain)
        bnd, by = bound_ms(*work)
        timings[key] = (ms, plain_ms, bnd, by, call)
        log(f"time {key[0]} {shape}: ms {ms:.5f} plain_ms {plain_ms:.5f} "
            f"bound_us {1e3 * bnd:.4f} bound_by {by} | eager call_ms "
            f"{call:.5f} plain_call_ms {plain_call:.5f}")

    for b in (64, 192):
        s = torch.randn((b, 52), generator=gen, device=dev)
        timed(("actor_moe", b), f"B={b}",
              lambda: actor_moe.actor_forward_cuda(actor, s),
              lambda: actor_moe.actor_forward_plain(actor, s),
              actor_work(b, nbytes(actor)))
    b, k = 64, 4
    s = torch.randn((b, 52), generator=gen, device=dev)
    cand = torch.rand((b, k, 30), generator=gen, device=dev) * 2 - 1
    w = torch.softmax(torch.randn((b, 3), generator=gen, device=dev), -1)
    timed(("screen_score", b), f"B={b} K={k}",
          lambda: screen_score.screen_scores_cuda(sur_params, s, cand, w),
          lambda: screen_score.screen_scores_plain(sur_params, s, cand, w),
          screen_work(b, k, nbytes(sur_params)))

    # ---- 5. the main path -------------------------------------------------
    results = []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.time()
    row, = dse.run("llama3.1-8b", nodes=[NODE], mode="high-performance",
                   episodes=EPISODES, method="sac", out_dir=OUT, seed=SEED,
                   seq_len=2048, batch=3, engine="vec", n_envs=N_ENVS,
                   gate_threshold=GATE_THRESHOLD, device="cuda",
                   results=results)
    torch.cuda.synchronize()
    wall, counts, res = time.time() - t, ops.launch_counts(), results[0]
    disp = np.asarray(res.dispatch_s)
    log(f"main path: llama3.1-8b decode, node {NODE} nm, {res.episodes_run} "
        f"env-steps in {len(disp)} dispatches of {N_ENVS} envs, "
        f"gate_threshold {GATE_THRESHOLD} (default "
        f"{sur.TAU_SUR_DEFAULT}), gate opened at env-step "
        f"{res.gate_open_episode}, screened {res.screened}, evaluated "
        f"{res.evaluated}, MPC dispatches {res.mpc_dispatches}")
    log(f"main path: wall {wall:.3f} s, loop {disp.sum():.3f} s, "
        f"env-steps/s {res.episodes_run / disp.sum():.1f} (loop) "
        f"{res.episodes_run / wall:.1f} (wall), median dispatch "
        f"{1e3 * float(np.median(disp)):.3f} ms, first dispatch "
        f"{1e3 * float(disp[0]):.3f} ms")
    log(f"main path result: mesh {row['mesh']} tok/s {row['tok_s']:.3f} "
        f"power {row['power_mw']:.3f} mW area {row['area_mm2']:.3f} mm2 "
        f"ppa_score {row['ppa_score']:.6f}")
    log(f"main path launches: {json.dumps(counts)}")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was never launched on the main path")
    if res.best_metrics is None or not np.isfinite(res.best_metrics).all():
        fail("the search returned no finite best design")
    with torch.no_grad():
        cpu_m = an.evaluate(
            cs.project(torch.as_tensor(np.asarray(res.best_cfg, np.float32))),
            torch.as_tensor(np.asarray(wl.features, np.float32)),
            torch.as_tensor(an.node_vector(node_params(NODE)))).numpy()
    keep = np.arange(an.M_DIM) != an.M_IDX["mem_overuse_mb"]
    if not np.allclose(res.best_metrics[keep], cpu_m[keep], rtol=1e-5,
                       atol=1e-6) or cpu_m[an.M_IDX["feasible"]] != 1.0:
        fail("the best design's card metrics disagree with the plain CPU "
             "evaluator")
    log("main path check: best design re-evaluated on the CPU agrees "
        "(rtol 1e-5) and is feasible")

    def short(**kw):
        sc = SearchConfig(episodes=10 * N_ENVS, seed=SEED, batch_size=64,
                          warmup=64, **kw)
        r = run_search(wl, NODE, search=sc, n_envs=N_ENVS, device="cuda")
        return json.dumps(dict(
            archive=[e.to_dict() for e in r.archive.entries],
            trace=[t.__dict__ for t in r.trace],
            best=None if r.best_cfg is None else r.best_cfg.tolist()))
    if short(gate_threshold=1e9) != short(gate_threshold=1e9):
        fail("two same-seed runs on the card differ")
    if short(gate_threshold=0.0) != short(surrogate_gate=False):
        fail("a never-open gate differs from the ungated engine on the card")
    log("determinism: same-seed runs identical; closed gate == ungated")

    # where a dispatch's time goes: torch.profiler over a short search with
    # learning on from the 5th dispatch and the gate open from the 6th
    from torch.profiler import ProfilerActivity, profile
    n_disp = 12
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        r = run_search(wl, NODE, search=SearchConfig(
            episodes=n_disp * N_ENVS, seed=SEED, gate_threshold=1e9),
            n_envs=N_ENVS, device="cuda")
        torch.cuda.synchronize()
        wall_p = time.time() - t
    dev_time = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, copies): the host ops that launched
    # them carry the same time again
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_time(e) > 0]
    busy_ms = sum(dev_time(e) for e in events) / 1e3
    log(f"profile: {n_disp} dispatches, wall {1e3 * wall_p:.3f} ms, loop "
        f"{1e3 * sum(r.dispatch_s):.3f} ms, device busy {busy_ms:.3f} ms, "
        f"idle share {1 - busy_ms / (1e3 * wall_p):.4f}, "
        f"{sum(e.count for e in events)} device ops")
    for e in sorted(events, key=dev_time, reverse=True)[:12]:
        log(f"profile:   {dev_time(e) / 1e3:10.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")
    host = [e for e in prof.key_averages()
            if not str(e.device_type).endswith("CUDA")]
    log(f"profile: host ops by self CPU time (of "
        f"{sum(e.self_cpu_time_total for e in host) / 1e3:.3f} ms):")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        log(f"profile:   {e.self_cpu_time_total / 1e3:10.3f} ms  "
            f"x{e.count:<6d} {e.key[:90]}")

    # ---- 6. results -------------------------------------------------------
    src = "src/repro_torch/kernels/csrc/"
    kernels = []
    for name, route_src, replaces, shape in (
            ("actor_moe", src + "actor_moe.cu",
             "src/repro/kernels/actor_moe.py:75", "B=64"),
            ("screen_score", src + "screen_score.cu",
             "src/repro/kernels/screen_score.py:66", "B=64,K=4")):
        ms, plain, bnd, by, call = timings[(name, 64)]
        kernels.append(dict(
            name=name, route="cuda", source=route_src, replaces=replaces,
            shape=shape, launches=counts[name], max_abs_err=errs[name],
            ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
            library_ms=None, call_ms=call))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
