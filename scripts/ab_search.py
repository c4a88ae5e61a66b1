#!/usr/bin/env python3
"""Time the port's single-cell search in two source trees on one card.

Each tree is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory, and the working
tree).  Every run is a fresh process that imports ``repro_torch`` from that
tree and calls ``repro_torch.launch.dse.run`` on ``cuda`` for the Llama 3.1
8B decode cell (seq 2048, batch 3, high-performance mode, node 3, 4,613
episodes, 64 envs, seed 0, gate threshold 1e3, as ``chip_smoke.py`` phase
5 drives it).  The kernels of both trees are built first, so no timed run
includes ``nvcc``.  Runs go in the order given (default P C C P P C C P),
one JSON line each: the search's wall time and loop time, the median
dispatch, the kernels' launch counts and the result row.

With ``--profile N`` each tree instead runs one search of N dispatches
under ``torch.profiler`` (after an unprofiled warm-up search), with the
replay buffer's methods, the SAC and world-model updates, the policy's
acting and the env step labelled, and prints per tree the wall time, the
device's busy time and op count, the device time and launches of each of
the port's search kernels, each label's host time and calls, and the host
ops with the most self time.

    python3 scripts/ab_search.py --trees experiments/parent . \\
        --out chiprun_out/ab [--profile 24]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.kernels import build, ops
from repro_torch.launch import dse
if sys.argv[3] == "build":
    build.library()
    print(json.dumps({"built": build.build().name}))
    raise SystemExit
if sys.argv[3] == "profile":
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.configs import get_config
    from repro_torch.core import env as env_mod, replay, sac
    from repro_torch.core import world_model as wm
    from repro_torch.core.search import SearchConfig, run_search
    from repro_torch.workload.extract import extract

    tags = set()
    PORT_KERNELS = ("sumtree_set_many", "sumtree_sample", "actor_",
                    "screen_scores", "fused_mlp")

    def label(owner, name, tag):
        tags.add(tag)
        fn = getattr(owner, name)
        def wrapped(*a, **k):
            with record_function(tag):
                return fn(*a, **k)
        setattr(owner, name, wrapped)

    for name in ("add_batch", "sample", "update_priorities", "recent"):
        label(replay.PERBuffer, name, "PER." + name)
    label(sac, "update", "sac.update")
    label(sac, "policy_act_batch", "sac.policy_act_batch")
    label(wm, "train_step", "wm.train_step")
    label(env_mod.VecDSEEnv, "step", "env.step")
    wl = extract(get_config("llama3.1-8b"), seq_len=2048, batch=3)
    n = int(sys.argv[4])
    run = lambda: run_search(wl, 3, n_envs=64, device="cuda", search=SearchConfig(
        episodes=n * 64, seed=0, gate_threshold=1e3))
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    ev = prof.key_averages()
    # a label's span shows on the device's timeline too: not device work
    on_dev = [e for e in ev if str(e.device_type).endswith("CUDA")
              and dev_t(e) > 0 and e.key not in tags]
    host = [e for e in ev if not str(e.device_type).endswith("CUDA")]
    # the port's search kernels: device ms and launches over the N
    # dispatches, the instantiations of one kernel summed
    port = {}
    for e in on_dev:
        name = next((w for w in PORT_KERNELS if w in e.key), None)
        if name is not None:
            acc = port.setdefault(name, [0.0, 0])
            acc[0] += dev_t(e) / 1e3
            acc[1] += e.count
    print(json.dumps(dict(
        wall_ms=1e3 * wall, loop_ms=1e3 * sum(r.dispatch_s),
        device_busy_ms=sum(dev_t(e) for e in on_dev) / 1e3,
        device_ops=sum(e.count for e in on_dev), port_kernels=port,
        labels={e.key: [e.cpu_time_total / 1e3, e.count] for e in host
                if e.key in tags},
        top_host={e.key: [e.self_cpu_time_total / 1e3, e.count] for e in
                  sorted(host, key=lambda e: e.self_cpu_time_total,
                         reverse=True)[:15]})))
    raise SystemExit
results = []
ops.reset_launch_counts()
torch.cuda.synchronize()
t = time.perf_counter()
row, = dse.run("llama3.1-8b", nodes=[3], mode="high-performance",
               episodes=4613, method="sac", out_dir=sys.argv[2], seed=0,
               seq_len=2048, batch=3, engine="vec", n_envs=64,
               gate_threshold=1e3, device="cuda", results=results)
torch.cuda.synchronize()
wall = time.perf_counter() - t
disp = np.asarray(results[0].dispatch_s)
print(json.dumps(dict(wall_s=wall, loop_s=float(disp.sum()),
                      median_dispatch_ms=1e3 * float(np.median(disp)),
                      dispatches=len(disp), launches=ops.launch_counts(),
                      mesh=row["mesh"], ppa_score=row["ppa_score"])))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, required=True, metavar=("P", "C"))
    ap.add_argument("--order", default="PCCPPCCP")
    ap.add_argument("--out", default="chiprun_out/ab")
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    a = ap.parse_args()
    trees = dict(zip("PC", (os.path.abspath(t) for t in a.trees)))
    os.makedirs(a.out, exist_ok=True)

    def call(label, mode):
        out = subprocess.run(
            [sys.executable, "-c", RUN, trees[label],
             os.path.join(a.out, label), mode, str(a.profile)],
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            sys.exit(f"{label} {mode} failed:\n{out.stderr[-4000:]}")
        return json.loads(out.stdout.strip().splitlines()[-1])

    for label in "PC":
        print(json.dumps(dict(tree=label, **call(label, "build"))),
              flush=True)
    if a.profile:
        for label in "PC":
            print(json.dumps(dict(tree=label, **call(label, "profile"))),
                  flush=True)
        return
    for i, label in enumerate(a.order):
        print(json.dumps(dict(run=i, tree=label, **call(label, "time"))),
              flush=True)


if __name__ == "__main__":
    main()
