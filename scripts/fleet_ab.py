#!/usr/bin/env python3
"""Time the paper's campaign grid as one process and as fleets on one card.

Each run is a fresh command, ``python -m repro_torch.launch.dse --campaign
<grid> --device cuda [--workers W]``, on ``chip_smoke.py``'s phase-6 grid
(Llama 3.1 8B and SmolVLM, both modes, nodes 3-28 nm: 28 cells in 4
batches of 7 x 64 lanes, 4,613 episodes a cell, seed 0) into a fresh
campaign root under the git-ignored ``experiments/campaigns/fleet_ab/``.
A run is ``W`` (worker count; 1 runs the plain single-process campaign) or
``W:T``, which sets ``OMP_NUM_THREADS=T`` in the command's environment (the
workers inherit it, and torch takes its intra-op thread count from it).
The kernels are built first, so no run includes ``nvcc``.  For each run
it prints one JSON line: the command's wall time, ``nvidia-smi``'s mean
``utilization.gpu`` over the run (500 ms samples), and for fleets each
worker's start-up, batches and busy share from the traces
(``scripts/fleet_timeline.py``); a run whose fingerprint differs from the
first run's fails the script.

    python3 scripts/fleet_ab.py --runs 1 2 2:4 2:4 2 1
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="+", default=["1", "2", "2", "1"])
    ap.add_argument("--episodes", type=int, default=None,
                    help="cut the grid's per-cell budget (rehearsals)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    import chip_smoke
    from fleet_timeline import timeline
    from repro_torch.campaign import CampaignStore, fingerprint
    from repro_torch.launch.fleet import prepare_device

    prepare_device(a.device)             # build the kernels once
    base = os.path.join(ROOT, "experiments", "campaigns", "fleet_ab")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    grid = dict(chip_smoke.GRID)
    if a.episodes:
        grid["episodes"] = a.episodes
    grid_path = os.path.join(base, "grid.json")
    with open(grid_path, "w") as f:
        json.dump(grid, f)
    try:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    except OSError:
        print("no nvidia-smi", flush=True)
    first = None
    for i, run in enumerate(a.runs):
        workers, _, threads = run.partition(":")
        env = dict(os.environ, PYTHONPATH=SRC)
        if threads:
            env["OMP_NUM_THREADS"] = threads
        root = os.path.join(base, f"run{i}")
        cmd = [sys.executable, "-m", "repro_torch.launch.dse", "--campaign",
               grid_path, "--campaign-root", root, "--device", a.device]
        if int(workers) > 1:
            cmd += ["--workers", workers]
        with chip_smoke.UtilSampler() as util:
            t = time.time()
            out = subprocess.run(cmd, env=env, capture_output=True,
                                 text=True, timeout=1800)
            wall = time.time() - t
        if out.returncode != 0:
            sys.exit(f"run {run} failed:\n{out.stdout[-2000:]}"
                     f"{out.stderr[-2000:]}")
        run_root = os.path.join(root, grid["name"])
        fp = fingerprint(CampaignStore.open(run_root))
        if first is None:
            first = fp
        elif fp != first:
            sys.exit(f"run {run}: the fingerprint differs from run "
                     f"{a.runs[0]}'s")
        line = dict(run=run, workers=int(workers), threads=threads or None,
                    wall_s=wall, util_mean=util.mean,
                    util_samples=len(util.samples))
        if int(workers) > 1:
            tl = timeline(run_root)
            line.update(fleet_wall_s=tl["wall_s"], workers_timeline={
                k: dict(first_record_s=w["first_record_s"],
                        last_record_s=w["last_record_s"],
                        batches=[(b["start_s"], b["dur_s"])
                                 for b in w["batches"]],
                        busy_share=w["busy_share"])
                for k, w in tl["workers"].items()},
                parent=[(r["name"], r["start_s"], r["dur_s"])
                        for r in tl["parent"]])
        print(json.dumps(line), flush=True)
    print(json.dumps(dict(fingerprints_equal=True, runs=a.runs)))


if __name__ == "__main__":
    main()
