#!/usr/bin/env python3
"""Does the default Eq.-67 screening gate open in one cell, and does the
search find a feasible design there?

Runs the same single-cell search (by default Llama 3.1 8B decode, seq
2048, batch 3, high-performance mode, node 3, 4,613 episodes, 64 envs,
seed 0, default gate threshold) through the JAX reference and through the
PyTorch port, both on the CPU, and prints one JSON line per package with
the episode at which the gate opened (null: never), the screened /
evaluated counters, the number of feasible designs seen, the best score
(Infinity: none feasible) and the wall time.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/gate_check.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/gate_check.py \
        --arch smolvlm --mode low_power --node 3

``chip_smoke.py`` drives the default cell with an explicit threshold
because of what this script shows.  Needs both packages, so it does not
run on a machine without JAX.
"""
from __future__ import annotations

import argparse
import json
import time

EPISODES, N_ENVS, NODE, SEED = 4613, 64, 3, 0


def _row(package, res, wall, threshold, a):
    return dict(package=package, arch=a.arch, mode=a.mode, node=a.node,
                gate_threshold=threshold,
                gate_open_episode=res.gate_open_episode,
                screened=res.screened, evaluated=res.evaluated,
                episodes_run=res.episodes_run,
                feasible_count=res.feasible_count,
                best_score=float(res.best_score), wall_s=wall)


def reference(a) -> dict:
    from repro.configs import get_config
    from repro.core.search import SearchConfig, run_search
    from repro.ppa.surrogate import TAU_SUR_DEFAULT
    from repro.workload.extract import extract
    wl = extract(get_config(a.arch), seq_len=2048, batch=3)
    t = time.time()
    res = run_search(wl, a.node, high_perf=a.mode == "high_perf",
                     n_envs=N_ENVS,
                     search=SearchConfig(episodes=a.episodes, seed=SEED))
    return _row("repro", res, time.time() - t, TAU_SUR_DEFAULT, a)


def port(a) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.search import SearchConfig, run_search
    from repro_torch.ppa.surrogate import TAU_SUR_DEFAULT
    from repro_torch.workload.extract import extract
    wl = extract(get_config(a.arch), seq_len=2048, batch=3)
    t = time.time()
    res = run_search(wl, a.node, high_perf=a.mode == "high_perf",
                     n_envs=N_ENVS, device="cpu",
                     search=SearchConfig(episodes=a.episodes, seed=SEED))
    return _row("repro_torch", res, time.time() - t, TAU_SUR_DEFAULT, a)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.1-8b",
                    choices=["llama3.1-8b", "smolvlm"])
    ap.add_argument("--mode", default="high_perf",
                    choices=["high_perf", "low_power"])
    ap.add_argument("--node", type=int, default=NODE)
    ap.add_argument("--episodes", type=int, default=EPISODES)
    a = ap.parse_args()
    for run in (reference, port):
        print(json.dumps(run(a)), flush=True)


if __name__ == "__main__":
    main()
