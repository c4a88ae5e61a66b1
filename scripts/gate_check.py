#!/usr/bin/env python3
"""Does the default Eq.-67 screening gate open in the Llama 3.1 8B cell?

Runs the same single-cell search (Llama 3.1 8B decode, seq 2048, batch 3,
high-performance mode, node 3, 4,613 episodes, 64 envs, seed 0, default
gate threshold) through the JAX reference and through the PyTorch port,
both on the CPU, and prints one JSON line per package with the episode at
which the gate opened (null: never), the screened / evaluated counters,
the best score and the wall time.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/gate_check.py

``chip_smoke.py`` drives this cell with an explicit threshold because of
what this script shows.  Needs both packages, so it does not run on a
machine without JAX.
"""
from __future__ import annotations

import argparse
import json
import time

EPISODES, N_ENVS, NODE, SEED = 4613, 64, 3, 0


def _row(package, res, wall, threshold):
    return dict(package=package, gate_threshold=threshold,
                gate_open_episode=res.gate_open_episode,
                screened=res.screened, evaluated=res.evaluated,
                episodes_run=res.episodes_run,
                best_score=float(res.best_score), wall_s=wall)


def reference(episodes: int) -> dict:
    from repro.configs import get_config
    from repro.core.search import SearchConfig, run_search
    from repro.ppa.surrogate import TAU_SUR_DEFAULT
    from repro.workload.extract import extract
    wl = extract(get_config("llama3.1-8b"), seq_len=2048, batch=3)
    t = time.time()
    res = run_search(wl, NODE, high_perf=True, n_envs=N_ENVS,
                     search=SearchConfig(episodes=episodes, seed=SEED))
    return _row("repro", res, time.time() - t, TAU_SUR_DEFAULT)


def port(episodes: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.search import SearchConfig, run_search
    from repro_torch.ppa.surrogate import TAU_SUR_DEFAULT
    from repro_torch.workload.extract import extract
    wl = extract(get_config("llama3.1-8b"), seq_len=2048, batch=3)
    t = time.time()
    res = run_search(wl, NODE, high_perf=True, n_envs=N_ENVS, device="cpu",
                     search=SearchConfig(episodes=episodes, seed=SEED))
    return _row("repro_torch", res, time.time() - t, TAU_SUR_DEFAULT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--episodes", type=int, default=EPISODES)
    a = ap.parse_args()
    for run in (reference, port):
        print(json.dumps(run(a.episodes)), flush=True)


if __name__ == "__main__":
    main()
