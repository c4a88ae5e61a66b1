"""DSE entry point — Algorithm 1 on the batched engine as a CLI (port of
``repro.launch.dse`` for ``--method sac --engine vec``).

    python -m repro_torch.launch.dse --arch llama3.1-8b --nodes 3 \\
        --episodes 4613 --engine vec --n-envs 64 --device cuda --out DIR

Writes the reference's four artifacts per run under ``--out``:
``<arch>__<node>nm__sac_tcc.json`` (per-TCC derivation),
``..._trace.json`` (convergence trace), ``..._pareto.json`` (frontier) and
``<arch>__sac_summary.json`` (one result row per node).  Campaigns, fleets,
the scalar engine, the random/grid baselines and ``--devices`` are not
ported yet and are refused.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.search import SearchConfig, SearchResult, run_search
from repro_torch.ppa.nodes import NODES
from repro_torch.workload.extract import DTYPES, PHASES, extract


def result_row(res: SearchResult) -> Dict:
    m = lambda n: res.metric(n)
    return dict(
        node_nm=res.node_nm, method=res.method,
        mesh=f"{int(np.round(res.best_cfg[0]))}x{int(np.round(res.best_cfg[1]))}"
        if res.best_cfg is not None else "-",
        cores=float(m("n_cores")), power_mw=float(m("power_mw")),
        perf_gops=float(m("perf_gops")), area_mm2=float(m("area_mm2")),
        tok_s=float(m("tok_s")), ppa_score=float(m("ppa_score")),
        freq_mhz=float(m("f_hz")) / 1e6,
        episodes=res.episodes_run, feasible=res.feasible_count,
        unique=res.unique_configs, wall_s=round(res.wall_s, 1),
        p_compute_mw=float(m("p_compute_mw")), p_sram_mw=float(m("p_sram_mw")),
        p_rom_mw=float(m("p_rom_mw")), p_noc_mw=float(m("p_noc_mw")),
        p_leak_mw=float(m("p_leak_mw")),
    )


def run(arch: str, *, nodes: List[int], mode: str, episodes: int,
        method: str = "sac", out_dir: str, seed: int = 0, seq_len: int = 2048,
        batch: int = 3, verbose: bool = False,
        engine: str = "vec", n_envs: int = 64,
        surrogate_gate: bool = True, screen_k: Optional[int] = None,
        gate_threshold: Optional[float] = None, phase: str = "decode",
        dtype: str = "native", device="cuda",
        results: Optional[List[SearchResult]] = None) -> List[Dict]:
    """Run the search per node and write the artifacts; returns the rows.
    ``results``, when given, collects each node's :class:`SearchResult`."""
    if method != "sac" or engine != "vec":
        raise NotImplementedError(
            f"--method {method} --engine {engine}: only --method sac "
            "--engine vec is ported")
    cfg = get_config(arch)
    high_perf = mode == "high-performance"
    wl = extract(cfg, seq_len=seq_len, batch=batch, phase=phase, dtype=dtype)
    os.makedirs(out_dir, exist_ok=True)
    gate_kw = dict(surrogate_gate=surrogate_gate)
    if screen_k is not None:
        gate_kw["screen_k"] = screen_k
    if gate_threshold is not None:
        gate_kw["gate_threshold"] = gate_threshold
    rows = []
    for node in nodes:
        sc = SearchConfig(episodes=episodes, seed=seed, verbose=verbose,
                          **gate_kw)
        res = run_search(wl, node, high_perf=high_perf, search=sc,
                         n_envs=n_envs, device=device)
        if results is not None:
            results.append(res)
        row = result_row(res)
        rows.append(row)
        print(f"[dse] {arch} {node}nm [{method}]: mesh {row['mesh']} "
              f"tok/s {row['tok_s']:.1f} power {row['power_mw']:.1f} mW "
              f"area {row['area_mm2']:.0f} mm2 score {row['ppa_score']:.3f} "
              f"({row['wall_s']}s)")
        tag = f"{arch}__{node}nm__{method}"
        if res.hetero is not None:
            res.hetero.to_json(os.path.join(out_dir, tag + "_tcc.json"))
        with open(os.path.join(out_dir, tag + "_trace.json"), "w") as f:
            json.dump([t.__dict__ for t in res.trace], f)
        fr = res.archive.frontier()
        with open(os.path.join(out_dir, tag + "_pareto.json"), "w") as f:
            json.dump({k: v.tolist() for k, v in fr.items()}, f)
    with open(os.path.join(out_dir, f"{arch}__{method}_summary.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.1-8b")
    ap.add_argument("--mode", default="high-performance",
                    choices=["high-performance", "low-power"])
    ap.add_argument("--nodes", default="all",
                    help="comma list of nm values or 'all'")
    ap.add_argument("--episodes", type=int, default=4613)
    ap.add_argument("--method", default="sac",
                    choices=["sac", "random", "grid"])
    ap.add_argument("--out", default="experiments/dse")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--phase", default="decode", choices=list(PHASES))
    ap.add_argument("--dtype", default="native", choices=list(DTYPES))
    ap.add_argument("--update-every", type=int, default=1,
                    help="scalar engine only; the vec engine takes 1")
    ap.add_argument("--engine", default="vec", choices=["scalar", "vec"])
    ap.add_argument("--n-envs", type=int, default=64)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--screen-k", type=int, default=None)
    ap.add_argument("--gate-threshold", type=float, default=None)
    ap.add_argument("--no-surrogate-gate", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run: cuda (default) or cpu")
    ap.add_argument("--verbose", action="store_true")
    a = ap.parse_args(argv)
    if a.method != "sac" or a.engine != "vec":
        ap.error(f"--method {a.method} --engine {a.engine}: only --method "
                 "sac --engine vec is ported to repro_torch")
    if a.update_every != 1:
        ap.error("--update-every: the vec engine updates per dispatch "
                 "(SearchConfig.updates_per_dispatch); only 1 is accepted")
    if a.devices is not None:
        ap.error("--devices: sharding over several cards is not ported")
    if a.n_envs < 1:
        ap.error(f"--n-envs must be >= 1 (got {a.n_envs})")
    if a.screen_k is not None and a.screen_k < 1:
        ap.error(f"--screen-k must be >= 1 (got {a.screen_k})")
    if a.gate_threshold is not None and a.gate_threshold < 0:
        ap.error(f"--gate-threshold must be >= 0 (got {a.gate_threshold})")
    nodes = list(NODES) if a.nodes == "all" else [
        int(x) for x in a.nodes.split(",")]
    run(a.arch, nodes=nodes, mode=a.mode, episodes=a.episodes,
        method=a.method, out_dir=a.out, seed=a.seed, seq_len=a.seq_len,
        batch=a.batch, verbose=a.verbose,
        engine=a.engine, n_envs=a.n_envs,
        surrogate_gate=not a.no_surrogate_gate, screen_k=a.screen_k,
        gate_threshold=a.gate_threshold, phase=a.phase, dtype=a.dtype,
        device=a.device)


if __name__ == "__main__":
    main()
