"""DSE entry point — Algorithm 1 and the Table-21 baselines as a CLI (port
of ``repro.launch.dse``).

    python -m repro_torch.launch.dse --arch llama3.1-8b --nodes 3 \\
        --episodes 4613 --engine vec --n-envs 64 --device cuda --out DIR
    python -m repro_torch.launch.dse --arch llama3.1-8b --nodes 3 \\
        --episodes 1024 --engine scalar [--update-every N] --device cuda
    python -m repro_torch.launch.dse --arch llama3.1-8b --nodes 3 \\
        --method random|grid --episodes 4613 --device cuda

``--method sac`` runs on the batched engine (``--engine vec``, the default
here) or on the scalar one (``--engine scalar``: one environment a step);
``--method random`` and ``grid`` are the baselines, on the scalar
evaluator.

Writes the reference's four artifacts per run under ``--out``:
``<arch>__<node>nm__sac_tcc.json`` (per-TCC derivation),
``..._trace.json`` (convergence trace), ``..._pareto.json`` (frontier) and
``<arch>__sac_summary.json`` (one result row per node).

Campaigns (``repro_torch.campaign``) run a whole grid (with scenario axes
``dtypes``/``phases`` and SLO-aware selection, ``slo``) and resume a
killed one bit-for-bit:

    python -m repro_torch.launch.dse --campaign grid.json --device cuda \
        [--campaign-root experiments/campaigns]
    python -m repro_torch.launch.dse --resume experiments/campaigns/<name>

Fleets (``--workers`` and its flags), ``--transfer-from`` and
``--devices``/``--mesh`` are not ported yet and are refused.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.search import (SearchConfig, SearchResult, run_grid,
                                     run_random, run_sac, run_search)
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
        batch: int = 3, update_every: int = 1, verbose: bool = False,
        engine: str = "vec", n_envs: int = 64,
        surrogate_gate: bool = True, screen_k: Optional[int] = None,
        gate_threshold: Optional[float] = None, phase: str = "decode",
        dtype: str = "native", device="cuda",
        results: Optional[List[SearchResult]] = None) -> List[Dict]:
    """Run the search per node and write the artifacts; returns the rows.
    ``results``, when given, collects each node's :class:`SearchResult`."""
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
        if method == "sac":
            sc = SearchConfig(episodes=episodes, seed=seed,
                              update_every=update_every, verbose=verbose,
                              **gate_kw)
            if engine == "vec":
                res = run_search(wl, node, high_perf=high_perf, search=sc,
                                 n_envs=n_envs, device=device)
            else:
                res = run_sac(wl, node, high_perf=high_perf, search=sc,
                              device=device)
        elif method == "random":
            res = run_random(wl, node, high_perf=high_perf,
                             episodes=episodes, seed=seed, device=device)
        else:
            res = run_grid(wl, node, high_perf=high_perf,
                           episodes=episodes, seed=seed, device=device)
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


_NOT_PORTED = (
    ("--devices", "devices", "sharding over several cards"),
    ("--mesh", "mesh", "sharding over several cards"),
    ("--transfer-from", "transfer_from", "cross-campaign transfer"),
    ("--workers", "workers", "fleets"),
    ("--hosts", "hosts", "fleets"),
    ("--launch-template", "launch_template", "fleets"),
    ("--lease-ttl", "lease_ttl", "fleets"),
    ("--no-supervise", "no_supervise", "fleets"),
)


def validate_args(ap: argparse.ArgumentParser,
                  a: argparse.Namespace) -> None:
    """Reject invalid or not-yet-ported flag combinations up front with a
    one-line error (the reference's checks, for what is ported)."""
    for flag, attr, part in _NOT_PORTED:
        if getattr(a, attr) not in (None, False):
            ap.error(f"{flag}: not ported to repro_torch yet ({part})")
    if a.n_envs < 1:
        ap.error(f"--n-envs must be >= 1 (got {a.n_envs})")
    if a.engine == "scalar" and a.n_envs != ap.get_default("n_envs"):
        ap.error(f"--n-envs {a.n_envs} only applies to --engine vec; the "
                 "scalar engine steps one environment (drop --n-envs or "
                 "pass --engine vec)")
    if a.engine == "vec" and a.method != "sac":
        ap.error(f"--engine vec only drives the SAC search loop; "
                 f"--method {a.method} runs on the scalar evaluator "
                 "(drop --engine vec)")
    if a.update_every < 1:
        ap.error(f"--update-every must be >= 1 (got {a.update_every})")
    if a.update_every != 1 and (a.engine != "scalar" or a.method != "sac"):
        ap.error("--update-every applies to --method sac --engine scalar; "
                 "the vec engine updates per dispatch "
                 "(SearchConfig.updates_per_dispatch)")
    if a.screen_k is not None and a.screen_k < 1:
        ap.error(f"--screen-k must be >= 1 (got {a.screen_k})")
    if a.gate_threshold is not None and a.gate_threshold < 0:
        ap.error(f"--gate-threshold must be >= 0 (got {a.gate_threshold})")
    gate_flags = [n for n, v in (("--screen-k", a.screen_k),
                                 ("--gate-threshold", a.gate_threshold))
                  if v is not None]
    if a.no_surrogate_gate:
        gate_flags.append("--no-surrogate-gate")
    if gate_flags and a.resume:
        ap.error(f"{'/'.join(gate_flags)}: a resumed campaign keeps the "
                 "gate settings recorded in its manifest; start a new "
                 "campaign to change them")
    if gate_flags and not a.campaign and a.engine != "vec":
        ap.error(f"{'/'.join(gate_flags)} applies to --engine vec or "
                 "--campaign runs; the scalar engine has no surrogate "
                 "screening gate")
    scen_flags = [n for n, v, d in (("--phase", a.phase, "decode"),
                                    ("--dtype", a.dtype, "native"))
                  if v != d]
    if scen_flags and (a.campaign or a.resume):
        ap.error(f"{'/'.join(scen_flags)} select the single-search "
                 "scenario; campaign grids sweep these as 'phases'/"
                 "'dtypes' axes in the spec file")
    if a.campaign and a.resume:
        ap.error("--campaign starts a new run and --resume continues an "
                 "existing one; pass exactly one")
    if a.campaign and not os.path.isfile(a.campaign):
        ap.error(f"--campaign grid file not found: {a.campaign}")
    if a.resume and not os.path.isfile(os.path.join(a.resume,
                                                    "manifest.json")):
        ap.error(f"--resume: no campaign manifest under {a.resume}")


def run_campaign_cli(ap: argparse.ArgumentParser,
                     a: argparse.Namespace) -> None:
    """``--campaign`` / ``--resume``: plan, run, persist and report."""
    import dataclasses

    from repro_torch.campaign import CampaignSpec, CampaignStore, run_campaign
    if a.resume:
        store = CampaignStore.open(a.resume)
        if store.manifest.get("fleet"):
            ap.error(f"--resume {a.resume}: a fleet campaign; fleets are "
                     "not ported to repro_torch yet")
        try:
            store.spec          # a spec the port refuses raises here
        except (ValueError, TypeError) as e:
            ap.error(f"--resume {a.resume}: {e}")
        run_campaign(a.resume, resume=True, device=a.device)
        return
    try:
        spec = CampaignSpec.from_file(a.campaign)
    except (ValueError, TypeError, RuntimeError, OSError) as e:
        ap.error(f"--campaign {a.campaign}: {e}")
    overrides = {}
    if a.screen_k is not None:
        overrides["screen_k"] = a.screen_k
    if a.gate_threshold is not None:
        overrides["gate_threshold"] = a.gate_threshold
    if a.no_surrogate_gate:
        overrides["surrogate_gate"] = False
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    run_campaign(os.path.join(a.campaign_root, spec.name), spec,
                 device=a.device)


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
    ap.add_argument("--phase", default="decode", choices=list(PHASES),
                    help="inference phase to extract the workload for "
                         "(campaign grids take a 'phases' list in the spec "
                         "instead)")
    ap.add_argument("--dtype", default="native", choices=list(DTYPES),
                    help="datapath dtype override (campaign grids take a "
                         "'dtypes' list in the spec instead)")
    ap.add_argument("--update-every", type=int, default=1,
                    help="scalar engine: env-steps between SAC updates")
    ap.add_argument("--engine", default=None, choices=["scalar", "vec"],
                    help="vec (batched, the default for --method sac) or "
                         "scalar (one environment; random/grid run here)")
    ap.add_argument("--n-envs", type=int, default=64)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--screen-k", type=int, default=None)
    ap.add_argument("--gate-threshold", type=float, default=None)
    ap.add_argument("--no-surrogate-gate", action="store_true")
    ap.add_argument("--campaign", default="",
                    help="grid spec (.json/.yaml): run a full multi-workload"
                         " x multi-node campaign instead of a single search")
    ap.add_argument("--resume", default="",
                    help="existing campaign run directory to resume")
    ap.add_argument("--campaign-root", default="experiments/campaigns",
                    help="parent directory for new campaign run dirs")
    # refused until their slices land (see validate_args)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--transfer-from", action="append", default=None)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--hosts", default=None)
    ap.add_argument("--launch-template", default=None)
    ap.add_argument("--lease-ttl", type=float, default=None)
    ap.add_argument("--no-supervise", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run: cuda (default) or cpu")
    ap.add_argument("--verbose", action="store_true")
    a = ap.parse_args(argv)
    if a.engine is None:
        a.engine = "vec" if a.method == "sac" else "scalar"
    validate_args(ap, a)
    if a.campaign or a.resume:
        run_campaign_cli(ap, a)
        return
    nodes = list(NODES) if a.nodes == "all" else [
        int(x) for x in a.nodes.split(",")]
    run(a.arch, nodes=nodes, mode=a.mode, episodes=a.episodes,
        method=a.method, out_dir=a.out, seed=a.seed, seq_len=a.seq_len,
        batch=a.batch, update_every=a.update_every, verbose=a.verbose,
        engine=a.engine, n_envs=a.n_envs,
        surrogate_gate=not a.no_surrogate_gate, screen_k=a.screen_k,
        gate_threshold=a.gate_threshold, phase=a.phase, dtype=a.dtype,
        device=a.device)


if __name__ == "__main__":
    main()
