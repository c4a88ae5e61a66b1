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
        [--campaign-root experiments/campaigns] [--workers W] [--devices N]
    python -m repro_torch.launch.dse --resume experiments/campaigns/<name>

``--workers W`` runs the campaign as a supervised fleet of W worker
processes on the same device (``repro_torch.launch.fleet``; W workers
share one card), with ``--hosts``/``--launch-template`` for remote
workers, ``--lease-ttl`` and ``--no-supervise``.  ``--devices N`` (alias
``--mesh N|auto``) chunks the env batch over the first N cards
(``repro_torch.distributed.sharding``); more than the visible cards is a
one-line error.  ``--transfer-from ROOT`` (repeatable) warm-starts the new
campaign from finished run directories of either package
(``repro_torch.campaign.transfer``): donor weights and re-evaluated
frontiers seed each batch, and a cost model fitted on ``--device`` orders
the batches.  Finished archives answer design queries through
``python -m repro_torch.launch.recommend`` and ``serve --recommend``.
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
        gate_threshold: Optional[float] = None,
        devices: Optional[int] = None, phase: str = "decode",
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
                                 n_envs=n_envs, devices=devices,
                                 device=device)
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


def _parse_hosts(s: Optional[str]) -> Optional[List[str]]:
    """--hosts comma list -> cleaned host names (None if flag absent)."""
    if s is None:
        return None
    return [h.strip() for h in s.split(",") if h.strip()]


def _resolve_devices(ap: argparse.ArgumentParser,
                     a: argparse.Namespace) -> Optional[int]:
    """--mesh/--devices -> device count (None = the plain single-device
    step), checked against the cards ``--device`` sees before any work:
    more than ``torch.cuda.device_count()`` is a one-line ``ap.error``.
    ``--mesh auto`` takes every visible card (one on the CPU)."""
    if a.mesh is not None and a.devices is not None:
        ap.error("--mesh and --devices are aliases; pass exactly one")
    spec = a.mesh if a.mesh is not None else a.devices
    if spec is None:
        return None
    from repro_torch.distributed.sharding import batch_mesh
    n = None
    if spec != "auto":
        try:
            n = int(spec)
        except ValueError:
            ap.error(f"--mesh must be 'auto' or a device count "
                     f"(got {spec!r})")
        if n < 1:
            ap.error(f"--devices must be >= 1 (got {n})")
    try:
        return len(batch_mesh(n, device=a.device))
    except ValueError as e:
        ap.error(f"--devices {spec}: {e}")


def validate_args(ap: argparse.ArgumentParser,
                  a: argparse.Namespace) -> None:
    """Reject invalid flag combinations up front with a one-line error
    (the reference's checks)."""
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
    mesh_flags = [n for n, v in (("--devices", a.devices),
                                 ("--mesh", a.mesh)) if v is not None]
    if mesh_flags and a.resume:
        ap.error(f"{'/'.join(mesh_flags)}: a resumed campaign keeps the "
                 "mesh recorded in its manifest; start a new campaign to "
                 "change it")
    if mesh_flags and not a.campaign and a.engine != "vec":
        ap.error(f"{'/'.join(mesh_flags)} chunk the batched engine's env "
                 "batch over devices; pass --engine vec or --campaign "
                 "with them")
    if a.workers is not None and a.workers < 1:
        ap.error(f"--workers must be >= 1 (got {a.workers})")
    if a.workers is not None and not (a.campaign or a.resume):
        ap.error("--workers shards a campaign across worker processes; "
                 "pass --campaign (or --resume) with it")
    fleet_flags = [n for n, v in (("--hosts", a.hosts),
                                  ("--launch-template", a.launch_template),
                                  ("--lease-ttl", a.lease_ttl))
                   if v is not None]
    if a.no_supervise:
        fleet_flags.append("--no-supervise")
    if fleet_flags and a.workers is None and not a.resume:
        ap.error(f"{'/'.join(fleet_flags)} configure fleet campaigns; "
                 "pass --workers (or --resume) with them")
    if a.lease_ttl is not None and a.lease_ttl <= 0:
        ap.error(f"--lease-ttl must be > 0 seconds (got {a.lease_ttl})")
    if a.hosts is not None and not _parse_hosts(a.hosts):
        ap.error(f"--hosts must be a comma list of host names "
                 f"(got {a.hosts!r})")
    if a.launch_template is not None and (
            "{root}" not in a.launch_template
            or "{worker}" not in a.launch_template):
        ap.error("--launch-template must reference {root} and {worker} "
                 f"(got {a.launch_template!r})")
    if a.launch_template is not None and "{host}" in a.launch_template \
            and a.hosts is None:
        ap.error("--launch-template references {host}; pass --hosts too")
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
    if a.transfer_from and a.resume:
        ap.error("--transfer-from: a resumed campaign keeps the warm-start "
                 "donors recorded in its manifest; start a new campaign to "
                 "change them")
    if a.transfer_from and not a.campaign:
        ap.error("--transfer-from warm-starts a campaign from completed "
                 "run directories; pass --campaign with it")
    for r in a.transfer_from or []:
        if not os.path.isfile(os.path.join(r, "manifest.json")):
            ap.error(f"--transfer-from: no campaign manifest under {r}")
    if a.campaign and not os.path.isfile(a.campaign):
        ap.error(f"--campaign grid file not found: {a.campaign}")
    if a.resume and not os.path.isfile(os.path.join(a.resume,
                                                    "manifest.json")):
        ap.error(f"--resume: no campaign manifest under {a.resume}")


def run_campaign_cli(ap: argparse.ArgumentParser, a: argparse.Namespace,
                     devices: Optional[int]) -> None:
    """``--campaign`` / ``--resume``: plan, run, persist and report, as
    one process or (``--workers``, or a fleet manifest on ``--resume``) as
    a supervised fleet of worker processes on ``--device``."""
    import dataclasses

    from repro_torch.campaign import CampaignSpec, CampaignStore, run_campaign
    hosts = _parse_hosts(a.hosts)
    fleet_kw = dict(lease_ttl_s=a.lease_ttl, supervise=not a.no_supervise,
                    device=a.device)
    if a.launch_template or hosts:
        from repro_torch.launch.fleet import make_launcher
        fleet_kw["launcher"] = make_launcher(a.launch_template, hosts,
                                             a.device)
    if a.resume:
        store = CampaignStore.open(a.resume)
        try:
            store.spec          # an invalid spec raises here
        except (ValueError, TypeError) as e:
            ap.error(f"--resume {a.resume}: {e}")
        if a.workers is not None or store.manifest.get("fleet"):
            from repro_torch.launch.fleet import run_fleet
            run_fleet(a.resume, workers=a.workers, resume=True, **fleet_kw)
        else:
            if hosts or a.launch_template or a.lease_ttl is not None \
                    or a.no_supervise:
                ap.error(f"{a.resume} is a single-process campaign; "
                         "fleet flags need --workers N to upgrade it "
                         "to a fleet on resume")
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
    if devices is not None:
        overrides["devices"] = devices
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    if a.transfer_from:
        from repro_torch.campaign import transfer as transfer_mod
        try:
            spec = transfer_mod.with_transfer(spec, a.transfer_from,
                                              device=a.device)
        except (ValueError, FileNotFoundError) as e:
            ap.error(f"--transfer-from: {e}")
    root = os.path.join(a.campaign_root, spec.name)
    if a.workers is not None:
        # any explicit --workers (including 1) runs the fleet layout,
        # matching what --resume --workers produces
        from repro_torch.launch.fleet import run_fleet
        run_fleet(root, spec, workers=a.workers, **fleet_kw)
    else:
        run_campaign(root, spec, device=a.device)


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
    ap.add_argument("--devices", type=int, default=None,
                    help="chunk the env batch over this many cards (vec "
                         "engine / campaigns); must divide the batch and "
                         "be <= torch.cuda.device_count() (any count on "
                         "the CPU).  Chunked runs are bitwise the plain "
                         "ones")
    ap.add_argument("--mesh", default=None, metavar="N|auto",
                    help="alias for --devices; 'auto' takes every visible "
                         "card")
    ap.add_argument("--screen-k", type=int, default=None)
    ap.add_argument("--gate-threshold", type=float, default=None)
    ap.add_argument("--no-surrogate-gate", action="store_true")
    ap.add_argument("--campaign", default="",
                    help="grid spec (.json/.yaml): run a full multi-workload"
                         " x multi-node campaign instead of a single search")
    ap.add_argument("--resume", default="",
                    help="existing campaign run directory to resume "
                         "(fleet campaigns resume at fleet scope: "
                         "completed cells are reconciled and skipped, "
                         "unfinished batches are re-dealt)")
    ap.add_argument("--campaign-root", default="experiments/campaigns",
                    help="parent directory for new campaign run dirs")
    ap.add_argument("--transfer-from", action="append", default=None,
                    metavar="ROOT",
                    help="warm-start the new campaign from a completed "
                         "campaign run directory (repeatable)")
    ap.add_argument("--workers", type=int, default=None,
                    help="shard the campaign's cell batches across this "
                         "many shared-nothing worker processes on "
                         "--device (repro_torch.launch.fleet); with "
                         "--resume, overrides the manifest's recorded "
                         "worker count")
    ap.add_argument("--hosts", default=None,
                    help="comma list of hosts for fleet workers (slot i "
                         "runs on hosts[i %% len]); implies the ssh "
                         "launch template unless --launch-template is "
                         "given; the grid file's 'hosts' key is the "
                         "fallback")
    ap.add_argument("--launch-template", default=None,
                    help="command template spawning one fleet worker, "
                         "e.g. 'ssh {host} python -m "
                         "repro_torch.launch.fleet --root {root} --worker "
                         "{worker} --device {device}'; {python} expands "
                         "to the local interpreter")
    ap.add_argument("--lease-ttl", type=float, default=None,
                    help="fleet worker lease TTL in seconds (default 15): "
                         "a worker silent for longer is presumed dead and "
                         "its pending batches are re-dealt mid-run")
    ap.add_argument("--no-supervise", action="store_true",
                    help="disable the elastic fleet supervisor: dead "
                         "workers' batches are NOT re-dealt mid-run; "
                         "recover manually with --resume")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run: cuda (default) or cpu")
    ap.add_argument("--verbose", action="store_true")
    a = ap.parse_args(argv)
    if a.engine is None:
        a.engine = "vec" if a.method == "sac" else "scalar"
    validate_args(ap, a)
    devices = _resolve_devices(ap, a)
    if devices is not None and not a.campaign and a.n_envs % devices:
        ap.error(f"--n-envs {a.n_envs} must divide evenly over "
                 f"--devices {devices}")
    if a.campaign or a.resume:
        run_campaign_cli(ap, a, devices)
        return
    nodes = list(NODES) if a.nodes == "all" else [
        int(x) for x in a.nodes.split(",")]
    run(a.arch, nodes=nodes, mode=a.mode, episodes=a.episodes,
        method=a.method, out_dir=a.out, seed=a.seed, seq_len=a.seq_len,
        batch=a.batch, update_every=a.update_every, verbose=a.verbose,
        engine=a.engine, n_envs=a.n_envs,
        surrogate_gate=not a.no_surrogate_gate, screen_k=a.screen_k,
        gate_threshold=a.gate_threshold, devices=devices, phase=a.phase,
        dtype=a.dtype, device=a.device)


if __name__ == "__main__":
    main()
