"""Campaign reporting (port of ``repro.campaign.report``): per-cell
best-PPA, cross-node adaptation, scaling and fleet worker tables.

``write_reports`` renders, each as JSON + markdown under
``<run-dir>/report/``, byte for byte as the reference does:

* ``cells``      — one best-PPA row per completed cell.
* ``adaptation`` — for each (workload, mode), how the chosen design adapts
  across process nodes (mesh size, FETCH, VLEN, memory split, frequency,
  PPA).
* ``scaling``    — for every (workload, mode) with >= 2 completed nodes, a
  log-log linear fit of the selected design's PPA vs process node, with
  the per-cell frontier data the fit was read from.
* ``workers``    — fleet campaigns only: per-worker utilization (cells,
  episodes, busy seconds, busy/fleet-wall percentage) from the stats the
  reconciler folds into the manifest's ``fleet`` block, plus the
  supervision event log (evictions, mid-run re-deals, stale-leg
  closures).

``write_index_report`` renders the archive index the recommendation path
serves (``index.{json,md}``: frontier size and mode-default pick a cell).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.campaign.planner import scenario_suffix

CELL_COLS = ("cell_id", "mesh", "fetch", "vlen", "wmem_kb", "dmem_kb",
             "freq_mhz", "tok_s", "power_mw", "area_mm2", "ppa_score",
             "episodes", "frontier", "gate_open_episode", "screened",
             "evaluated", "wall_s")
ADAPT_COLS = ("node_nm", "mesh", "fetch", "vlen", "wmem_kb", "dmem_kb",
              "freq_mhz", "tok_s", "power_mw", "area_mm2", "ppa_score")
WORKER_COLS = ("worker", "cells", "episodes", "busy_s", "util_pct")
INDEX_COLS = ("cell_id", "frontier", "power_mw", "perf_gops", "area_mm2",
              "tok_s", "ppa_score")


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return "-" if v is None else str(v)


def markdown_table(rows: Sequence[Dict], cols: Sequence[str]) -> str:
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "|".join("---" for _ in cols) + "|"]
    for r in rows:
        lines.append("| " + " | ".join(_fmt(r.get(c)) for c in cols) + " |")
    return "\n".join(lines) + "\n"


def cell_rows(store) -> List[Dict]:
    """Per-cell best-PPA table, sorted by (arch, scenario, mode, node)."""
    rows = list(store.summaries().values())
    rows.sort(key=lambda r: (r.get("arch", ""), r.get("dtype", "native"),
                             r.get("phase", "decode"), r.get("mode", ""),
                             r.get("node_nm", 0)))
    return rows


def adaptation_tables(store) -> Dict[str, List[Dict]]:
    """Cross-node adaptation: {"<arch>__<mode>[__<dtype>-<phase>]":
    [per-node rows]}.

    Each row is the converged design for one process node — reading down a
    column (mesh, FETCH, VLEN, memory split) shows how the single RL loop
    retunes the architecture across nodes without manual intervention.
    Off-default scenario cells get their own group (suffixed key), so a
    dtype x phase grid reads as side-by-side adaptation tables — the
    per-axis re-tuning evidence."""
    out: Dict[str, List[Dict]] = {}
    for row in cell_rows(store):
        key = (f"{row.get('arch')}__{row.get('mode')}"
               + scenario_suffix(row.get("dtype", "native"),
                                 row.get("phase", "decode")))
        out.setdefault(key, []).append(
            {c: row.get(c) for c in ADAPT_COLS})
    for rows in out.values():
        rows.sort(key=lambda r: r["node_nm"] or 0)
    return out


def format_event(ev: Dict) -> str:
    """One human-readable markdown line per supervision event.

    The raw event dicts carry kind-specific fields (``pending`` on an
    evict, ``batches`` on a re-deal, epoch-float ``ts``); a generic
    column table rendered them as raw dicts with epoch timestamps.  Here
    each kind gets a sentence with a wall-clock timestamp and the
    affected batch ids spelled out; unknown kinds degrade to sorted
    ``k=v`` pairs so nothing is silently dropped."""
    ts = time.strftime("%Y-%m-%d %H:%M:%S",
                       time.localtime(float(ev.get("ts") or 0.0)))
    kind = ev.get("kind", "?")

    def _ids(key: str) -> str:
        v = ev.get(key) or []
        return ", ".join(f"`{b}`" for b in v) if isinstance(v, list) \
            else f"`{v}`"

    if kind == "evict":
        pend = (f"pending batch(es) {_ids('pending')}" if ev.get("pending")
                else "no pending batches")
        det = (f"worker {ev.get('worker')} evicted "
               f"({ev.get('reason')}, returncode="
               f"{ev.get('returncode')}); {pend}")
    elif kind == "redeal":
        det = (f"batch(es) {_ids('batches')} re-dealt from worker "
               f"{ev.get('from_worker')} to fresh slot "
               f"{ev.get('to_worker')} ({ev.get('reason')})")
    elif kind == "gave-up":
        det = (f"gave up on batch(es) {_ids('batches')} from worker "
               f"{ev.get('worker')} after {ev.get('max_redeals')} "
               "re-deal(s); left pending for --resume")
    elif kind == "stale-leg-closed":
        det = (f"stale wall-clock leg closed at {_fmt(ev.get('wall_s'))}s "
               "(every lease older than the TTL)")
    else:
        extra = {k: v for k, v in ev.items() if k not in ("ts", "kind")}
        det = ", ".join(f"{k}={v}" for k, v in sorted(extra.items()))
    return f"- `{ts}` **{kind}** — {det}"


def worker_rows(store) -> List[Dict]:
    """Per-worker utilization of a fleet campaign ([] for single-process
    runs): cells/episodes completed, busy seconds, and busy time as a
    percentage of the fleet's wall clock (how evenly the deal kept the
    workers fed)."""
    fleet = store.manifest.get("fleet") or {}
    stats = fleet.get("worker_stats") or {}
    wall = float(fleet.get("wall_s") or 0.0)
    rows = []
    for name in sorted(stats):
        s = stats[name]
        busy = float(s.get("busy_s") or 0.0)
        rows.append(dict(worker=name, cells=s.get("cells"),
                         episodes=s.get("episodes"), busy_s=round(busy, 2),
                         util_pct=(round(100.0 * busy / wall, 1)
                                   if wall > 0 else None)))
    return rows


SCALING_METRICS = ("power_mw", "perf_gops", "area_mm2", "tok_s")
SCALING_COLS = ("metric", "slope", "intercept", "mean_sq_residual")


def scaling_fits(store) -> Dict:
    """Per-(workload, mode) PPA-vs-node scaling fits from merged archives.

    For every cell with a non-empty archive, the mode-default scalarized
    ``select()`` winner (the design the serving layer would answer with)
    contributes one point; groups with >= 2 distinct nodes get, per
    metric, a least-squares line in log-log space —
    ``log(metric) = slope * log(node_nm) + intercept`` — whose slope is
    the empirical scaling exponent the paper's cross-node tables read
    qualitatively.  Returns ``{"fits": {...}, "cells": {...}}`` where
    ``cells`` carries each cell's full frontier arrays (the fit's raw
    data, JSON-safe)."""
    from repro_torch.launch.recommend import (MODE_WEIGHTS, split_cell_id,
                                              split_scenario)
    groups: Dict = {}
    cells: Dict[str, Dict] = {}
    for cid in sorted(store.manifest["cells"]):
        ar = store.load_archive(cid)
        if not len(ar):
            continue
        arch, node_nm, mode = split_cell_id(cid)
        _, dt, ph = split_scenario(cid)
        cells[cid] = {k: np.asarray(v, np.float64).tolist()
                      for k, v in ar.frontier().items()}
        e = ar.select(*MODE_WEIGHTS.get(mode, MODE_WEIGHTS["high_perf"]))
        if e is not None:
            groups.setdefault((arch, mode, dt, ph), []).append((node_nm, e))
    fits: Dict[str, Dict] = {}
    for (arch, mode, dt, ph), pts in sorted(groups.items()):
        pts.sort(key=lambda p: p[0])
        nodes = [p[0] for p in pts]
        if len(set(nodes)) < 2:
            continue
        ln = np.log(np.asarray(nodes, np.float64))
        metrics = {}
        for name in SCALING_METRICS:
            vals = np.asarray([getattr(e, name) for _, e in pts],
                              np.float64)
            ly = np.log(np.maximum(vals, 1e-12))
            slope, intercept = np.polyfit(ln, ly, 1)
            resid = float(np.mean((slope * ln + intercept - ly) ** 2))
            metrics[name] = dict(slope=round(float(slope), 6),
                                 intercept=round(float(intercept), 6),
                                 mean_sq_residual=round(resid, 8),
                                 values=vals.tolist())
        fits[f"{arch}__{mode}{scenario_suffix(dt, ph)}"] = \
            dict(nodes=nodes, metrics=metrics)
    return dict(fits=fits, cells=cells)


def write_scaling_report(store, out_dir: Optional[str] = None
                         ) -> Dict[str, str]:
    """Emit ``scaling.{json,md}``.  Always writes both (fits may be empty
    for single-node grids; the per-cell frontier data is still there)."""
    out_dir = out_dir or os.path.join(store.root, "report")
    os.makedirs(out_dir, exist_ok=True)
    data = scaling_fits(store)
    paths = {"scaling_json": os.path.join(out_dir, "scaling.json"),
             "scaling_md": os.path.join(out_dir, "scaling.md")}
    with open(paths["scaling_json"], "w") as f:
        json.dump(data, f, indent=1, allow_nan=False)
    with open(paths["scaling_md"], "w") as f:
        f.write(f"# Campaign `{store.manifest['name']}` — PPA-vs-node "
                f"scaling ({len(data['fits'])} fit groups, "
                f"{len(data['cells'])} cells)\n")
        for key, fit in sorted(data["fits"].items()):
            f.write(f"\n## {key} (nodes: "
                    f"{', '.join(str(n) for n in fit['nodes'])}nm)\n\n")
            rows = [dict(metric=m, **{c: fit["metrics"][m][c]
                                      for c in SCALING_COLS[1:]})
                    for m in SCALING_METRICS]
            f.write(markdown_table(rows, SCALING_COLS))
    return paths


def write_reports(store, out_dir: Optional[str] = None) -> Dict[str, str]:
    """Emit cells + adaptation + scaling (+ fleet workers) tables as JSON
    and markdown; returns paths."""
    out_dir = out_dir or os.path.join(store.root, "report")
    os.makedirs(out_dir, exist_ok=True)
    paths = {}

    rows = cell_rows(store)
    paths["cells_json"] = os.path.join(out_dir, "cells.json")
    with open(paths["cells_json"], "w") as f:
        json.dump(rows, f, indent=1, allow_nan=False)
    paths["cells_md"] = os.path.join(out_dir, "cells.md")
    with open(paths["cells_md"], "w") as f:
        f.write(f"# Campaign `{store.manifest['name']}` — per-cell best "
                f"PPA ({len(rows)} cells)\n\n")
        f.write(markdown_table(rows, CELL_COLS))

    adapt = adaptation_tables(store)
    paths["adaptation_json"] = os.path.join(out_dir, "adaptation.json")
    with open(paths["adaptation_json"], "w") as f:
        json.dump(adapt, f, indent=1, allow_nan=False)
    paths["adaptation_md"] = os.path.join(out_dir, "adaptation.md")
    with open(paths["adaptation_md"], "w") as f:
        f.write(f"# Campaign `{store.manifest['name']}` — cross-node "
                f"adaptation\n")
        for key, rws in sorted(adapt.items()):
            f.write(f"\n## {key}\n\n")
            f.write(markdown_table(rws, ADAPT_COLS))

    paths.update(write_scaling_report(store, out_dir))

    workers = worker_rows(store)
    if workers:
        fleet = store.manifest.get("fleet") or {}
        events = list(fleet.get("events") or [])
        paths["workers_json"] = os.path.join(out_dir, "workers.json")
        with open(paths["workers_json"], "w") as f:
            json.dump(dict(workers=workers, events=events), f, indent=1,
                      allow_nan=False)
        paths["workers_md"] = os.path.join(out_dir, "workers.md")
        wall = fleet.get("wall_s")
        with open(paths["workers_md"], "w") as f:
            f.write(f"# Campaign `{store.manifest['name']}` — per-worker "
                    f"utilization ({len(workers)} workers, "
                    f"fleet wall {_fmt(wall)}s)\n\n")
            f.write(markdown_table(workers, WORKER_COLS))
            if events:
                f.write(f"\n## Supervision events ({len(events)})\n\n")
                f.write("\n".join(format_event(e) for e in events) + "\n")
    return paths


def index_rows(cells: Dict) -> List[Dict]:
    """One row per archive-index cell: frontier size + the mode-default
    scalarized ``select()`` winner the recommendation path serves."""
    from repro_torch.launch.recommend import MODE_WEIGHTS, split_cell_id

    rows = []
    for cid in sorted(cells):
        ar = cells[cid]
        _, _, mode = split_cell_id(cid)
        e = ar.select(*MODE_WEIGHTS.get(mode, MODE_WEIGHTS["high_perf"]))
        row = dict(cell_id=cid, frontier=len(ar))
        if e is not None:
            row.update(power_mw=e.power_mw, perf_gops=e.perf_gops,
                       area_mm2=e.area_mm2, tok_s=e.tok_s,
                       ppa_score=e.ppa_score)
        rows.append(row)
    return rows


def write_index_report(store, cells: Dict,
                       out_dir: Optional[str] = None) -> Dict[str, str]:
    """Emit the archive-index serving table (JSON + markdown)."""
    out_dir = out_dir or os.path.join(store.root, "report")
    os.makedirs(out_dir, exist_ok=True)
    rows = index_rows(cells)
    paths = {"index_json": os.path.join(out_dir, "index.json"),
             "index_md": os.path.join(out_dir, "index.md")}
    with open(paths["index_json"], "w") as f:
        json.dump(rows, f, indent=1, allow_nan=False)
    with open(paths["index_md"], "w") as f:
        f.write(f"# Campaign `{store.manifest['name']}` — archive index "
                f"({len(rows)} cells served)\n\n")
        f.write(markdown_table(rows, INDEX_COLS))
    return paths
