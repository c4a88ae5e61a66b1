"""Trace exporter (port of ``repro.obs.export``): merge a run directory's
JSONL span logs into one Chrome/Perfetto ``trace_event`` JSON.

A fleet campaign leaves one ``trace.jsonl`` per process — the supervisor
parent at ``<root>/trace.jsonl`` and each worker at
``<root>/worker-<i>/trace.jsonl``.  This tool merges them onto one
timeline (each process gets its own ``pid`` lane, named via
``process_name`` metadata), converting epoch-second records to the
microsecond timebase ``chrome://tracing`` / https://ui.perfetto.dev
expect::

    python -m repro_torch.obs.export --root experiments/fleets/run \\
        [--out trace.json]

Default output: ``<root>/report/trace.json``.  Torn trace tails (a
SIGKILLed worker mid-record) are skipped, like every JSONL reader in the
repo.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.trace import (PH_COUNTER, PH_INSTANT, PH_SPAN,
                                   TRACE_NAME, read_trace)


def discover_traces(root: str) -> List[Tuple[str, str]]:
    """(process label, trace path) pairs under a run directory: the
    parent trace plus every worker's, sorted parent-first."""
    out: List[Tuple[str, str]] = []
    top = os.path.join(root, TRACE_NAME)
    if os.path.isfile(top):
        out.append(("main", top))
    for p in sorted(glob.glob(os.path.join(root, "worker-*", TRACE_NAME))):
        out.append((os.path.basename(os.path.dirname(p)), p))
    return out


def to_chrome(traces: List[Tuple[str, List[Dict]]],
              t0: Optional[float] = None) -> Dict:
    """Convert labeled record lists to one ``trace_event`` document.

    ``ts``/``dur`` become microseconds relative to the earliest record
    across all processes (keeps the numbers readable while preserving
    cross-process alignment).  Unknown phases are dropped."""
    starts = [r["ts"] for _, recs in traces for r in recs if "ts" in r]
    base = t0 if t0 is not None else (min(starts) if starts else 0.0)
    events: List[Dict] = []
    for pid, (label, recs) in enumerate(traces):
        events.append(dict(ph="M", name="process_name", pid=pid, tid=0,
                           args=dict(name=label)))
        for r in recs:
            ph = r.get("ph")
            if ph not in (PH_SPAN, PH_INSTANT, PH_COUNTER) \
                    or "ts" not in r:
                continue
            ev = dict(ph=ph, name=r.get("name", "?"),
                      cat=r.get("cat", "app"), pid=pid,
                      tid=int(r.get("tid", 0)),
                      ts=(float(r["ts"]) - base) * 1e6)
            if ph == PH_SPAN:
                ev["dur"] = max(0.0, float(r.get("dur", 0.0))) * 1e6
            if ph == PH_INSTANT:
                ev["s"] = "t"            # thread-scoped instant
            if r.get("args"):
                ev["args"] = r["args"]
            events.append(ev)
    return dict(traceEvents=events, displayTimeUnit="ms")


def export_run(root: str, out: Optional[str] = None) -> str:
    """Merge every trace under ``root`` and write the Chrome JSON;
    returns the output path."""
    found = discover_traces(root)
    if not found:
        raise FileNotFoundError(
            f"no {TRACE_NAME} under {root} (or {root}/worker-*); run the "
            "campaign/fleet with tracing enabled (REPRO_TRACE unset)")
    doc = to_chrome([(label, read_trace(p)) for label, p in found])
    out = out or os.path.join(root, "report", "trace.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f)
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="export a run directory's trace.jsonl files to one "
                    "Chrome/Perfetto trace_event JSON")
    ap.add_argument("--root", required=True,
                    help="campaign/fleet run directory")
    ap.add_argument("--out", default=None,
                    help="output path (default <root>/report/trace.json)")
    a = ap.parse_args(argv)
    try:
        out = export_run(a.root, a.out)
    except (OSError, FileNotFoundError) as e:
        ap.error(str(e))
    n = sum(1 for _ in discover_traces(a.root))
    print(f"[obs] exported {n} trace file(s) -> {out} "
          f"(load in chrome://tracing or ui.perfetto.dev)")


if __name__ == "__main__":
    main()
