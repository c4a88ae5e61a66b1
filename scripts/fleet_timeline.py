#!/usr/bin/env python3
"""Print a fleet run's timeline from its traces.

Reads ``<root>/trace.jsonl`` (the supervisor parent) and every
``<root>/worker-<i>/trace.jsonl`` and prints, in seconds from the parent's
first record: when each worker was spawned, when its process wrote its
first record (its start-up: interpreter, imports, device), its first
dispatch (which loads the kernel library on ``cuda``), each batch it ran,
and its last record; then the fleet's wall and each worker's busy share
of it (the time inside its batches over the wall), and the parent's own
spans and instants (spawns, reconciles, the reports).  The same numbers
as one JSON line last.

    PYTHONPATH=src python3 scripts/fleet_timeline.py --root \\
        experiments/campaigns/chip_smoke/phase11/fleet/paper-grid
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.obs.export import discover_traces  # noqa: E402
from repro_torch.obs.trace import read_trace  # noqa: E402


def timeline(root: str) -> dict:
    traces = {label: read_trace(path) for label, path in
              discover_traces(root)}
    if "main" not in traces:
        raise SystemExit(f"no parent trace.jsonl under {root}")
    parent = traces.pop("main")
    t0 = min(r["ts"] for r in parent if "ts" in r)
    end = max(r["ts"] + r.get("dur", 0.0) for recs in
              [parent, *traces.values()] for r in recs if "ts" in r)
    spawned = {f"worker-{r['args']['worker']}": r["ts"] - t0
               for r in parent if r.get("name") == "worker_spawned"}
    out = dict(wall_s=end - t0, workers={}, parent=[
        dict(name=r["name"], start_s=r["ts"] - t0, dur_s=r.get("dur"),
             **({"worker": r["args"]["worker"]} if "worker" in
                r.get("args", {}) else {}))
        for r in parent if r.get("ph") in ("X", "i")])
    for label, recs in sorted(traces.items()):
        first = min(r["ts"] for r in recs if "ts" in r) - t0
        last = max(r["ts"] + r.get("dur", 0.0)
                   for r in recs if "ts" in r) - t0
        disp = [r for r in recs if r.get("name") == "first_dispatch"]
        batches = [dict(batch=r["args"]["batch"], start_s=r["ts"] - t0,
                        dur_s=r["dur"]) for r in recs
                   if r.get("name") == "execute_batch"]
        busy = sum(b["dur_s"] for b in batches)
        out["workers"][label] = dict(
            spawned_s=spawned.get(label), first_record_s=first,
            first_dispatch_s=[r["ts"] - t0 for r in disp],
            first_dispatch_dur_s=[r["dur"] for r in disp],
            batches=batches, last_record_s=last, busy_s=busy,
            busy_share=busy / out["wall_s"] if out["wall_s"] > 0 else None)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="fleet run directory")
    a = ap.parse_args()
    tl = timeline(a.root)
    print(f"fleet wall {tl['wall_s']:.3f} s (parent's first record to the "
          "last record of any process)")
    for label, w in tl["workers"].items():
        spawn = w["spawned_s"]
        print(f"{label}: spawned {spawn if spawn is None else round(spawn, 3)}"
              f" s, first record {w['first_record_s']:.3f} s, first "
              f"dispatch at {[round(x, 3) for x in w['first_dispatch_s']]} "
              f"s lasting {[round(x, 3) for x in w['first_dispatch_dur_s']]}"
              f" s, last record {w['last_record_s']:.3f} s, busy "
              f"{w['busy_s']:.3f} s ({100 * (w['busy_share'] or 0):.1f}%)")
        for b in w["batches"]:
            print(f"  {b['batch']}: {b['start_s']:.3f} s + "
                  f"{b['dur_s']:.3f} s")
    for r in tl["parent"]:
        dur = "" if r["dur_s"] is None else f" + {r['dur_s']:.3f} s"
        who = f" (worker {r['worker']})" if "worker" in r else ""
        print(f"parent {r['name']}{who}: {r['start_s']:.3f} s{dur}")
    print(json.dumps(tl))


if __name__ == "__main__":
    main()
