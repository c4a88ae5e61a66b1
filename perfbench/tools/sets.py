"""Run the benchmark's command several times in a row, one process at a
time, and summarise: each run's result line and the tail of its standard
error go to ``<out>/<label>.jsonl``; the summary gives, per cell and per
set, the median and the spread (Q3 - Q1) / median of every metric and
``setup_s`` with each set's first run left out.

    python3 perfbench/tools/sets.py --out out/sets \
        --run mixtral.prefill-mooncake:2147483701:30:0 [--run ...] \
        [--sets 2 --cells mixtral.prefill-mooncake --seeds 11,12 \
         --seconds 30]

``--run cell:seed:seconds:trace`` adds one run; ``--sets N --cells ...
--seeds ...`` adds N sets over the cells, each set the seeds in order, the
same seeds in every set.  ``--checkout`` gives the path of a checkout to
run instead of this one.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--label", default="runs")
    ap.add_argument("--run", action="append", default=[])
    ap.add_argument("--sets", type=int, default=0)
    ap.add_argument("--cells", default="")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--checkout", default=str(ROOT))
    a = ap.parse_args(argv)
    runs = []
    for r in a.run:
        cell, seed, secs, trace = r.split(":")
        runs.append((cell, int(seed), float(secs), int(trace), 0))
    for s in range(a.sets):
        for cell in filter(None, a.cells.split(",")):
            for seed in filter(None, a.seeds.split(",")):
                runs.append((cell, int(seed), a.seconds, a.trace, s + 1))
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    log = open(out / f"{a.label}.jsonl", "a")
    rows = []
    for cell, seed, secs, trace, set_no in runs:
        cmd = [sys.executable, "perfbench/run.py", "--workload", cell,
               "--seed", str(seed), "--seconds", str(secs), "--trace",
               str(trace)]
        t = time.time()
        p = subprocess.run(cmd, cwd=a.checkout, capture_output=True,
                           text=True)
        wall = time.time() - t
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, ValueError):
            res = None
        row = dict(cell=cell, seed=seed, seconds=secs, trace=trace,
                   set=set_no, rc=p.returncode, wall_s=wall, result=res,
                   stderr_tail=p.stderr[-3000:], card=smi)
        log.write(json.dumps(row) + "\n")
        log.flush()
        rows.append(row)
        m = res["metrics"] if res else {}
        brief = {k: round(v["value"], 4) for k, v in m.items()}
        chk = res and {k: round(v["value"], 5)
                       for k, v in res["check"].items()}
        setup = res and {k: round(v, 2) for k, v in res["setup"].items()}
        print(f"{cell} seed {seed} trace {trace} set {set_no}: rc "
              f"{p.returncode} wall {wall:.1f} s correct "
              f"{res and res['correct']} {brief} "
              f"check {chk} setup {setup} "
              f"peak {res and res['device']['memory_peak_bytes']}",
              flush=True)
        if not res:
            print(p.stderr[-2500:], flush=True)
    # per cell and set: median and spread of each metric
    for cell in sorted({r["cell"] for r in rows}):
        for set_no in sorted({r["set"] for r in rows if r["cell"] == cell}):
            rs = [r for r in rows if r["cell"] == cell and r["set"] == set_no
                  and r["result"] and r["trace"] == 0]
            if len(rs) < 2:
                continue
            names = sorted(set().union(*(r["result"]["metrics"] for r in rs)))
            for n in names:
                vals = [r["result"]["metrics"][n]["value"] for r in rs
                        if n in r["result"]["metrics"]]
                if n == "setup_s":
                    vals = vals[1:]
                if len(vals) >= 2:
                    print(f"SPREAD {cell} set {set_no} {n}: median "
                          f"{statistics.median(vals):.6g} spread "
                          f"{spread(vals)} n {len(vals)} values "
                          f"{[round(v, 4) for v in vals]}", flush=True)


if __name__ == "__main__":
    main()
