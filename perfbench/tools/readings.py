"""Readings that the correctness limits are set from: for each seed, in
one process, a short window of the cell at its own load, the program's
compared numbers and the control's (the reference in float8 put in the
program's place, read at the same positions).

    python3 perfbench/tools/readings.py --workload mixtral.prefill-mooncake \
        --seeds 11,12,13 --seconds 4 --out out/readings.jsonl
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    import torch
    from benchlib import runner
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    with open(a.out, "a") as f:
        for seed in (int(s) for s in a.seeds.split(",")):
            t = time.perf_counter()
            res = runner.run_cell(a.workload, seed, a.seconds, False,
                                  dev=dev, t_process=t,
                                  control=bool(a.control), warm=False)
            nums = res["extra"]["nums"]
            row = dict(workload=a.workload, seed=seed,
                       correct=res["correct"], requests=res["attempted"],
                       program=nums["program"],
                       control=nums.get("control"),
                       check_s=res["setup"]["check_s"],
                       wall_s=time.perf_counter() - t,
                       peak=res["device"]["memory_peak_bytes"])
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(json.dumps(row), flush=True)
            del res, nums
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
