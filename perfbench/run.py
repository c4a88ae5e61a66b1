"""Benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Set-up makes
the weights and the prompts from the seed on the card, builds (or loads)
the kernels and warms up every request shape of the cell's traffic; the
window then runs one closed-loop client over
``repro_torch.launch.serve.generate`` for ``--seconds``.  The last line of
standard output is the result as one JSON object; the numbers that decide
``correct`` are the last lines of standard error.  Without a CUDA device,
or with fewer than the cell asks for, it exits with 2 and prints no
result.  The program's build and kernel caches live in directories of the
checkout.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".perfbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(HERE), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch
    from benchlib import cells, runner

    bench = cells.benchmark(ROOT)
    cell = cells.cell(bench, a.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    res = runner.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                          dev=dev, t_process=T_PROCESS, root=ROOT)
    res.pop("extra")
    bad = runner.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    setup = res["setup"]
    print("setup " + " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                              else f"{k}={v}" for k, v in setup.items()),
          file=sys.stderr)
    for k, v in res["check"].items():
        print(f"check {k} {v}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
