#!/usr/bin/env python3
"""Time an LM prefill and its kernel in two source trees on one card.

Each tree is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory, and the working
tree).  Every run is a fresh process that imports ``repro_torch`` from that
tree, makes the weights and prompts of ``chip_smoke.py``'s LM run ``--lm``
(``serve.inputs``, seed 0, batch 4, prompt 512): run a, Llama 3.1 8B in
fp16; run b, Jamba v0.1 at full width and 8 layers in bf16; run c, Llama
3.1 8B at full width and 2 layers in float32; or run d, the Jamba of b in
float32; warms up with a 2-token generation, then times ``--reps``
prefills (``serve.generate``'s host clock between synchronisations) and
the tree's kernel of that run at that prefill's shape: for a, c and d
``flash_attention`` (q [4,32,512,128], k/v [4,8,512,128] causal, fp16 for
a, fp32 for c and d), for b ``ssm_scan`` (dt/x [4,512,8192], B/C
[4,512,16]), with the tree's
``chip_smoke.device_ms`` (20 calls in a CUDA graph, replayed 10 times
between CUDA events).  The kernels of both trees are built first, so no
timed run includes ``nvcc``.  Runs go in the order given (default P C C
P), one JSON line each: every prefill's ms, their median, the kernel's µs
and its launches in one prefill.

    python3 scripts/ab_prefill.py --trees experiments/parent . [--lm b|c|d]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import dataclasses, json, statistics, sys
import torch
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
from repro_torch.kernels import build, flash_attention, ops, ssm_scan
if sys.argv[2] == "build":
    build.library()
    print(json.dumps({"built": build.build().name}))
    raise SystemExit
from chip_smoke import LM_RUNS, device_ms
from repro_torch.configs import get_config
from repro_torch.launch import serve
dev = torch.device("cuda")
lm = sys.argv[4]
arch, changes = next(r[1:3] for r in LM_RUNS if r[0] == lm)
cfg = dataclasses.replace(get_config(arch), **changes)
name = "ssm_scan" if lm == "b" else "flash_attention"
params, prompts, ctx = serve.inputs(cfg, 4, 512, 0, dev)
serve.generate(params, cfg, prompts, 2, ctx)
ms = []
for _ in range(int(sys.argv[3])):
    ops.reset_launch_counts()
    ms.append(1e3 * serve.generate(params, cfg, prompts, 1, ctx).t_prefill)
launches = ops.launch_counts()[name]
del params, ctx
g = torch.Generator(device=dev).manual_seed(0)
if name == "flash_attention":
    dt = torch.float16 if lm == "a" else torch.float32
    q = torch.randn((4, 32, 512, 128), generator=g, device=dev).to(dt)
    k, v = (torch.randn((4, 8, 512, 128), generator=g, device=dev).to(dt)
            for _ in range(2))
    kernel_ms = device_ms(
        lambda: flash_attention.flash_attention_cuda(q, k, v))
else:
    ins = (torch.rand((4, 512, 8192), generator=g, device=dev) * 0.1 + 1e-3,
           torch.randn((4, 512, 16), generator=g, device=dev),
           torch.randn((4, 512, 16), generator=g, device=dev),
           torch.randn((4, 512, 8192), generator=g, device=dev),
           -torch.exp(0.5 * torch.randn((8192, 16), generator=g,
                                        device=dev)))
    kernel_ms = device_ms(lambda: ssm_scan.ssm_scan_cuda(*ins))
print(json.dumps({"lm": lm, "prefill_ms": ms,
                  "median_prefill_ms": statistics.median(ms),
                  f"{name}_us": 1e3 * kernel_ms,
                  f"{name}_launches": launches}))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, required=True, metavar=("P", "C"))
    ap.add_argument("--order", default="PCCP")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--lm", choices=["a", "b", "c", "d"], default="a")
    a = ap.parse_args()
    trees = dict(zip("PC", (os.path.abspath(t) for t in a.trees)))

    def call(label, mode):
        out = subprocess.run(
            [sys.executable, "-c", RUN, trees[label], mode, str(a.reps),
             a.lm],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.exit(f"{label} {mode} failed:\n{out.stderr[-4000:]}")
        return json.loads(out.stdout.strip().splitlines()[-1])

    for label in "PC":
        print(json.dumps(dict(tree=label, **call(label, "build"))),
              flush=True)
    for i, label in enumerate(a.order):
        print(json.dumps(dict(run=i, tree=label, **call(label, "time"))),
              flush=True)


if __name__ == "__main__":
    main()
