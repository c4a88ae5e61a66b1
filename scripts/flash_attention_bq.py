#!/usr/bin/env python3
"""Time the fp16/bf16 ``flash_attention`` kernel at both query-tile sizes on
one GPU.

The kernel library is built twice, with ``FLASH_TC_WARPS=4`` (BQ = 64
query rows a block) and ``FLASH_TC_WARPS=8`` (BQ = 128), ``-Xptxas -v``
on (its lines for the tensor-core kernel are printed).  Each build is held
against ``flash_attention_plain`` at ``ATTN_TOL`` on the shapes below and
on ragged ones, then timed in the order 4, 8, 8, 4: device time per call
(``chip_smoke.device_ms``: 20 calls in a CUDA graph, replayed 10 times
between CUDA events) at Llama 3.1 8B's prefill shape (q [4,32,512,128],
k/v [4,8,512,128], causal) in fp16 and bf16 and at sequence 2048 (q
[1,32,2048,128], k/v [1,8,2048,128]) in fp16, with PyTorch's
``scaled_dot_product_attention`` on the same inputs beside it.  Prints
the card's name and power limit and one JSON line per timed run.

    PYTHONPATH=src python3 scripts/flash_attention_bq.py
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import (ATTN_TOL, attention_work, bound_ms,  # noqa: E402
                        device_ms)
from repro_torch.kernels import build, flash_attention  # noqa: E402

SHAPES = {"lm": (4, 32, 8, 512, 512, 128, True, 0),
          "s2048": (1, 32, 8, 2048, 2048, 128, True, 0)}
CHECKS = [(2, 4, 2, 1000, 1000, 64, True, 0), (1, 4, 2, 300, 170, 80, True, 0),
          (1, 4, 2, 200, 100, 40, False, 70), (1, 4, 4, 1, 1, 96, True, 0)]


def inputs(shape, dt, seed):
    B, H, Hk, Sq, Sk, hd, _, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda").to(dt)
            for s in ((B, H, Sq, hd), (B, Hk, Sk, hd), (B, Hk, Sk, hd))]


def check(warps):
    for i, shape in enumerate(CHECKS + list(SHAPES.values())):
        for dt in (torch.float16, torch.bfloat16):
            q, k, v = inputs(shape, dt, i)
            causal, window = shape[6], shape[7]
            got = flash_attention.flash_attention_cuda(q, k, v, causal=causal,
                                                       window=window)
            want = flash_attention.flash_attention_plain(
                q, k, v, causal=causal, window=window)
            err = float((got.float() - want.float()).abs().max())
            same = torch.equal(got, flash_attention.flash_attention_cuda(
                q, k, v, causal=causal, window=window))
            print(f"check warps={warps} {shape} {str(dt)[6:]}: max abs err "
                  f"{err:.3e}, repeat bitwise {same}", flush=True)
            if not (err < ATTN_TOL[dt] and same):
                sys.exit(f"warps={warps}: {shape} {dt} disagrees")


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    libs = {}
    for warps in (4, 8):
        path = build.build(verbose=True, force=True,
                           defines=[f"FLASH_TC_WARPS={warps}"])
        log = build.last_build_log
        section = log[log.index("== nvcc flash_attention.cu"):]
        section = section[:section.index("\n== ", 1)]
        for line in section.splitlines():
            if re.search(r"Compiling|registers|spill|bytes smem|error", line):
                print(f"ptxas warps={warps}: {line.strip()}", flush=True)
        libs[warps] = build.load(path)
    for warps, lib in libs.items():
        build._lib = lib
        check(warps)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for rnd, warps in enumerate((4, 8, 8, 4)):
        build._lib = libs[warps]
        for name, dt in (("lm", torch.float16), ("lm", torch.bfloat16),
                         ("s2048", torch.float16)):
            shape = SHAPES[name]
            q, k, v = inputs(shape, dt, 99)
            with torch.no_grad():
                ms = device_ms(lambda: flash_attention.flash_attention_cuda(
                    q, k, v))
                lib_ms = device_ms(lambda: sdpa(q, k, v, is_causal=True,
                                                enable_gqa=True))
            flops, nbytes = attention_work(*shape, q.element_size())
            bnd, by, _ = bound_ms(flops, nbytes, unit="half")
            print(json.dumps(dict(
                round=rnd, warps=warps, bq=16 * warps, shape=name,
                dtype=str(dt)[6:], ms=ms, sdpa_ms=lib_ms, bound_ms=bnd,
                bound_by=by, tflops=flops / ms / 1e9)), flush=True)


if __name__ == "__main__":
    main()
