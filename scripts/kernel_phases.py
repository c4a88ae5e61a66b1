#!/usr/bin/env python3
"""Where the ``sumtree`` and ``actor_moe`` kernels spend their time, phase by
phase, on one card (the machine has no ``ncu``).

Copies ``csrc/sumtree.cu`` and ``csrc/actor_moe.cu`` into the git-ignored
``experiments/dse/kernel_phases/``, inserts ``clock64()`` marks that thread
0 of each block writes into a ``__device__`` array at the boundaries of the
kernels' phases (the marks are anchored on the sources' own comments and
statements, so an edited source fails here loudly), builds the copies with
the repository's ``nvcc`` flags and runs them at the search's shapes.
Prints, per shape, the SM cycles of each phase: for ``sumtree`` the one
block's, for ``actor_moe`` the median and the maximum over the blocks.

    python3 scripts/kernel_phases.py
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.core import sac  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.actor_moe import _flat_params  # noqa: E402

OUT = ROOT / "experiments" / "dse" / "kernel_phases"
MARKS = 16   # marks per block

# (anchor, mark, after): the mark goes right after the anchor, or before it
SUMTREE = (
    ("sumtree", ("sort", "compact", "stage siblings", "level loop", "top")),
    [("  const K kcap = static_cast<K>(cap);\n", 0, True),
     ("  // (3) the last of each run", 1, False),
     ("  // (4) the winner at f writes", 2, False),
     ("  cp_async_wait_all();\n\n", 3, True),
     ("  // (5) nodes 1..31", 4, False),
     ("          if (touched) tree[(1 << l) + lane] = x;\n        }\n"
      "      }\n    }\n  }\n", 5, True)])
ACTOR = (
    ("actor_moe", ("start copies", "wait W1", "layer 1", "wait W2 rows",
                   "layer 2", "partials to h2", "wait heads' rows", "heads",
                   "push heads", "wait pushed heads", "blend")),
    [("  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n", 0, True),
     ("  // 2. layer 1: units 4", 1, False),
     ("  mbar_wait(bars + BAR_IN);\n", 2, True),
     ("  // W1 is consumed: the heads' rows", 3, False),
     ("  mbar_wait(bars + BAR_W2 + warp);\n", 4, True),
     ("    __syncwarp();   // the rows are consumed", 5, False),
     ("  // 4. heads: partial products", 6, False),
     ("    mbar_wait(bars + BAR_WH);\n", 7, True),
     ("  // the biases of this thread's blend outputs", 8, False),
     ("  // 5. blend rows rank", 9, False),
     ("  mbar_wait(bars + BAR_RECV);\n", 10, True),
     ("    if (grow < B) gate[grow * E + t % E] = gs[t];\n  }\n", 11, True)])


def instrument(name: str, anchors) -> Path:
    src = (build.CSRC / f"{name}.cu").read_text()
    head = (f"__device__ long long g_marks_{name}[65536 * {MARKS}];\n"
            f"#define MARK(i) do {{ if (threadIdx.x == 0) g_marks_{name}"
            f"[blockIdx.x * {MARKS} + (i)] = clock64(); }} while (0)\n"
            f'extern "C" int read_marks_{name}(long long* h, int n) {{ '
            f"return (int)cudaMemcpyFromSymbol(h, g_marks_{name}, "
            f"n * sizeof(long long)); }}\n")
    src = src.replace("namespace {", head + "namespace {", 1)
    for anchor, i, after in anchors:
        if src.count(anchor) != 1:
            sys.exit(f"{name}.cu: anchor for mark {i} not found once: "
                     f"{anchor!r}")
        src = src.replace(anchor, anchor + f"  MARK({i});\n" if after
                          else f"  MARK({i});\n" + anchor)
    path = OUT / f"{name}.cu"
    path.write_text(src)
    return path


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for (name, _), anchors in (SUMTREE, ACTOR):
        src = instrument(name, anchors)
        obj = OUT / f"{name}.o"
        objs.append(str(obj))
        procs.append(subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-c",
                                       str(src), "-o", str(obj)]))
    if any(p.wait() != 0 for p in procs):
        sys.exit("nvcc failed")
    lib_path = OUT / "libkernel_phases.so"
    subprocess.check_call([build.nvcc(), *build.NVCC_FLAGS[:2], "-shared",
                           "-o", str(lib_path), *objs])
    lib = ctypes.CDLL(str(lib_path))
    for name in ("sumtree_set_many", "actor_moe_forward"):
        getattr(lib, name).argtypes = build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def marks(name, blocks, n):
        h = np.zeros(blocks * MARKS, np.int64)
        reader = getattr(lib, f"read_marks_{name}")
        reader.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if reader(h.ctypes.data, h.size) != 0:
            sys.exit("cudaMemcpyFromSymbol failed")
        return np.diff(h.reshape(blocks, MARKS)[:, :n + 1], axis=1)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cap = 100_000
    tree = torch.as_tensor(np.random.default_rng(1).random(2 * cap),
                           device=dev)
    labels = SUMTREE[0][1]
    for shape, idx, scalar in (
            ("N=64 random", np.random.default_rng(64).integers(0, cap, 64),
             False),
            ("N=448 random", np.random.default_rng(448).integers(0, cap, 448),
             False),
            ("N=64 insert", (cap - 17 + np.arange(64)) % cap, True),
            ("N=448 insert", (cap - 17 + np.arange(448)) % cap, True)):
        i = torch.as_tensor(idx, device=dev)
        v = torch.rand(len(idx), device=dev, dtype=torch.float64)
        for _ in range(5):   # the last call's marks are read
            build.check(lib.sumtree_set_many(
                tree.data_ptr(), i.data_ptr(), None if scalar
                else v.data_ptr(), 0.5, len(idx), cap, stream), "sumtree")
        torch.cuda.synchronize()
        d = marks("sumtree", 1, len(labels))[0]
        print(f"sumtree {shape}: total {int(d.sum())} cycles; " + ", ".join(
            f"{lab} {int(c)}" for lab, c in zip(labels, d)))
    actor = sac.create(0, dev).params.actor
    weights = _flat_params(actor)
    labels = ACTOR[0][1]
    for b in (64, 448):
        s = torch.randn((b, 52), device=dev)
        outs = [torch.empty((b, n), device=dev) for n in (20, 30, 30, 4)]
        for _ in range(5):
            build.check(lib.actor_moe_forward(
                s.data_ptr(), *(w.data_ptr() for w in weights),
                *(o.data_ptr() for o in outs), b, stream), "actor_moe")
        torch.cuda.synchronize()
        blocks = -(-b // (8 if b <= 128 else 16)) * 8
        d = marks("actor_moe", blocks, len(labels))
        med, mx = np.median(d, axis=0), d.max(axis=0)
        print(f"actor_moe B={b} ({blocks} blocks): median total "
              f"{int(np.median(d.sum(axis=1)))} cycles; " + ", ".join(
                  f"{lab} {int(m)} (max {int(x)})" for lab, m, x in
                  zip(labels, med, mx)))


if __name__ == "__main__":
    main()
