#!/usr/bin/env python3
"""Check and time the search path's ``sumtree`` and ``actor_moe`` kernels of
several source trees on one card.

Each run is a fresh process that imports ``repro_torch`` from one tree (a
checkout of the repository, for example the parent commit unpacked with
``git archive`` into a git-ignored directory), builds its kernels (with
``-D`` defines where the run names them, into a library of their own),
holds both kernels against their plain versions (``sumtree`` bitwise at caps
1 to 100,000 and N 1 to 1,025; ``actor_moe`` at rtol 1e-4 / atol 1e-5 at B 1
to 4,096, and a bitwise repeat) and times them with ``chip_smoke.py``'s
harness: 200 calls replayed from a CUDA graph between CUDA events, at the
shapes the search issues (``sumtree``: random N = 64, 256, 448 and
contiguous scalar inserts of 64 and 448 at cap 100,000; ``actor_moe``: B =
64, 192, 448 and 4,096), beside an empty kernel's launch in the same
harness.  One JSON line per run; runs go in the order given, so that two
trees alternate on one card.

    python3 scripts/search_kernels_ab.py --tree P=experiments/dse/parent \\
        --tree C=. --runs P C C:ACTOR_TB=8 C:ACTOR_TB=16 C P
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import json, os, sys
import numpy as np, torch
tree_dir, root, defines = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, os.path.join(tree_dir, "src"))
sys.path.insert(0, root)
import chip_smoke as cs
from repro_torch.core import replay, sac
from repro_torch.kernels import actor_moe, build, sumtree

dev = torch.device("cuda")
lib = build.build(verbose=True, defines=defines)
build._lib = build.load(lib)
# -Xptxas -v of the two sources (empty when the library was already built)
ptxas = [sec for sec in build.last_build_log.split("== ")
         if sec.startswith(("nvcc sumtree.cu", "nvcc actor_moe.cu"))]
out = dict(tree=tree_dir, defines=defines, lib=lib.name)

# parity: sumtree bitwise against the plain version and the host SumTree
rng = np.random.default_rng(0)
cases = 0
for cap in (1, 8, 100, 257, 100_000):
    base = rng.random(2 * cap)
    for n in (1, 31, 32, 33, 448, 1024, 1025):
        for kind in ("random", "one index", "ends"):
            idx = rng.integers(0, cap, n)
            if kind == "one index":
                idx[:] = idx[0]
            elif kind == "ends" and n >= 4:
                idx[-1], idx[-2] = idx.min(), idx.max()
                idx[n // 2] = cap
            for vals in (rng.random(n), 0.25):
                arr = np.ndim(vals) > 0
                host = replay.SumTree(cap)
                host.tree = base.copy()
                keep = (idx >= 0) & (idx < cap)
                host.set_many(idx[keep], vals[keep] if arr else vals)
                got = torch.as_tensor(base, device=dev)
                before = sumtree.launches
                sumtree.sumtree_set_many_cuda(
                    got, torch.as_tensor(idx, device=dev),
                    torch.as_tensor(vals, device=dev) if arr else vals)
                want = torch.as_tensor(base.copy())   # in range only
                sumtree.sumtree_set_many_plain(
                    want, torch.as_tensor(idx[keep]),
                    torch.as_tensor(vals[keep]) if arr else vals)
                got = got.cpu().numpy()
                if not (np.array_equal(got, host.tree)
                        and np.array_equal(got, want.numpy())
                        and sumtree.launches - before == -(-n // 1024)):
                    sys.exit(f"sumtree cap {cap} N {n} {kind} array {arr}: "
                             "not bitwise the host SumTree / plain version")
                cases += 1
out["sumtree_cases_bitwise"] = cases

# parity: actor_moe against the plain version, one launch, bitwise repeat
actor = sac.create(0, dev).params.actor
gen = torch.Generator(device=dev).manual_seed(0)
worst = 0.0
for b in (1, 7, 8, 9, 33, 64, 192, 448, 4096):
    s = torch.randn((b, 52), generator=gen, device=dev)
    before = actor_moe.launches
    got = actor_moe.actor_forward_cuda(actor, s)
    again = actor_moe.actor_forward_cuda(actor, s)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = actor_moe.actor_forward_plain(actor, s)
    for g, a, w in zip(got, again, want):
        worst = max(worst, float((g - w).abs().max()))
        if not (torch.allclose(g, w, rtol=1e-4, atol=1e-5)
                and torch.equal(g, a)):
            sys.exit(f"actor_moe B={b}: disagrees with the plain version "
                     "or with itself")
    if actor_moe.launches - before != 2:
        sys.exit(f"actor_moe B={b}: not one launch per call")
out["actor_max_abs_err"] = worst

# times (us), device time per call from a graph of 20 calls x 10 replays
t = {}
cap = 100_000
tree = torch.as_tensor(np.random.default_rng(1).random(2 * cap), device=dev)
for n in (64, 256, 448):
    idx = torch.as_tensor(np.random.default_rng(n).integers(0, cap, n),
                          device=dev)
    vals = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
    t[f"sumtree_N{n}"] = 1e3 * cs.device_ms(
        lambda: sumtree.sumtree_set_many_cuda(tree, idx, vals))
for n in (64, 448):
    idx = torch.as_tensor((cap - 17 + np.arange(n)) % cap, device=dev)
    t[f"sumtree_insert{n}"] = 1e3 * cs.device_ms(
        lambda: sumtree.sumtree_set_many_cuda(tree, idx, 0.5))
for b in (64, 192, 448, 4096):
    s = torch.randn((b, 52), generator=gen, device=dev)
    t[f"actor_B{b}"] = 1e3 * cs.device_ms(
        lambda: actor_moe.actor_forward_cuda(actor, s))
proc, floor_lib = cs.start_floor_build(
    build.nvcc(), build.NVCC_FLAGS, os.path.join(root, "experiments", "dse",
                                                 "search_kernels_ab"))
t["launch_floor"] = 1e3 * cs.device_ms(cs.load_floor(proc, floor_lib))
out["us"] = t
out["ptxas"] = ptxas
print(json.dumps(out))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    metavar="LABEL=PATH")
    ap.add_argument("--runs", nargs="+", required=True,
                    metavar="LABEL[:NAME=VALUE,...]")
    a = ap.parse_args()
    trees = dict(t.split("=", 1) for t in a.tree)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    for i, run in enumerate(a.runs):
        label, _, defs = run.partition(":")
        defines = [d for d in defs.split(",") if d]
        out = subprocess.run(
            [sys.executable, "-c", RUN, os.path.abspath(trees[label]), ROOT,
             json.dumps(defines)], capture_output=True, text=True,
            timeout=900)
        if out.returncode != 0:
            sys.exit(f"run {i} ({run}) failed:\n{out.stdout[-2000:]}\n"
                     f"{out.stderr[-4000:]}")
        print(json.dumps(dict(run=i, label=run, **json.loads(
            out.stdout.strip().splitlines()[-1]))), flush=True)


if __name__ == "__main__":
    main()
