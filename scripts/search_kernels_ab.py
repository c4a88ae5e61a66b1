#!/usr/bin/env python3
"""Check and time the port's CUDA kernels of several source trees on one card.

Each run is a fresh process that imports ``repro_torch`` from one tree (a
checkout of the repository, for example the parent commit unpacked with
``git archive`` into a git-ignored directory), builds its kernels (with
``-D`` defines where the run names them, into a library of their own),
holds the chosen kernels (``--kernels``) against their plain versions and
times them with ``chip_smoke.py``'s harness: 200 calls replayed from a CUDA
graph between CUDA events, beside an empty kernel's launch in the same
harness.  The kernels, their checks and their timed shapes:

- ``sumtree``: bitwise against the plain version and the host ``SumTree``
  at caps 1 to 100,000 and N 1 to 1,025; random N = 64, 256, 448 and
  contiguous scalar inserts of 64 and 448 at cap 100,000;
- ``actor_moe``: rtol 1e-4 / atol 1e-5 at B 1 to 4,096 and a bitwise
  repeat; B = 64, 192, 448 and 4,096;
- ``fused_mlp``: fp32 at rtol 1e-4 / atol 1e-5 and bf16 input at 3e-2, at
  B 1 to 28,672 (each side of the 16-row tile and of the launch's switch
  from 1 to 2 to 4 groups a CTA on 132 SMs), one launch a call and a
  bitwise repeat, and the SHA-256 of its outputs at the three paths'
  shapes (equal in two trees: bitwise equal); [448,82]->3 in fp32 and
  bf16, [4096,82]->52 and [28672,82]->52 in fp32;
- ``ssm_scan``: rtol/atol 1e-4 on y and the final state, with and without
  h0, at S 1 to 2,048 (each side of the 16-step stage), ragged D and N <
  16, one launch a call and a bitwise repeat; Jamba's [4,512,8192] N = 16;
- ``sumtree_sample``: bitwise against the plain version and the host
  ``SumTree`` walk, one launch a call, at caps 2^k (k = 1 to 20: every
  depth, so every length of a last partial round), 1, 257, 100,000 and
  200,000 with zero leaves, N each side of the warp and the block; N = 256
  and 448 at cap 100,000, 448 at 200,000;
- ``flash_attention_fp32``: max abs err under 2e-5 against the plain
  version, one launch a call and a bitwise repeat, over ``chip_smoke.py``'s
  cases, the LM prefill's shape, sequence 2,048, unaligned and transposed
  views and hd 32, 64, 80 and 128; q [4,32,512,128] and [1,32,2048,128]
  causal in fp32, and the first in fp16 (the fp16/bf16 kernel shares the
  softmax and mask code);
- ``screen_score``: rtol 1e-4 / atol 1e-5 against the plain version, one
  launch a call and a bitwise repeat, at (B, K) from (1, 1) to (448, 8)
  (K not dividing the 16-row tile, B.K not a multiple of 16; s and cand
  also one float off their 16- and 8-byte boundaries), and the
  picks of ``screen_batch`` with half the gates open equal to the plain
  picks wherever the two best plain scores of an env differ by more than
  the tolerance (the rows compared are counted); B = 64, K = 4 (the
  search's), B = 448, K = 4 (a campaign batch) and B = 64, K = 8.

One JSON line per run; runs go in the order given, so that two trees
alternate on one card.

    python3 scripts/search_kernels_ab.py --tree P=experiments/dse/parent \\
        --tree C=. --runs P C C:ACTOR_TB=8 C:ACTOR_TB=16 C P
    python3 scripts/search_kernels_ab.py --kernels fused_mlp ssm_scan \\
        --tree P=experiments/dse/parent --tree C=. --runs P C C P
    python3 scripts/search_kernels_ab.py --kernels sumtree_sample \\
        flash_attention_fp32 --tree P=experiments/dse/parent --tree C=. \\
        --runs P C C P
    python3 scripts/search_kernels_ab.py --kernels screen_score fused_mlp \\
        --tree P=experiments/dse/parent --tree C=. --runs P C C P
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import hashlib, json, os, sys
import numpy as np, torch
tree_dir, root = sys.argv[1], sys.argv[2]
defines, kernels = json.loads(sys.argv[3]), json.loads(sys.argv[4])
sys.path.insert(0, os.path.join(tree_dir, "src"))
sys.path.insert(0, root)
import chip_smoke as cs
from repro_torch.core import replay, sac
from repro_torch.kernels import (actor_moe, build, flash_attention,
                                  policy_mlp, screen_score, ssm_scan,
                                  sumtree, sumtree_sample)
from repro_torch.ppa import surrogate

dev = torch.device("cuda")
lib = build.build(verbose=True, defines=defines)
build._lib = build.load(lib)
# -Xptxas -v of the chosen kernels' sources (empty when the library was
# already built)
srcs = {"sumtree": "sumtree.cu", "actor_moe": "actor_moe.cu",
        "fused_mlp": "policy_mlp.cu", "ssm_scan": "ssm_scan.cu",
        "sumtree_sample": "sumtree_sample.cu",
        "flash_attention_fp32": "flash_attention.cu",
        "screen_score": "screen_score.cu"}
ptxas = [sec for sec in build.last_build_log.split("== ")
         if sec.startswith(tuple("nvcc " + srcs[k] for k in kernels))]
out = dict(tree=tree_dir, defines=defines, lib=lib.name)
gen = torch.Generator(device=dev).manual_seed(0)
t = {}   # times (us), device time per call from 20 calls x 10 replays


def once_repeatable(name, module, call, want, rtol, atol):
    # one launch a call, the plain version's values, bitwise repeat;
    # returns the max abs error
    before = module.launches
    with torch.no_grad():
        got, again = call(), call()
        torch.cuda.synchronize()
        want = want()
    if module.launches - before != 2:
        sys.exit(f"{name}: not one launch per call")
    got, again, want = ((v,) if torch.is_tensor(v) else v
                        for v in (got, again, want))
    worst = 0.0
    for g, a, w in zip(got, again, want):
        worst = max(worst, float((g.float() - w.float()).abs().max()))
        if not (g.dtype == w.dtype and torch.allclose(
                g.float(), w.float(), rtol=rtol, atol=atol)
                and torch.equal(g, a)):
            sys.exit(f"{name}: disagrees with the plain version (max abs "
                     f"err {worst:.3e}) or with itself")
    return worst


if "sumtree" in kernels:
    # sumtree bitwise against the plain version and the host SumTree
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
                        sys.exit(f"sumtree cap {cap} N {n} {kind} array "
                                 f"{arr}: not bitwise the host SumTree / "
                                 "plain version")
                    cases += 1
    out["sumtree_cases_bitwise"] = cases
    cap = 100_000
    tree = torch.as_tensor(np.random.default_rng(1).random(2 * cap),
                           device=dev)
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

if "actor_moe" in kernels:
    actor = sac.create(0, dev).params.actor
    out["actor_max_abs_err"] = max(
        once_repeatable(f"actor_moe B={b}", actor_moe,
                        lambda: actor_moe.actor_forward_cuda(actor, s),
                        lambda: actor_moe.actor_forward_plain(actor, s),
                        1e-4, 1e-5)
        for b in (1, 7, 8, 9, 33, 64, 192, 448, 4096)
        for s in [torch.randn((b, 52), generator=gen, device=dev)])
    for b in (64, 192, 448, 4096):
        s = torch.randn((b, 52), generator=gen, device=dev)
        t[f"actor_B{b}"] = 1e3 * cs.device_ms(
            lambda: actor_moe.actor_forward_cuda(actor, s))

if "fused_mlp" in kernels:
    mlp_ws = {d: [torch.randn(shape, generator=gen, device=dev) * 0.1
                  for shape in ((82, 128), (128,), (128, 64), (64,),
                                (64, d), (d,))] for d in (3, 52)}
    worst = 0.0
    # each side of the 16-row tile and of the switch from 1 to 2 to 4
    # groups a CTA (132 and 264 tiles), and the paths' shapes
    for b, d in ((1, 3), (15, 3), (16, 3), (17, 3), (448, 3), (33, 52),
                 (2112, 52), (2113, 52), (4096, 52), (4224, 52), (4225, 52),
                 (28672, 52)):
        for dtype, rtol, atol in ((torch.float32, 1e-4, 1e-5),
                                  (torch.bfloat16, 3e-2, 3e-2)):
            x = torch.randn((b, 82), generator=gen, device=dev).to(dtype)
            err = once_repeatable(
                f"fused_mlp [{b},82]->{d} {dtype}", policy_mlp,
                lambda: policy_mlp.fused_mlp_cuda(x, *mlp_ws[d]),
                lambda: policy_mlp.fused_mlp_plain(x, *mlp_ws[d]), rtol,
                atol)
            if dtype == torch.float32:
                worst = max(worst, err)
    out["fused_mlp_max_abs_err"] = worst
    # the outputs' digests at the paths' shapes, from inputs of their own
    # generator: equal digests in two trees are bitwise equal outputs
    dgen = torch.Generator(device=dev).manual_seed(1)
    digests = {}
    for b, d in ((448, 3), (4096, 52), (28672, 52)):
        ws = [torch.randn(shape, generator=dgen, device=dev) * 0.1
              for shape in ((82, 128), (128,), (128, 64), (64,), (64, d),
                            (d,))]
        x = torch.randn((b, 82), generator=dgen, device=dev)
        with torch.no_grad():
            y = policy_mlp.fused_mlp_cuda(x, *ws).cpu().numpy()
        digests[f"[{b},82]->{d}"] = hashlib.sha256(y.tobytes()).hexdigest()
    out["fused_mlp_sha256"] = digests
    for b, d, dtype in ((448, 3, torch.float32), (448, 3, torch.bfloat16),
                        (4096, 52, torch.float32),
                        (28672, 52, torch.float32)):
        x = torch.randn((b, 82), generator=gen, device=dev).to(dtype)
        t[f"fused_mlp_B{b}_{d}_{str(dtype)[6:]}"] = 1e3 * cs.device_ms(
            lambda: policy_mlp.fused_mlp_cuda(x, *mlp_ws[d]))

if "ssm_scan" in kernels:
    def ssm_inputs(B, S, D, N):
        return (torch.rand((B, S, D), generator=gen, device=dev) * 0.1
                + 1e-3,
                torch.randn((B, S, N), generator=gen, device=dev),
                torch.randn((B, S, N), generator=gen, device=dev),
                torch.randn((B, S, D), generator=gen, device=dev),
                -torch.exp(0.5 * torch.randn((D, N), generator=gen,
                                             device=dev)))
    worst = 0.0
    for B, S, D, N in ((4, 512, 8192, 16), (2, 33, 200, 16), (3, 1, 8, 5),
                       (1, 200, 40, 8), (1, 2048, 128, 16), (2, 31, 64, 4),
                       (2, 32, 64, 16), (2, 64, 65, 16), (1, 65, 130, 13)):
        ins = ssm_inputs(B, S, D, N)
        for h0 in (None, torch.randn((B, D, N), generator=gen, device=dev)):
            worst = max(worst, once_repeatable(
                f"ssm_scan {(B, S, D, N)} h0={h0 is not None}", ssm_scan,
                lambda: ssm_scan.ssm_scan_cuda(*ins, h0),
                lambda: ssm_scan.ssm_scan_plain(*ins, h0), 1e-4, 1e-4))
    out["ssm_scan_max_abs_err"] = worst
    ins = ssm_inputs(4, 512, 8192, 16)
    t["ssm_scan_4x512x8192"] = 1e3 * cs.device_ms(
        lambda: ssm_scan.ssm_scan_cuda(*ins))

if "sumtree_sample" in kernels:
    rng = np.random.default_rng(0)
    cases = 0
    for cap in [1, 257, 100_000, 200_000] + [2 ** e for e in range(1, 21)]:
        host = replay.SumTree(cap)
        host.set_many(np.arange(cap),
                      rng.integers(0, 4, cap).astype(np.float64))
        tree_d = torch.as_tensor(host.tree, device=dev)
        for n in (1, 3, 4, 5, 31, 32, 33, 127, 128, 129, 256, 448):
            u = rng.random(n)
            size = max(1, cap // 2) if n % 2 else cap
            u_d = torch.as_tensor(u, device=dev)
            before = sumtree_sample.launches
            got = sumtree_sample.sumtree_sample_cuda(tree_d, u_d, size)
            again = sumtree_sample.sumtree_sample_cuda(tree_d, u_d, size)
            got, again = got.cpu(), again.cpu()
            want = sumtree_sample.sumtree_sample_plain(
                torch.as_tensor(host.tree), torch.as_tensor(u), size)
            walk = np.minimum([host.sample(float(x)) for x in
                               (np.arange(n) + u) * (host.total() / n)],
                              size - 1)
            if not (torch.equal(got, want) and torch.equal(got, again)
                    and np.array_equal(got.numpy(), walk)
                    and sumtree_sample.launches - before == 2):
                sys.exit(f"sumtree_sample cap {cap} N {n}: not bitwise the "
                         "plain version / host walk, or not one launch")
            cases += 1
    out["sumtree_sample_cases_bitwise"] = cases
    for cap, n in ((100_000, 256), (100_000, 448), (200_000, 448)):
        tree = torch.as_tensor(np.random.default_rng(1).random(2 * cap),
                               device=dev)
        u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
        t[f"sumtree_sample_N{n}_cap{cap}"] = 1e3 * cs.device_ms(
            lambda: sumtree_sample.sumtree_sample_cuda(tree, u, cap))

if "flash_attention_fp32" in kernels:
    errs = {}
    cases = [(c, "contiguous") for c in cs.ATTN_CASES + [cs.ATTN_LM,
                                                         cs.ATTN_2048]]
    cases += [((2, 8, 2, 150, 150, 64, True, 0), "unaligned"),
              ((2, 8, 2, 50, 50, 64, True, 0), "transposed")]
    cases += [((1, 8, 2, 333, 333, hd, True, 0), "contiguous")
              for hd in (32, 64, 80, 128)]
    for (B, H, Hk, Sq, Sk, hd, causal, window), layout in cases:
        if layout == "transposed":   # [B,S,H,hd] projections, as the LM's
            q = torch.randn((B, Sq, H, hd), generator=gen,
                            device=dev).transpose(1, 2)
            kv = torch.randn((B, Sk, 2, Hk, hd), generator=gen, device=dev)
            k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        else:
            pad = int(layout == "unaligned")
            q, k, v = (torch.randn((B, n, S, hd + 2 * pad), generator=gen,
                                   device=dev)[..., pad:pad + hd]
                       for n, S in ((H, Sq), (Hk, Sk), (Hk, Sk)))
        label = f"{(B, H, Hk, Sq, Sk, hd, causal, window)} {layout}"
        errs[label] = once_repeatable(
            f"flash_attention fp32 {label}", flash_attention,
            lambda: flash_attention.flash_attention_cuda(
                q, k, v, causal=causal, window=window),
            lambda: flash_attention.flash_attention_plain(
                q, k, v, causal=causal, window=window), 0.0, 2e-5)
    out["flash_attention_fp32_max_abs_err"] = max(errs.values())
    out["flash_attention_fp32_errs"] = errs
    for label, shape, dtype in (("LM", cs.ATTN_LM, torch.float32),
                                ("2048", cs.ATTN_2048, torch.float32),
                                ("LM_fp16", cs.ATTN_LM, torch.float16)):
        B, H, Hk, Sq, Sk, hd, causal, window = shape
        q = torch.randn((B, H, Sq, hd), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((B, Hk, Sk, hd), generator=gen,
                            device=dev).to(dtype) for _ in "kv")
        t[f"flash_attention_{label}"] = 1e3 * cs.device_ms(
            lambda: flash_attention.flash_attention_cuda(q, k, v))

if "screen_score" in kernels:
    sur = surrogate.Surrogate.create(82, seed=2, device=dev).params

    def screen_inputs(b, k, off=0):
        # off = 1: s and cand one float off their 16- and 8-byte boundaries
        return (torch.randn(b * 52 + off, generator=gen,
                            device=dev)[off:].view(b, 52),
                (torch.rand(b * k * 30 + off, generator=gen, device=dev) * 2
                 - 1)[off:].view(b, k, 30),
                torch.softmax(torch.randn((b, 3), generator=gen,
                                          device=dev), -1))
    worst, compared = 0.0, 0
    for b, k, off in ((1, 1, 0), (3, 3, 0), (5, 1, 0), (5, 7, 0), (7, 8, 0),
                      (8, 4, 0), (33, 4, 0), (33, 6, 0), (64, 4, 0),
                      (64, 8, 0), (448, 4, 0), (448, 8, 0), (1000, 5, 0),
                      (3, 3, 1), (64, 4, 1), (33, 6, 1)):
        ins = screen_inputs(b, k, off)
        worst = max(worst, once_repeatable(
            f"screen_score B={b} K={k} offset {off}", screen_score,
            lambda: screen_score.screen_scores_cuda(sur, *ins),
            lambda: screen_score.screen_scores_plain(sur, *ins), 1e-4, 1e-5))
        # the picks, half the gates open, where the plain scores' two best
        # differ by more than the tolerance
        mask = torch.rand(b, generator=gen, device=dev) < 0.5
        got = surrogate.screen_batch(sur, *ins, mask)
        with torch.no_grad():
            plain = screen_score.screen_scores_plain(sur, *ins)
        want = torch.where(mask, plain.argmin(1), torch.zeros_like(got))
        two = plain.topk(min(k, 2), dim=1, largest=False).values
        apart = (two[:, -1] - two[:, 0] > 1e-5 + 1e-4 * two[:, 0].abs()) \
            if k > 1 else torch.ones_like(mask)
        if not torch.equal(got[apart], want[apart]):
            sys.exit(f"screen_score B={b} K={k}: picks differ from the "
                     "plain picks on well-separated envs")
        compared += int(apart.sum())
    out["screen_score_max_abs_err"] = worst
    out["screen_score_picks_compared"] = compared
    for b, k in ((64, 4), (448, 4), (64, 8)):
        ins = screen_inputs(b, k)
        t[f"screen_score_B{b}_K{k}"] = 1e3 * cs.device_ms(
            lambda: screen_score.screen_scores_cuda(sur, *ins))

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
    ap.add_argument("--kernels", nargs="+", default=["sumtree", "actor_moe"],
                    choices=["sumtree", "actor_moe", "fused_mlp",
                             "ssm_scan", "sumtree_sample",
                             "flash_attention_fp32", "screen_score"])
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
             json.dumps(defines), json.dumps(a.kernels)],
            capture_output=True, text=True,
            timeout=900)
        if out.returncode != 0:
            sys.exit(f"run {i} ({run}) failed:\n{out.stdout[-2000:]}\n"
                     f"{out.stderr[-4000:]}")
        print(json.dumps(dict(run=i, label=run, **json.loads(
            out.stdout.strip().splitlines()[-1]))), flush=True)


if __name__ == "__main__":
    main()
