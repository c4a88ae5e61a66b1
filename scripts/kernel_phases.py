#!/usr/bin/env python3
"""Where the ``sumtree``, ``actor_moe``, ``fused_mlp``, ``ssm_scan``,
``sumtree_sample``, fp32 ``flash_attention`` and ``screen_score`` kernels
spend their time, phase by phase, on one card (the machine has no ``ncu``).

Copies the kernels' sources (``csrc/sumtree.cu``, ``actor_moe.cu``,
``policy_mlp.cu``, ``ssm_scan.cu``, ``sumtree_sample.cu``,
``flash_attention.cu``, ``screen_score.cu``; the shared MLP body
``mlp_tf32.cuh`` spliced into the two that include it) into the
git-ignored ``experiments/dse/kernel_phases/``, inserts ``clock64()``
marks that thread 0 of each block writes into a ``__device__`` array at
the boundaries of the kernels' phases (the marks are anchored on the
sources' own comments and statements, so an edited source fails here
loudly), builds the copies with the repository's ``nvcc`` flags and runs
them at the paths' shapes.  Prints, per shape, the SM cycles of each
phase: for ``sumtree`` the one block's, for the others the median and the
maximum over the blocks (``fused_mlp`` and ``screen_score``: the block's
first tile, then all its tiles; ``ssm_scan``: the loop's cycles summed
over its stages as copy and wait, compute and the closing barrier;
``sumtree_sample``: warp 0's sample, its first round trip and each round;
fp32 ``flash_attention``: warp 0's prologue, its tile loop summed as copy
wait and barrier, S = Q K^T, softmax and P V, and the epilogue), and the
SM clock ``nvidia-smi`` reads after the runs.

    python3 scripts/kernel_phases.py [--kernels sumtree actor_moe ...]
"""
from __future__ import annotations

import argparse
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
from repro_torch.kernels import screen_score  # noqa: E402
from repro_torch.kernels.policy_mlp import fused_mlp_cuda  # noqa: E402
from repro_torch.ppa import surrogate  # noqa: E402

OUT = ROOT / "experiments" / "dse" / "kernel_phases"
MARKS = 16   # marks per block

# (anchor, mark, after): the mark goes right after the anchor, or before
# it; a mark is the index of a timestamp or a line of code
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
FIRST = "  if (tile == (int)blockIdx.x * G) MARK({});\n"   # the first tile's
# fused_mlp and screen_score: the tile loop of mlp_tf32.cuh, which both
# include (spliced into each copy)
BODY = [("  int tile = blockIdx.x * G + grp;\n", 0, True),
        ("  float w3f[ntw<COLW>()][2];", 1, False),
        ("  __syncthreads();   // the mbarriers are initialised before any "
         "arrival\n", 2, False),
        ("  __syncthreads();   // the mbarriers are initialised before any "
         "arrival\n", 3, True),
        ("                   smem_addr(bars + 2)) : \"memory\");\n", 4, True),
        ("    group_sync<GROUP>(grp);   // this tile's x has landed",
         FIRST.format(5), False),
        ("    mbar_wait(bars);\n", FIRST.format(6), True),
        ("    mbar_wait(bars + 2);\n", FIRST.format(7), True),
        ("    hidden_out<COLW>(acc, sb1, c, nt1, hs1, L.sh1);\n"
         "    group_sync<GROUP>(grp);\n", FIRST.format(8), True),
        ("    mbar_wait(bars + 1);\n", FIRST.format(9), True),
        ("    hidden_out<COLW>(acc, sb2, c, nt2, hs2, L.sh2);\n"
         "    group_sync<GROUP>(grp);\n", FIRST.format(10), True),
        ("    rows.template store<COLW>(acc, tile, c, nt3, sb3, pro);\n",
         FIRST.format(11), True),
        ("  }\n  // a group without tiles still has copies", 12, False)]
ENTRY = ("thread 0: TMA issue", "(W3 loads and) x copies issued",
         "block barrier", "W3 / bias copies issued", "x of tile", "wait W1",
         "layer 1 mma", "GELU 1 + barrier", "wait W2", "layer 2")
MLP = (("fused_mlp", ENTRY + ("layer 3 + stores", "other tiles")), BODY)
SCREEN = (("screen_score", ENTRY + ("layer 3 + score", "other tiles")), BODY)
# ssm_scan: timestamps 0-3 and, in slots 4-6, the loop's cycles summed over
# its stages
SSM = (
    ("ssm_scan", ("A and h0", "loop", "final state")),
    [("  const int chunks = (S + TCH - 1) / TCH;\n", 0, True),
     ("    h[i] = (on && h0 != nullptr) ? h0[((long long)b * D + d) * N + n]"
      " : 0.0f;\n  }\n", 1, True),
     ("  for (int c = 0; c < chunks; ++c) {\n",
      "  long long cyc_copy = 0, cyc_comp = 0, cyc_sync = 0;\n", False),
     ("  for (int c = 0; c < chunks; ++c) {\n",
      "    long long t0_ = clock64();\n", True),
     ("    __syncthreads();   // every thread's copies of chunk c have landed\n",
      "    long long t1_ = clock64(); cyc_copy += t1_ - t0_;\n", True),
     ("    __syncthreads();   // this stage is read before chunk c + 2",
      "    long long t2_ = clock64(); cyc_comp += t2_ - t1_;\n", False),
     ("    __syncthreads();   // this stage is read before chunk c + 2 lands"
      " in it\n", "    cyc_sync += clock64() - t2_;\n", True),
     ("  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");   // S = 0",
      "  MARK(2);\n  if (threadIdx.x == 0) { long long* m_ = "
      "g_marks_ssm_scan + BLOCK * 16;\n    m_[4] = cyc_copy; m_[5] = cyc_comp;"
      " m_[6] = cyc_sync; }\n", False),
     ("      if (n < N) h_out[((long long)b * D + d) * N + n] = h[i];\n"
      "    }\n  }\n", 3, True)])


# sumtree_sample: the root, the uniform and the first round's nodes, then
# a mark after each round's walk, ballot and shuffles (3 rounds of 6
# levels at cap 100,000)
SAMPLE = (
    ("sumtree_sample", ("root, u, first gather", "round 1", "round 2",
                        "round 3")),
    [("  const long long two_cap = 2 * cap;\n", 0, True),
     ("  long long i = 1;\n", "  MARK(1);\n  int round_ = 0;\n", True),
     ("    i = __shfl_sync(FULL, at, src);\n",
      "    MARK(2 + round_);\n    ++round_;\n", True)])
# flash_attention fp32: timestamps 0-1 (prologue) and 2-3 (epilogue), the
# tile loop's cycles summed in slots 4-7
FLASH = (
    ("flash_attention", ("prologue", "epilogue")),
    [("  const float* qf = sq + (warp * 16 + g) * Ly::LQK + 2 * t;\n",
      "  MARK(1);\n  long long cyc_[4] = {0, 0, 0, 0};\n", True),
     ("  load_tile<BQ, HDP, Ly::LQK>(sq, qb, qss, q0, Sq, hd, vec);\n", 0,
      False),
     ("    cp_async_wait<0>();   // tile it (and at first Q) has landed\n",
      "    long long t0_ = clock64();\n", False),
     ("    load_kv(it + 1);      // into the stage tile it - 1 used\n",
      "    long long t1_ = clock64(); cyc_[0] += t1_ - t0_;\n", True),
     ("    base2_scores(s, kt, wq0, Sk, causal, window, sl2);\n"
      "    online_softmax(s, m, l, acc);\n\n    // acc += P V, 8 keys",
      "    long long t2_ = clock64(); cyc_[1] += t2_ - t1_;\n", False),
     ("\n    // acc += P V, 8 keys a step.",
      "\n    long long t3_ = clock64(); cyc_[2] += t3_ - t2_;", False),
     ("  }\n  cp_async_wait<0>();   // no copy in flight at exit\n",
      "    cyc_[3] += clock64() - t3_;\n", False),
     ("  cp_async_wait<0>();   // no copy in flight at exit\n",
      "  MARK(2);\n  if (threadIdx.x == 0) for (int i_ = 0; i_ < 4; ++i_)\n"
      "    g_marks_flash_attention[BLOCK * 16 + 4 + i_] = cyc_[i_];\n", True),
     ("\n}\n\ntemplate <int HDP>\nint launch_hdp(", "\n  MARK(3);", False)])


SOURCES = {"sumtree": "sumtree", "actor_moe": "actor_moe",
           "fused_mlp": "policy_mlp", "ssm_scan": "ssm_scan",
           "sumtree_sample": "sumtree_sample",
           "flash_attention": "flash_attention",
           "screen_score": "screen_score"}


def instrument(name: str, anchors) -> Path:
    src = (build.CSRC / f"{SOURCES[name]}.cu").read_text()
    include = '#include "mlp_tf32.cuh"\n'
    if include in src:   # the shared MLP body, so that its anchors are found
        src = src.replace(include, (build.CSRC / "mlp_tf32.cuh").read_text()
                          .replace("#pragma once\n", ""), 1)
    head = (f"__device__ long long g_marks_{name}[65536 * {MARKS}];\n"
            "#define BLOCK (blockIdx.x + gridDim.x * blockIdx.y)\n"
            f"#define MARK(i) do {{ if (threadIdx.x == 0) g_marks_{name}"
            f"[BLOCK * {MARKS} + (i)] = clock64(); }} while (0)\n"
            f'extern "C" int read_marks_{name}(long long* h, int n) {{ '
            f"return (int)cudaMemcpyFromSymbol(h, g_marks_{name}, "
            f"n * sizeof(long long)); }}\n")
    src = src.replace("namespace {", head + "namespace {", 1)
    for anchor, i, after in anchors:
        if src.count(anchor) != 1:
            sys.exit(f"{name}.cu: anchor for mark {i!r} not found once: "
                     f"{anchor!r}")
        code = f"  MARK({i});\n" if isinstance(i, int) else i
        src = src.replace(anchor, anchor + code if after else code + anchor)
    path = OUT / f"{name}.cu"
    path.write_text(src)
    return path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="+", default=list(SOURCES),
                    choices=list(SOURCES))
    chosen = ap.parse_args().kernels
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for (name, _), anchors in (k for k in (SUMTREE, ACTOR, MLP, SSM, SAMPLE,
                                           FLASH, SCREEN)
                               if k[0][0] in chosen):
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
    for name in ("sumtree_set_many", "actor_moe_forward", "fused_mlp_forward",
                 "ssm_scan_forward", "sumtree_sample",
                 "flash_attention_forward", "screen_score_forward"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = build.SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def marks(name, blocks, n, raw=False):
        h = np.zeros(blocks * MARKS, np.int64)
        reader = getattr(lib, f"read_marks_{name}")
        reader.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if reader(h.ctypes.data, h.size) != 0:
            sys.exit("cudaMemcpyFromSymbol failed")
        h = h.reshape(blocks, MARKS)
        return h if raw else np.diff(h[:, :n + 1], axis=1)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if "sumtree" in chosen:
        sumtree_phases(lib, dev, stream, marks)
    if "actor_moe" in chosen:
        actor_phases(lib, dev, stream, marks)
    if "fused_mlp" in chosen:
        mlp_phases(lib, dev, stream, marks)
    if "ssm_scan" in chosen:
        ssm_phases(lib, dev, stream, marks)
    if "sumtree_sample" in chosen:
        sample_phases(lib, dev, stream, marks)
    if "flash_attention" in chosen:
        flash_phases(lib, dev, stream, marks)
    if "screen_score" in chosen:
        screen_phases(lib, dev, stream, marks)
    print("SM clock after the runs: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())


def summary(label, d, labels):
    med, mx = np.median(d, axis=0), d.max(axis=0)
    print(f"{label} ({len(d)} blocks): median total "
          f"{int(np.median(d.sum(axis=1)))} cycles; " + ", ".join(
              f"{lab} {int(m)} (max {int(x)})" for lab, m, x in
              zip(labels, med, mx)))


def sumtree_phases(lib, dev, stream, marks):
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


def actor_phases(lib, dev, stream, marks):
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
        summary(f"actor_moe B={b}", marks("actor_moe", blocks, len(labels)),
                labels)


def mlp_phases(lib, dev, stream, marks):
    labels = MLP[0][1]
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, d_out in ((448, 3), (4096, 52), (28672, 52)):
        ws = [torch.randn(s, generator=gen, device=dev) * 0.1
              for s in ((82, 128), (128,), (128, 64), (64,), (64, d_out),
                        (d_out,))]
        x = torch.randn((b, 82), generator=gen, device=dev)
        y = torch.empty((b, d_out), device=dev)
        for _ in range(5):
            build.check(lib.fused_mlp_forward(
                x.data_ptr(), *(w.data_ptr() for w in ws), y.data_ptr(), b,
                82, 128, 64, d_out, 0, stream), "fused_mlp")
        torch.cuda.synchronize()
        with torch.no_grad():
            torch.testing.assert_close(y, fused_mlp_cuda(x, *ws))
        tiles = -(-b // 16)
        groups = 1 if tiles <= sms else 2 if tiles <= 2 * sms else 4
        blocks = min(-(-tiles // groups), sms)
        summary(f"fused_mlp [{b},82]->{d_out} ({groups} groups a CTA)",
                marks("fused_mlp", blocks, len(labels)), labels)


def ssm_phases(lib, dev, stream, marks):
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, D, N = 4, 512, 8192, 16
    dt = torch.rand((B, S, D), generator=gen, device=dev) * 0.1 + 1e-3
    bc = [torch.randn((B, S, N), generator=gen, device=dev) for _ in "bc"]
    x = torch.randn((B, S, D), generator=gen, device=dev)
    a = -torch.exp(0.5 * torch.randn((D, N), generator=gen, device=dev))
    y = torch.empty_like(x)
    h = torch.empty((B, D, N), device=dev)
    for _ in range(5):
        build.check(lib.ssm_scan_forward(
            dt.data_ptr(), bc[0].data_ptr(), bc[1].data_ptr(), x.data_ptr(),
            a.data_ptr(), None, y.data_ptr(), h.data_ptr(), None, B, S, D,
            N, stream), "ssm_scan")
    torch.cuda.synchronize()
    blocks = -(-D // 128) * B     # 128 channels a block
    m = marks("ssm_scan", blocks, 6, raw=True)
    summary(f"ssm_scan [{B},{S},{D}] N={N}",
            np.concatenate([np.diff(m[:, :4], axis=1), m[:, 4:7]], axis=1),
            SSM[0][1] + ("loop: copy and wait", "loop: compute",
                         "loop: closing barrier"))


def sample_phases(lib, dev, stream, marks):
    cap = 100_000
    tree = torch.as_tensor(np.random.default_rng(1).random(2 * cap),
                           device=dev)
    for n in (256, 448):
        u = torch.rand(n, device=dev, dtype=torch.float64)
        idx = torch.empty(n, dtype=torch.int64, device=dev)
        for _ in range(5):
            build.check(lib.sumtree_sample(tree.data_ptr(), u.data_ptr(),
                                           idx.data_ptr(), n, cap, cap,
                                           stream), "sumtree_sample")
        torch.cuda.synchronize()
        summary(f"sumtree_sample N={n} cap={cap} (4 warps a block)",
                marks("sumtree_sample", -(-n // 4), len(SAMPLE[0][1])),
                SAMPLE[0][1])


def flash_phases(lib, dev, stream, marks):
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, H, Hk, S in ((4, 32, 8, 512), (1, 32, 8, 2048)):
        q = torch.randn((B, H, S, 128), generator=gen, device=dev)
        k, v = (torch.randn((B, Hk, S, 128), generator=gen, device=dev)
                for _ in "kv")
        o = torch.empty_like(q)
        for _ in range(5):
            build.check(lib.flash_attention_forward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
                B, H, Hk, S, S, 128, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *o.stride()[:3], 1, 0, 128 ** -0.5, 0,
                stream), "flash_attention")
        torch.cuda.synchronize()
        blocks = -(-S // 128) * B * H    # 128 query rows a block (8 warps)
        m = marks("flash_attention", blocks, 8, raw=True)
        summary(f"flash_attention fp32 q [{B},{H},{S},128] causal",
                np.concatenate([np.diff(m[:, :2], axis=1), m[:, 4:8],
                                np.diff(m[:, 2:4], axis=1)], axis=1),
                ("prologue", "loop: copy wait and barrier", "loop: S = Q K^T",
                 "loop: softmax", "loop: P V", "epilogue"))


def screen_phases(lib, dev, stream, marks):
    params = surrogate.Surrogate.create(82, seed=2, device=dev).params
    ws = [params[n][p] for n in ("l1", "l2", "head") for p in ("w", "b")]
    labels = SCREEN[0][1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, k in ((64, 4), (448, 4), (64, 8)):
        s = torch.randn((b, 52), device=dev)
        cand = torch.rand((b, k, 30), device=dev) * 2 - 1
        w = torch.softmax(torch.randn((b, 3), device=dev), -1)
        score = torch.empty((b, k), device=dev)
        for _ in range(5):
            build.check(lib.screen_score_forward(
                s.data_ptr(), cand.data_ptr(), w.data_ptr(),
                *(t.data_ptr() for t in ws), score.data_ptr(), b, k, stream),
                "screen_score")
        torch.cuda.synchronize()
        with torch.no_grad():
            torch.testing.assert_close(score, screen_score.screen_scores_plain(
                params, s, cand, w), rtol=1e-4, atol=1e-5)
        tiles = -(-b * k // 16)
        groups = 1 if tiles <= sms else 2
        summary(f"screen_score B={b} K={k} ({groups} groups a CTA)",
                marks("screen_score", min(-(-tiles // groups), sms),
                      len(labels)), labels)


if __name__ == "__main__":
    main()
