"""The arithmetic of ``csrc/flash_attention_backward.cu`` against the JAX
reference's gradients on the CPU.

A numpy emulation (``_emulate_attention_backward``) repeats what the
kernels compute: hd zero-padded to 32, 64 or 128; D = rowsum(dO o) in the
dsum kernel's order; the dK/dV kernels' walk over the group's query heads
and their query chunks, with the keys as rows (S^T = K Q^T, P^T, dV += P^T
dO, dP^T = V dO^T, dS^T, dK += dS^T Q), and the dQ kernels' walk over key
chunks (S, P, dP, dS, dQ += dS K); rows that see no key known by index (P =
1 / Sk, dS = 0).  fp16/bf16: products of 16-deep k-steps from operands in
the input type, exact, into fp32 accumulators, P and dS rounded to the
input type before their products.  fp32: 3xTF32 (each operand split as hi
= tf32(x), lo = tf32(x - hi), both rounded to nearest), S and dP with each
k-step's hi.hi in a fresh accumulator and their small products in
accumulators of their own, dV, dK and dQ with each chunk's products
(lo.hi, hi.lo, hi.hi) in fresh accumulators added to the running sums.
Every mma rounds its accumulator to fp32 (the products exact).  It is held
against ``jax.vjp`` of ``repro.kernels.ref.attention_reference``: fp32
within rtol 1e-4 / atol 1e-5, fp16 and bf16 within 2e-2 of the largest
gradient; plain TF32 (hi.hi alone) misses the fp32 tolerance, so the test
tells the two apart.  The
kernels themselves are held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 13)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as ref_ref
from repro_torch.kernels import flash_attention

F32, F64 = np.float32, np.float64
LOG2E = F32(1.4426950408889634)
RNG = np.random.default_rng(23)
# the card tests' cases (B, H, Hk, Sq, Sk, hd, causal, window): GQA with
# ragged tiles, non-causal Sq != Sk, causal Sq < Sk, a window, rows that see
# no key (and non-causal), MLA's width 96, hd 128 with Sk > Sq, SmolLM's
# group of 3
CASES = [(2, 4, 2, 130, 130, 64, True, 0),
         (1, 4, 4, 77, 131, 64, False, 0),
         (1, 4, 2, 77, 131, 64, True, 0),
         (1, 4, 2, 200, 200, 64, True, 70),
         (1, 4, 2, 200, 100, 80, True, 70),
         (1, 4, 2, 40, 9, 32, False, 4),
         (1, 4, 4, 100, 100, 96, True, 0),
         (1, 2, 1, 70, 300, 128, True, 0),
         (1, 9, 3, 150, 150, 64, True, 0)]


def _rounded(x, dtype):
    """``x`` rounded to ``dtype`` (round to nearest), as float32."""
    np_dtype = {"float32": F32, "float16": np.float16,
                "bfloat16": jnp.bfloat16}[dtype]
    return np.asarray(x, F32).astype(np_dtype).astype(F32)


def _tf32(a):
    """``a`` rounded to TF32 (to nearest, ties away from zero), as the
    kernel's split rounds both of its parts."""
    u = np.asarray(a, F32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(F32)


def _split_products(a, b):
    """The 3xTF32 products of one 8-deep k-step ``a @ b``, exact (float64):
    hi.hi, lo.hi and hi.lo, with hi = tf32(x) and lo = tf32(x - hi)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return [np.matmul(x.astype(F64), y.astype(F64))
            for x, y in ((ah, bh), (al, bh), (ah, bl))]


def _rows(a, b, mode):
    """A B^T for rows ``a`` [.., M, HDP] and ``b`` [.., N, HDP] (S^T, dP^T,
    S, dP): ``mode`` "half" sums 16-deep k-steps into one fp32
    accumulator; "tf32x3" adds each 8-deep k-step's hi.hi (rounded once)
    to one and lo.hi + hi.lo to another, summed at the end; "tf32" hi.hi
    alone."""
    bt = np.swapaxes(b, -1, -2)
    acc = np.zeros(a.shape[:-1] + (b.shape[-2],), F32)
    if mode == "half":
        for d0 in range(0, a.shape[-1], 16):
            acc = (acc + np.matmul(a[..., d0:d0 + 16].astype(F64),
                                   bt[..., d0:d0 + 16, :].astype(F64))
                   ).astype(F32)
        return acc
    small = np.zeros_like(acc)
    for d0 in range(0, a.shape[-1], 8):
        hh, lh, hl = _split_products(a[..., d0:d0 + 8], bt[..., d0:d0 + 8, :])
        acc = (acc + hh.astype(F32)).astype(F32)
        if mode == "tf32x3":
            small = ((small + lh).astype(F32) + hl).astype(F32)
    return (small + acc).astype(F32)


def _cols(acc, x, m, mode, dtype):
    """acc + X M for a chunk's X [.., M, K] (P^T, dS^T, dS) and rows ``m``
    [.., K, HDP] (dO, Q, K): "half" rounds X to ``dtype`` and adds each
    16-deep k-step's products into acc; "tf32x3" sums the chunk's lo.hi,
    hi.lo and hi.hi per 8-deep k-step into a fresh accumulator, then adds
    it to acc; "tf32" the same with hi.hi alone."""
    if mode == "half":
        xr = _rounded(x, dtype)
        for k0 in range(0, x.shape[-1], 16):
            acc = (acc + np.matmul(xr[..., k0:k0 + 16].astype(F64),
                                   m[..., k0:k0 + 16, :].astype(F64))
                   ).astype(F32)
        return acc
    tile = np.zeros_like(acc)
    for k0 in range(0, x.shape[-1], 8):
        hh, lh, hl = _split_products(x[..., k0:k0 + 8], m[..., k0:k0 + 8, :])
        for prod in ((lh, hl, hh) if mode == "tf32x3" else (hh,)):
            tile = (tile + prod).astype(F32)
    return (acc + tile).astype(F32)


def _visible(qi, kj, causal, window):
    ok = np.ones(np.broadcast(qi, kj).shape, bool)
    if causal:
        ok &= kj <= qi
    if window > 0:
        ok &= kj > qi - window
    return ok


def _forward(q, k, v, causal, window, dtype):
    """The forward's outputs the backward reads: o in ``dtype`` and the
    base-2 log-sum-exp of the visible scores (float64, rounded once)."""
    B, H, Sq, hd = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    kr = np.repeat(k, H // Hk, axis=1).astype(F64)
    vr = np.repeat(v, H // Hk, axis=1).astype(F64)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(F64), kr) / np.sqrt(hd)
    vis = _visible(np.arange(Sq)[:, None], np.arange(Sk)[None, :], causal,
                   window)
    s = np.where(vis, s, -1e30)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    o = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), vr)
    lse = (m[..., 0] + np.log(p.sum(-1))) * F64(LOG2E)
    return _rounded(o, dtype), lse.astype(F32)


def _rowsum(do, o):
    """D = rowsum(dO o) as the dsum kernel sums it: lane c % 32 takes
    columns c, c + 32, ... with an fma each, then the xor-shuffle tree."""
    lanes = []
    for lane in range(32):
        acc = np.zeros(do.shape[:-1], F32)
        for c in range(lane, do.shape[-1], 32):
            acc = (acc + o[..., c].astype(F64) * do[..., c]).astype(F32)
        lanes.append(acc)
    for m in (16, 8, 4, 2, 1):
        lanes = [(lanes[i] + lanes[i ^ m]).astype(F32) for i in range(32)]
    return lanes[0]


def _emulate_attention_backward(q, k, v, do, causal, window, dtype,
                                three=True):
    """numpy emulation of the backward kernels' arithmetic (module
    docstring); inputs float32 arrays holding values of ``dtype``;
    returns (dq, dk, dv) rounded to ``dtype``, as float32."""
    B, H, Sq, hd = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    G = H // Hk
    hdp = 32 if hd <= 32 else 64 if hd <= 64 else 128
    half = dtype != "float32"
    mode = "half" if half else "tf32x3" if three else "tf32"
    ch_kv = (32 if hdp == 128 else 64) if half else (16 if hdp == 128
                                                     else 32)
    ch_q = (32 if hdp == 128 else 64) if half else 32
    scale = F32(1.0 / np.sqrt(hd))
    sl2 = F32(scale * LOG2E)
    o, lse = _forward(q, k, v, causal, window, dtype)
    dsum = _rowsum(do, o)
    sqp, skp = -(-Sq // 64) * 64, -(-Sk // 64) * 64

    def pad(x, rows):
        out = np.zeros(x.shape[:2] + (rows, hdp), F32)
        out[:, :, :x.shape[2], :hd] = x
        return out

    def padrows(x, rows):
        out = np.zeros(x.shape[:2] + (rows,), F32)
        out[:, :, :x.shape[2]] = x
        return out
    qp, gp = pad(q, sqp), pad(do, sqp)
    kp, vp = pad(k, skp), pad(v, skp)
    lp, dp_ = padrows(lse, sqp), padrows(dsum, sqp)
    rows = np.arange(sqp)
    all_masked = (window > 0) & (rows >= Sk + window - 1) & (rows < Sq)

    def probs(s, lse_, qi, kj):
        with np.errstate(over="ignore"):   # masked pairs, replaced below
            e = np.exp2((s.astype(F64) * sl2 - lse_).astype(F32)).astype(F32)
        ok = (qi < Sq) & (kj < Sk) & _visible(qi, kj, causal, window)
        return np.where(ok, e, F32(0))

    # dK, dV: per KV head, the group's heads in turn, query chunks in order
    dk = np.zeros((B, Hk, skp, hdp), F32)
    dv = np.zeros_like(dk)
    kj = np.arange(skp)[:, None]
    grp = lambda x: x.reshape((B, Hk, G) + x.shape[2:])
    for gi in range(G):
        qg, gg = grp(qp)[:, :, gi], grp(gp)[:, :, gi]
        lg, dg = grp(lp)[:, :, gi], grp(dp_)[:, :, gi]
        for c0 in range(0, sqp, ch_kv):
            sl = slice(c0, c0 + ch_kv)
            qi = np.arange(c0, c0 + ch_kv)[None, :]
            am = all_masked[sl][None, :] & (kj < Sk)
            pt = probs(_rows(kp, qg[:, :, sl], mode), lg[:, :, None, sl],
                       qi, kj)
            pt = np.where(am, F32(1.0) / F32(Sk), pt).astype(F32)
            dv = _cols(dv, pt, gg[:, :, sl], mode, dtype)
            dpt = _rows(vp, gg[:, :, sl], mode)
            dst = (pt * (dpt - dg[:, :, None, sl])).astype(F32)
            dst = np.where(am, F32(0), dst)
            dk = _cols(dk, dst, qg[:, :, sl], mode, dtype)
    # dQ: per query head, key chunks in order
    dq = np.zeros((B, H, sqp, hdp), F32)
    kr, vr = np.repeat(kp, G, axis=1), np.repeat(vp, G, axis=1)
    qi = np.arange(sqp)[:, None]
    for c0 in range(0, skp, ch_q):
        sl = slice(c0, c0 + ch_q)
        kc = np.arange(c0, c0 + ch_q)[None, :]
        p = probs(_rows(qp, kr[:, :, sl], mode), lp[..., None], qi, kc)
        p = np.where(all_masked[:, None], F32(0), p)
        ds = (p * (_rows(gp, vr[:, :, sl], mode) - dp_[..., None])
              ).astype(F32)
        dq = _cols(dq, ds, kr[:, :, sl], mode, dtype)
    out = ((dq * scale).astype(F32)[:, :, :Sq, :hd],
           (dk * scale).astype(F32)[:, :, :Sk, :hd], dv[:, :, :Sk, :hd])
    return tuple(_rounded(x, dtype) for x in out)


def _inputs(B, H, Hk, Sq, Sk, hd, dtype):
    return [_rounded(RNG.normal(0, 1, s), dtype) for s in
            ((B, H, Sq, hd), (B, Hk, Sk, hd), (B, Hk, Sk, hd),
             (B, H, Sq, hd))]


def _jax_grads(q, k, v, do, causal, window):
    """``jax.vjp`` of the JAX oracle at float32 copies of the inputs."""
    _, vjp = jax.vjp(lambda q_, k_, v_: ref_ref.attention_reference(
        q_, k_, v_, causal=causal, window=window),
        *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("B,H,Hk,Sq,Sk,hd,causal,window", CASES)
def test_attention_backward_arithmetic_matches_jax_grad(B, H, Hk, Sq, Sk,
                                                         hd, causal, window,
                                                         dtype):
    """The kernels' arithmetic against jax.vjp of the oracle: fp32 on
    3xTF32 within rtol 1e-4 / atol 1e-5, fp16 and bf16 within 2e-2 of the
    largest gradient."""
    q, k, v, do = _inputs(B, H, Hk, Sq, Sk, hd, dtype)
    got = _emulate_attention_backward(q, k, v, do, causal, window, dtype)
    want = _jax_grads(q, k, v, do, causal, window)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=f"d{name}")
        else:
            err = float(np.abs(g - w).max())
            assert err <= 2e-2 * float(np.abs(w).max()), (name, err)


def test_plain_tf32_misses_the_fp32_tolerance():
    """Without the 3xTF32 split (hi.hi alone) the same arithmetic misses
    rtol 1e-4 / atol 1e-5 at some case, so the fp32 test above tells the
    split from plain TF32."""
    missed = []
    for case in CASES[:4]:
        q, k, v, do = _inputs(*case[:6], "float32")
        got = _emulate_attention_backward(q, k, v, do, *case[6:], "float32",
                                          three=False)
        want = _jax_grads(q, k, v, do, *case[6:])
        missed.append(any(not np.allclose(g, w, rtol=1e-4, atol=1e-5)
                          for g, w in zip(got, want)))
    assert any(missed), missed


def test_emulated_forward_lse_matches_plain_softmax():
    """The emulation's forward statistics: o the plain version's output and
    2^(s log2 e - lse) summing to 1 on every row that sees a key."""
    import torch
    case = (1, 4, 2, 40, 9, 32, False, 4)
    q, k, v, _ = _inputs(*case[:6], "float32")
    o, lse = _forward(q, k, v, *case[6:], "float32")
    want = flash_attention.flash_attention_plain(
        *(torch.as_tensor(a) for a in (q, k, v)), causal=False, window=4)
    np.testing.assert_allclose(o, want.numpy(), rtol=1e-5, atol=1e-6)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(F64),
                  np.repeat(k, 2, axis=1).astype(F64)) / np.sqrt(32)
    qi, kj = np.arange(40)[:, None], np.arange(9)[None, :]
    vis = _visible(qi, kj, False, 4)
    with np.errstate(over="ignore"):   # masked pairs
        mass = np.where(vis, np.exp2(s * F64(LOG2E) - lse[..., None]),
                        0).sum(-1)
    seen = vis.any(-1)
    np.testing.assert_allclose(mass[..., seen], 1.0, rtol=1e-6)
