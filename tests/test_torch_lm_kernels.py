"""The LM kernels' plain versions against the JAX reference: the Pallas
kernels in interpret mode and their jnp oracles, over the reference's own
sweeps (``test_kernels.py``), plus ragged lengths the Pallas kernels do not
take (held against the oracles only).  The CUDA kernels are held against
these plain versions on the card in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import flash_attention, ops, ref, ssm_scan

RNG = np.random.default_rng(7)
SWEEP = [(1, 4, 2, 256, 64, True, 0), (2, 8, 8, 128, 128, True, 0),
         (1, 2, 1, 256, 64, False, 0), (1, 4, 4, 256, 64, True, 64),
         (2, 16, 4, 128, 64, True, 0)]
# test_kernels.py's tolerances: fp32 with another order of sums, and the
# rounding of a bf16 output
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}


def _np(shape, dtype):
    """Normal draws, rounded to ``dtype`` and returned as float32 numpy,
    so both packages start from the same values."""
    x = RNG.normal(0, 1, shape).astype(np.float32)
    return np.array(jnp.asarray(x, dtype).astype(jnp.float32))


def _both(arrs, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.as_tensor(a).to(td) for a in arrs])


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hk,S,hd,causal,window", SWEEP)
def test_attention_plain_matches_pallas_and_oracle(B, H, Hk, S, hd, causal,
                                                   window, dtype):
    arrs = [_np((B, H, S, hd), dtype), _np((B, Hk, S, hd), dtype),
            _np((B, Hk, S, hd), dtype)]
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    got = flash_attention.flash_attention(tq, tk, tv, causal=causal,
                                          window=window).float().numpy()
    pallas = ref_ops.flash_attention(jq, jk, jv, causal=causal,
                                     window=window, block_q=64, block_k=64)
    oracle = ref_ref.attention_reference(jq, jk, jv, causal=causal,
                                         window=window)
    assert _err(got, pallas) < TOLS[dtype]
    assert _err(got, oracle) < TOLS[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (33, 33, True, 0), (200, 200, True, 0), (200, 200, False, 16),
    (12, 12, True, 8), (7, 40, False, 0),
    # a window with Sq > Sk: the last rows see no key, so they average all
    # of them (every score at -1e30), as the oracle does
    (40, 9, False, 4)])
def test_attention_plain_matches_oracle_at_ragged_lengths(Sq, Sk, causal,
                                                          window, dtype):
    arrs = [_np((2, 4, Sq, 16), dtype), _np((2, 2, Sk, 16), dtype),
            _np((2, 2, Sk, 16), dtype)]
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dtype)
    got = ref.attention_reference(tq, tk, tv, causal=causal, window=window)
    want = ref_ref.attention_reference(jq, jk, jv, causal=causal,
                                       window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert _err(got.float(), want) < TOLS[dtype]


def _ssm_inputs(B, S, D, N):
    dt = RNG.uniform(1e-3, 0.1, (B, S, D)).astype(np.float32)
    b_in = RNG.normal(0, 1, (B, S, N)).astype(np.float32)
    c_in = RNG.normal(0, 1, (B, S, N)).astype(np.float32)
    x = RNG.normal(0, 1, (B, S, D)).astype(np.float32)
    a = -np.exp(RNG.normal(0, 1, (D, N)).astype(np.float32) * 0.5)
    return dt, b_in, c_in, x, a


@pytest.mark.parametrize("B,S,D,N,bd,ch", [
    (1, 128, 64, 8, 32, 64), (2, 256, 128, 16, 64, 128),
    (1, 64, 32, 4, 32, 32)])
def test_ssm_plain_matches_pallas_and_oracle(B, S, D, N, bd, ch):
    arrs = _ssm_inputs(B, S, D, N)
    y, h = ssm_scan.ssm_scan(*(torch.as_tensor(a) for a in arrs))
    pallas = ref_ops.ssm_scan(*(jnp.asarray(a) for a in arrs), block_d=bd,
                              chunk=ch)
    want_y, want_h = ref_ref.ssm_scan_reference(*(jnp.asarray(a)
                                                  for a in arrs))
    for g, w in ((y, pallas), (y, want_y), (h, want_h)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("B,S,D,N", [(2, 33, 24, 16), (1, 200, 40, 8),
                                     (3, 1, 8, 5)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_plain_matches_oracle_at_ragged_lengths(B, S, D, N, with_h0):
    arrs = list(_ssm_inputs(B, S, D, N))
    if with_h0:
        arrs.append(RNG.normal(0, 1, (B, D, N)).astype(np.float32))
    y, h = ref.ssm_scan_reference(*(torch.as_tensor(a) for a in arrs))
    want_y, want_h = ref_ref.ssm_scan_reference(*(jnp.asarray(a)
                                                  for a in arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-4)


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches the CUDA library: each wrapper returns its
    plain result bit for bit and counts no launch."""
    ops.reset_launch_counts()
    q, k, v = (torch.as_tensor(_np(s, "float32")) for s in
               ((1, 4, 9, 16), (1, 2, 9, 16), (1, 2, 9, 16)))
    assert torch.equal(flash_attention.flash_attention(q, k, v, window=3),
                       flash_attention.flash_attention_plain(q, k, v,
                                                             window=3))
    arrs = [torch.as_tensor(a) for a in _ssm_inputs(1, 9, 8, 4)]
    for g, w in zip(ssm_scan.ssm_scan(*arrs), ssm_scan.ssm_scan_plain(*arrs)):
        assert torch.equal(g, w)
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["ssm_scan"] == 0


def _emulate_ssm_kernel(dt, b_in, c_in, x, a, h0=None, lanes=2):
    """numpy emulation of ``csrc/ssm_scan.cu``'s arithmetic: a channel's
    16 states split over ``lanes`` lanes (lane s holds n = 16 / lanes * s +
    i, none past N); per step u = dt * x and, per state, e = 2^(dt * (A
    log2 e)) with A pre-scaled once in fp32, h = fma(e, h, u * B); each
    lane's part of y an fma chain over its states from C * h of its first,
    the lanes' parts summed in xor-shuffle order.  The time stages change
    no arithmetic, so the loop runs over S as one."""
    f32, f64 = np.float32, np.float64
    B, S, D = x.shape
    N = a.shape[1]
    spl = 16 // lanes
    a2 = (a.astype(f32) * f32(1.4426950408889634)).astype(f32)   # [D, N]
    h = np.zeros((B, D, N), f32) if h0 is None else h0.astype(f32).copy()
    y = np.zeros((B, S, D), f32)
    for t in range(S):
        dtv = dt[:, t].astype(f32)[..., None]                   # [B, D, 1]
        u = (dtv * x[:, t].astype(f32)[..., None]).astype(f32)
        e = np.exp2((dtv * a2).astype(f32)).astype(f32)
        ub = (u * b_in[:, t, None, :].astype(f32)).astype(f32)
        h = (e.astype(f64) * h + ub).astype(f32)                 # one fma
        c = c_in[:, t, None, :].astype(f32)
        parts = []
        for lane in range(lanes):
            ns = [n for n in range(spl * lane, spl * lane + spl) if n < N]
            acc = np.zeros((B, D), f32)
            for i, n in enumerate(ns):
                prod = c[..., n].astype(f64) * h[..., n]
                acc = (prod if i == 0 else prod + acc).astype(f32)
            parts.append(acc)
        while len(parts) > 1:     # xor 1, 2, ...: pairs, then pairs of pairs
            parts = [(parts[i] + parts[i + 1]).astype(f32)
                     for i in range(0, len(parts), 2)]
        y[:, t] = parts[0]
    return y, h


@pytest.mark.parametrize("B,S,D,N", [(2, 33, 24, 16), (1, 200, 40, 8),
                                     (3, 1, 8, 5), (1, 16, 12, 16),
                                     (2, 17, 20, 13)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_kernel_arithmetic_matches_oracle(B, S, D, N, with_h0):
    """The CUDA kernel's arithmetic (``_emulate_ssm_kernel``: the 2-lane
    split of the states, ``exp2`` of the pre-scaled A, the shuffle order of
    y) against the JAX oracle at rtol/atol 1e-4 on y and the final state,
    with S not a multiple of the kernel's 16-step stage and S = 1; the
    4-lane split the source also builds holds too."""
    arrs = list(_ssm_inputs(B, S, D, N))
    if with_h0:
        arrs.append(RNG.normal(0, 1, (B, D, N)).astype(np.float32))
    want_y, want_h = ref_ref.ssm_scan_reference(*(jnp.asarray(a)
                                                  for a in arrs))
    for lanes in (2, 4):
        y, h = _emulate_ssm_kernel(*arrs, lanes=lanes)
        np.testing.assert_allclose(y, np.asarray(want_y), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(h, np.asarray(want_h), rtol=1e-4,
                                   atol=1e-4)


def _tf32_trunc(a):
    """``a`` with the 13 bits TF32 drops cleared: the hi part of the
    kernel's split, and what the tensor cores read of a TF32 operand."""
    u = np.asarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xffffe000)).view(np.float32)


def _split_products(a, b):
    """The 3xTF32 products of one 8-deep k-step ``a @ b``: each operand
    split as hi = tf32(x), lo = x - hi (read as TF32 by the mma), each
    product exact (float64); returns hi.hi, lo.hi and hi.lo."""
    f64 = np.float64
    ah, bh = _tf32_trunc(a), _tf32_trunc(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return [np.matmul(x.astype(f64), y.astype(f64))
            for x, y in ((ah, bh), (al, bh), (ah, bl))]


def _emulate_flash_attention_fp32(q, k, v, causal, window, bk=64,
                                  three=True):
    """numpy emulation of the fp32 kernel's arithmetic: hd zero-padded to
    32, 64 or 128; per tile of ``bk`` keys S = Q K^T over k-steps of 8
    columns, hi.hi into one fp32 accumulator and lo.hi + hi.lo into
    another, summed at the end; scores in base 2 (times fp32 scale *
    log2 e), masked ones -1e30, keys past Sk -inf; the online softmax
    (max, 2^(s - max), the sum and the accumulator rescaled); the tile's
    P V over steps of 8 keys (lo.hi, hi.lo, hi.hi) into a fresh fp32
    accumulator, then added to the running one (in the kernel the keys 2t,
    2t + 1 of each 8 are the fragment's k = t and t + 4: a sum order
    inside the exact products); o = acc * (1 / max(l, 1e-30)).  Every mma
    rounds its accumulator to fp32.  Tiles run over all keys: the ones
    the kernel skips (past a warp's rows, before a window) change no
    value, each row's own key being visible.  ``three=False`` is plain
    TF32 (hi.hi alone)."""
    f32 = np.float32
    B, H, Sq, hd = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    hdp = 32 if hd <= 32 else 64 if hd <= 64 else 128
    skp = -(-Sk // bk) * bk

    def pad(x, rows):
        out = np.zeros(x.shape[:2] + (rows, hdp), f32)
        out[:, :, :x.shape[2], :hd] = x
        return out
    q = pad(q, Sq)
    k = np.repeat(pad(k, skp), H // Hk, axis=1)
    v = np.repeat(pad(v, skp), H // Hk, axis=1)
    sl2 = f32(f32(1.0 / np.sqrt(hd)) * f32(1.4426950408889634))
    m = np.full((B, H, Sq), -1e30, f32)
    l = np.zeros((B, H, Sq), f32)
    acc = np.zeros((B, H, Sq, hdp), f32)
    qi = np.arange(Sq)[:, None]
    for kt in range(0, Sk, bk):
        big = np.zeros((B, H, Sq, bk), f32)
        small = np.zeros_like(big)
        kk = k[:, :, kt:kt + bk]
        for d0 in range(0, hdp, 8):
            hh, lh, hl = _split_products(q[..., d0:d0 + 8],
                                         kk[..., d0:d0 + 8].swapaxes(-1, -2))
            big = (big + hh).astype(f32)
            if three:
                small = ((small + lh).astype(f32) + hl).astype(f32)
        s = (small + big).astype(f32)
        kj = kt + np.arange(bk)[None, :]
        visible = np.ones((Sq, bk), bool)
        if causal:
            visible &= kj <= qi
        if window > 0:
            visible &= kj > qi - window
        s = np.where(kj >= Sk, -np.inf,
                     np.where(visible, (s * sl2).astype(f32), f32(-1e30)))
        m_new = np.maximum(m, s.max(-1))
        alpha = np.exp2(m - m_new).astype(f32)
        p = np.exp2(s - m_new[..., None]).astype(f32)
        l = (l * alpha + p.sum(-1, dtype=f32)).astype(f32)
        tile = np.zeros_like(acc)
        for k0 in range(0, bk, 8):
            hh, lh, hl = _split_products(p[..., k0:k0 + 8],
                                         v[:, :, kt + k0:kt + k0 + 8])
            for prod in ((lh, hl, hh) if three else (hh,)):
                tile = (tile + prod).astype(f32)
        acc = ((acc * alpha[..., None]).astype(f32) + tile).astype(f32)
        m = m_new
    inv = (f32(1) / np.maximum(l, f32(1e-30))).astype(f32)
    return (acc[..., :hd] * inv[..., None]).astype(f32)


@pytest.mark.parametrize("B,H,Hk,Sq,Sk,hd,causal,window", [
    (B, H, Hk, S, S, hd, causal, window)
    for B, H, Hk, S, hd, causal, window in SWEEP] + [
    (1, 4, 2, 40, 9, 32, False, 4), (1, 4, 2, 70, 300, 128, True, 0),
    (1, 4, 2, 300, 170, 64, True, 0), (1, 4, 2, 200, 100, 64, False, 70),
    (2, 4, 2, 33, 33, 20, True, 0), (1, 4, 4, 150, 150, 36, True, 16)])
def test_attention_fp32_kernel_arithmetic_matches_oracle(B, H, Hk, Sq, Sk,
                                                         hd, causal, window):
    """The fp32 kernel's 3xTF32 arithmetic (``_emulate_flash_attention_fp32``:
    the hi/lo split, the base-2 online softmax, P V on the tiles) against
    the JAX oracle at the fp32 tolerance 2e-5, with 64- and 32-key tiles,
    over the reference's sweep, ragged Sq and Sk, a row that sees no key,
    and hd not a multiple of 8.  Plain TF32 misses 2e-5 on the sweep, so
    the test tells the two apart."""
    q, k, v = (RNG.normal(0, 1, s).astype(np.float32) for s in (
        (B, H, Sq, hd), (B, Hk, Sk, hd), (B, Hk, Sk, hd)))
    want = np.asarray(ref_ref.attention_reference(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window))
    for bk in (64, 32):
        got = _emulate_flash_attention_fp32(q, k, v, causal, window, bk)
        assert _err(got, want) < TOLS["float32"], (bk, _err(got, want))
    if Sq == Sk and hd % 8 == 0:
        plain_tf32 = _emulate_flash_attention_fp32(q, k, v, causal, window,
                                                   three=False)
        assert _err(plain_tf32, want) > TOLS["float32"]
