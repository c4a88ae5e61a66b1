"""The arithmetic of ``csrc/ssm_scan_backward.cu`` against the JAX
reference's gradients on the CPU.

A numpy emulation (``_emulate_ssm_backward``) repeats what the kernel
computes, in its order.  The forward's states saved before every 128th
step (h = fma(e, h, u B), e = 2^(dt A log2 e)) are where the recompute
starts.  A warp takes one (b, d) channel and one state n; its 32 lanes
take K = 8 consecutive steps each, so a span of 256 steps (last span
first, zero-padded past S).  Per lane: e_t once; the lane's (product of
e, h from 0) over its steps, lane 0 folding in the span's saved state, then the
warp's inclusive scan of those pairs (shuffles up by 1, 2, 4, 8, 16) and
the lane's h_t again from the state the lane before ends with.  Then the
reverse: the lane's (product of e_{t+1}, g from 0) with e_{t+1} of its
last step from the next lane (1 for lane 31), lane 31 folding in the
carry q (the gradient of h_final for the last span, else e g at the first
step of the span after), the reverse scan (shuffles down), and g_t again
from the g the next lane starts with, with each step's terms: g B and A g
e h_{t-1} (summed over n ascending for dx and d(dt)), dt g e h_{t-1}
(summed over the lane's steps, descending, then over the lanes by an xor
butterfly 16, 8, 4, 2, 1, then over the spans last first, then over the
batch rows in order for dA), u g and dy h (summed over a block's channels
in order by fma, then over the blocks in order for dB and dC).  The new
carry is e g at the span's first step; after the first span it is dh0.

It is held against ``jax.vjp`` of ``repro.kernels.ref.ssm_scan_reference``
with ``_hold_fp32_gradient``'s tolerance (``tests/test_torch_cuda.py``):
rtol 1e-4 and atol 1e-5 of the largest gradient, and within 1e-5 of the
largest gradient from the plain version run in float64.  The kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 13)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref
from repro_torch.kernels import ssm_scan

F32, F64 = np.float32, np.float64
LOG2E = F32(1.4426950408889634)
SAVE_EVERY = 128
K = 8   # the kernel's steps a lane: spans of 256
# the card tests' shapes (B, S, D, N), plus S across the span edges
CASES = [(2, 300, 200, 16), (1, 128, 64, 8), (2, 33, 130, 13), (1, 1, 8, 5),
         (1, 129, 40, 16), (2, 257, 24, 4)]


def _fma(a, b, c):
    """fmaf: a b + c rounded once to float32 (the product is exact in
    float64)."""
    return (np.asarray(a, F64) * b + c).astype(F32)


def _mul(a, b):
    return (np.asarray(a, F64) * b).astype(F32)


def _add(a, b):
    return (np.asarray(a, F64) + b).astype(F32)


def _saved_states(dt, b_in, x, a2, h0):
    """The forward kernel's states before every 128th step [B, ceil(S /
    128), D, N] (h = fma(e, h, u B))."""
    B, S, D = x.shape
    h = np.zeros((B, D, a2.shape[1]), F32) if h0 is None else h0.copy()
    saved = []
    for t in range(S):
        if t % SAVE_EVERY == 0:
            saved.append(h.copy())
        dtv = dt[:, t, :, None]
        e = np.exp2(_mul(dtv, a2))
        h = _fma(e, h, _mul(_mul(dtv, x[:, t, :, None]),
                            b_in[:, t, None, :]))
    return np.stack(saved, 1)


def _lanes(v, k):
    """[B, sp, ...] -> [B, span, ..., 32, k]: step t = span start + k lane
    + i."""
    B, sp, w = v.shape
    return np.moveaxis(v.reshape(B, sp // (32 * k), 32, k, w), 4, 2)


def _butterfly(v):
    """The warp's xor-butterfly sum over the last axis (32 lanes): every
    lane ends with the same bits."""
    for m in (16, 8, 4, 2, 1):
        v = _add(v, v[..., np.arange(32) ^ m])
    return v[..., 0]


def _emulate_ssm_backward(dt, b_in, c_in, x, a, h0, dy, gh, cpb=16):
    """numpy emulation of the kernel (module docstring) with ``cpb``
    channels a block; returns (d(dt), dB, dC, dx, dA, dh0 or None) as
    float32."""
    k = K
    B, S, D = x.shape
    N = a.shape[1]
    span = 32 * k
    nsp = -(-S // span)
    sp = nsp * span
    a2 = _mul(a, LOG2E)
    saved = _saved_states(dt, b_in, x, a2, h0)

    def pad(v):
        out = np.zeros((B, sp) + v.shape[2:], F32)
        out[:, :S] = v
        return out
    # [B, span, D or 1, N or 1, 32, k]
    dtl = _lanes(pad(dt), k)[:, :, :, None]
    ul = _lanes(pad(_mul(dt, x)), k)[:, :, :, None]
    dyl = _lanes(pad(dy), k)[:, :, :, None]
    bl = _lanes(pad(b_in), k)[:, :, None]
    cl = _lanes(pad(c_in), k)[:, :, None]
    a1 = a[None, :, :, None, None]
    g_all = np.zeros((B, nsp, D, N, 32, k), F32)
    h_all = np.zeros_like(g_all)
    gbt = np.zeros_like(g_all)
    sdtt = np.zeros_like(g_all)
    da = np.zeros((B, D, N), F32)
    q = np.zeros((B, D, N), F32) if gh is None else gh.astype(F32)
    lane = np.arange(32)
    for c in range(nsp - 1, -1, -1):
        dtv, uv, dyv, bv, cv = (v[:, c] for v in (dtl, ul, dyl, bl, cl))
        e = np.exp2(_mul(dtv, a2[None, :, :, None, None]))
        v = _mul(uv, bv)
        hstart = saved[:, c * span // SAVE_EVERY]
        # the forward: each lane's (P, L), lane 0 with the saved state
        P, L = e[..., 0].copy(), v[..., 0].copy()
        for i in range(1, k):
            L = _fma(e[..., i], L, v[..., i])
            P = _mul(P, e[..., i])
        L[..., 0] = _fma(P[..., 0], hstart, L[..., 0])
        for o in (1, 2, 4, 8, 16):
            up = lane >= o
            Lp, Pp = L[..., lane - o], P[..., lane - o]
            L, P = np.where(up, _fma(P, Lp, L), L), np.where(up, _mul(P, Pp),
                                                             P)
        hin = L[..., lane - 1]
        hin[..., 0] = hstart
        h = np.zeros_like(e)
        hp = hin
        for i in range(k):
            hp = h[..., i] = _fma(e[..., i], hp, v[..., i])
        # the reverse: each lane's (P, L) of g from its last step down
        cd = _mul(cv, dyv)
        enx = e[..., (lane + 1) % 32, 0]
        enx[..., 31] = 1.0
        Pg, Lg = enx.copy(), cd[..., k - 1].copy()
        for i in range(k - 2, -1, -1):
            Lg = _fma(e[..., i + 1], Lg, cd[..., i])
            Pg = _mul(Pg, e[..., i + 1])
        Lg[..., 31] = _fma(Pg[..., 31], q, Lg[..., 31])
        for o in (1, 2, 4, 8, 16):
            down = lane + o < 32
            Ln, Pn = Lg[..., (lane + o) % 32], Pg[..., (lane + o) % 32]
            Lg, Pg = (np.where(down, _fma(Pg, Ln, Lg), Lg),
                      np.where(down, _mul(Pg, Pn), Pg))
        gin = Lg[..., (lane + 1) % 32]
        gin[..., 31] = q
        q = _mul(e[..., 0, 0], Lg[..., 0])
        g = gin
        dal = np.zeros_like(gin)
        for i in range(k - 1, -1, -1):
            ex = enx if i == k - 1 else e[..., i + 1]
            g = _fma(ex, g, cd[..., i])
            hp = h[..., i - 1] if i else hin
            geh = _mul(_mul(g, e[..., i]), hp)
            gbt[:, c, ..., i] = _mul(g, bv[..., i])
            sdtt[:, c, ..., i] = _mul(a1[..., 0], geh)
            dal = _fma(dtv[..., i], geh, dal)
            g_all[:, c, ..., i], h_all[:, c, ..., i] = g, h[..., i]
        da = _add(da, _butterfly(dal))

    def steps(v):
        """[B, span, D, N, 32, k] -> [B, S, D, N]."""
        v = np.moveaxis(np.moveaxis(v, -2, 2), -1, 3)
        return v.reshape((B, sp) + v.shape[4:])[:, :S]
    gbt_s, sdtt_s = steps(gbt), steps(sdtt)
    gb, sdt = gbt_s[..., 0], sdtt_s[..., 0]
    for n in range(1, N):
        gb, sdt = _add(gb, gbt_s[..., n]), _add(sdt, sdtt_s[..., n])
    dx = _mul(dt, gb)
    ddt = _fma(x, gb, sdt)
    # dB, dC: fma over a block's channels in order, the blocks in order
    g_s, h_s = steps(g_all), steps(h_all)
    u = _mul(dt, x)
    db = np.zeros((B, S, N), F32)
    dc = np.zeros_like(db)
    for d0 in range(0, D, cpb):
        pb = np.zeros_like(db)
        pc = np.zeros_like(db)
        for d in range(d0, min(D, d0 + cpb)):
            pb = _fma(u[:, :, d, None], g_s[:, :, d], pb)
            pc = _fma(dy[:, :, d, None], h_s[:, :, d], pc)
        db, dc = _add(db, pb), _add(dc, pc)
    dA = np.zeros((D, N), F32)
    for b in range(B):
        dA = _add(dA, da[b])
    return ddt, db, dc, dx, dA, None if h0 is None else q


def _inputs(B, S, D, N, with_h0, with_dh):
    rng = np.random.default_rng(S * 1000 + D)
    ins = [rng.uniform(1e-3, 0.101, (B, S, D)), rng.normal(0, 1, (B, S, N)),
           rng.normal(0, 1, (B, S, N)), rng.normal(0, 1, (B, S, D)),
           -np.exp(0.5 * rng.normal(0, 1, (D, N))),
           rng.normal(0, 1, (B, D, N)) if with_h0 else None,
           rng.normal(0, 1, (B, S, D)),
           rng.normal(0, 1, (B, D, N)) if with_dh else None]
    return [None if v is None else v.astype(F32) for v in ins]


def _jax_grads(dt, b_in, c_in, x, a, h0, dy, gh):
    """``jax.vjp`` of the JAX oracle: (d(dt), dB, dC, dx, dA, dh0)."""
    B, S, D = x.shape
    args = [jnp.asarray(v) for v in (dt, b_in, c_in, x, a)]
    if h0 is not None:
        args.append(jnp.asarray(h0))
    _, vjp = jax.vjp(lambda *v: ref_ref.ssm_scan_reference(*v), *args)
    dh = np.zeros((B, D, a.shape[1]), F32) if gh is None else gh
    got = [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dh)))]
    return got + ([None] if h0 is None else [])


def _float64_grads(dt, b_in, c_in, x, a, h0, dy, gh):
    """The port's plain version's autograd in float64."""
    t = lambda v: None if v is None else torch.as_tensor(v, dtype=torch.float64)
    got = ssm_scan.ssm_scan_backward_plain(t(dt), t(b_in), t(c_in), t(x),
                                           t(a), t(h0), t(dy), t(gh))
    return [None if g is None else g.numpy() for g in got]


def _hold(got, want, exact, name):
    """``_hold_fp32_gradient``'s tolerance, on numpy arrays."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=name)
    err = float(np.abs(got.astype(F64) - exact).max())
    assert err <= 1e-5 * scale, (name, err, scale)


NAMES = ("dt", "B", "C", "x", "A", "h0")


@pytest.mark.parametrize("B,S,D,N", CASES)
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_backward_arithmetic_matches_jax_grad(B, S, D, N, with_dh,
                                                  with_h0):
    """The kernel's arithmetic (16 channels a block) against jax.vjp of
    the oracle and the float64 plain version."""
    ins = _inputs(B, S, D, N, with_h0, with_dh)
    got = _emulate_ssm_backward(*ins)
    want = _jax_grads(*ins)
    exact = _float64_grads(*ins)
    for name, g, w, x_ in zip(NAMES, got, want, exact):
        if w is None:
            assert g is None and x_ is None, name
            continue
        assert g.shape == w.shape, name
        _hold(g, w, x_, name)


@pytest.mark.parametrize("B,D,sms", [(2, 8192, 132), (2, 200, 132),
                                     (1, 8, 132), (4, 8192, 132),
                                     (8, 8192, 132), (2, 1000, 114)])
def test_channels_per_block_fill_the_card_about_once(B, D, sms):
    """The wrapper's channels a block: a multiple of 8 from 8 to 256 (the
    kernel's limits), and as few as keep the grid within one block an SM
    unless 256 are too few (Jamba's shape: 128 channels, 128 blocks on
    132 SMs)."""
    cpb = ssm_scan.backward_channels_per_block(B, D, sms)
    assert cpb % 8 == 0 and 8 <= cpb <= 256
    blocks = B * -(-D // cpb)
    assert blocks <= sms or cpb == 256
    if cpb > 8:
        assert B * -(-D // (cpb - 8)) > sms
    if (B, D, sms) == (2, 8192, 132):
        assert (cpb, blocks) == (128, 128)
