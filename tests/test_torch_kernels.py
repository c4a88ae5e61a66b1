"""The port's search-loop kernels: plain versions against the JAX
reference (its jnp oracle and its Pallas kernel in interpret mode) and the
CPU dispatch of the wrappers.  The CUDA kernels themselves are held against
their plain versions on the card in test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import networks as ref_nets
from repro.core import replay as ref_replay
from repro.core.actions import N_CONT
from repro.core.state import SAC_STATE_DIM
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.ppa import surrogate as ref_sur
from repro_torch import convert
from repro_torch.core import networks as nets
from repro_torch.kernels import (actor_moe, ops, policy_mlp, ref,
                                  screen_score, sumtree, sumtree_sample)
from repro_torch.ppa import surrogate as sur

# fp32 with sums in another order than XLA's (the reference kernel tests'
# tolerance)
RTOL, ATOL = 1e-4, 1e-5
RNG = np.random.default_rng(42)


def _actor_params(seed=3, device="cpu"):
    p = ref_nets.actor_init(jax.random.PRNGKey(seed))
    return p, convert.tree_to_torch(jax.tree_util.tree_map(np.asarray, p),
                                    device)


def _sur_params(seed=5, device="cpu"):
    p = ref_sur.init_params(jax.random.PRNGKey(seed), SAC_STATE_DIM + N_CONT)
    return p, convert.tree_to_torch(jax.tree_util.tree_map(np.asarray, p),
                                    device)


def _states(b):
    return RNG.normal(0, 1, (b, SAC_STATE_DIM)).astype(np.float32)


def _screen_inputs(b, k):
    s = _states(b)
    cand = RNG.uniform(-1, 1, (b, k, N_CONT)).astype(np.float32)
    w = RNG.dirichlet(np.ones(3), b).astype(np.float32)
    return s, cand, w


@pytest.mark.parametrize("b", [4, 33, 256])
def test_actor_plain_matches_reference_and_pallas(b):
    jp, tp = _actor_params()
    s = _states(b)
    got = nets.actor_forward(tp, torch.as_tensor(s), actor_moe.actor_forward)
    want = ref_ref.actor_forward_reference(jp, jnp.asarray(s))
    pallas = ref_ops.actor_forward(jp, jnp.asarray(s))     # interpret mode
    for g, w, p in zip(got, want, pallas):
        assert tuple(g.shape) == w.shape == p.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("b,k", [(8, 4), (33, 6), (64, 4)])
def test_screen_plain_matches_reference_and_pallas(b, k):
    jp, tp = _sur_params()
    s, cand, w = _screen_inputs(b, k)
    got = screen_score.screen_scores(tp, torch.as_tensor(s),
                                     torch.as_tensor(cand),
                                     torch.as_tensor(w)).numpy()
    want = np.asarray(ref_ref.screen_scores_reference(
        jp, jnp.asarray(s), jnp.asarray(cand), jnp.asarray(w)))
    pallas = np.asarray(ref_ops.screen_scores(
        jp, jnp.asarray(s), jnp.asarray(cand), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    # the full select: same picks as the reference, gate open and closed
    mask = RNG.random(b) < 0.5
    pick = sur.screen_batch(tp, torch.as_tensor(s), torch.as_tensor(cand),
                            torch.as_tensor(w), torch.as_tensor(mask)).numpy()
    want_pick = np.asarray(ref_sur.screen_batch(
        jp, jnp.asarray(s), jnp.asarray(cand), jnp.asarray(w),
        jnp.asarray(mask)))
    np.testing.assert_array_equal(pick, want_pick)
    assert (pick[~mask] == 0).all()


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the CUDA library: the wrapper returns the
    plain result bit for bit and counts no launch."""
    _, ap = _actor_params()
    _, sp = _sur_params()
    ops.reset_launch_counts()
    s = torch.as_tensor(_states(9))
    for g, w in zip(actor_moe.actor_forward(ap, s),
                    ref.actor_forward_reference(ap, s)):
        assert torch.equal(g, w)
    s2, cand, w = (torch.as_tensor(x) for x in _screen_inputs(9, 4))
    assert torch.equal(screen_score.screen_scores(sp, s2, cand, w),
                       ref.screen_scores_reference(sp, s2, cand, w))
    x = torch.as_tensor(RNG.normal(0, 1, (9, 82)).astype(np.float32))
    ws = [torch.as_tensor(a) for a in _mlp_weights(52)]
    assert torch.equal(policy_mlp.fused_mlp(x, *ws),
                       ref.fused_mlp_reference(x, *ws))
    tree = torch.zeros(16, dtype=torch.float64)
    idx = torch.tensor([1, 5, 1])
    vals = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    got = sumtree.sumtree_set_many(tree.clone(), idx, vals)
    assert torch.equal(got, ref.sumtree_set_many_reference(tree.clone(), idx,
                                                           vals))
    u = torch.tensor([0.1, 0.9], dtype=torch.float64)
    assert torch.equal(sumtree_sample.sumtree_sample(got, u, 8),
                       ref.sumtree_sample_reference(got, u, 8))
    assert ops.launch_counts() == {"actor_moe": 0, "screen_score": 0,
                                   "sumtree": 0, "sumtree_sample": 0,
                                   "fused_mlp": 0, "flash_attention": 0,
                                   "ssm_scan": 0}


def _mlp_weights(d_out, rng=RNG):
    """The reference sweep's weights (x0.1 normals, zero biases) with
    nonzero biases, so the bias-last order is exercised too."""
    return [(rng.normal(0, 1, (82, 128)) * 0.1).astype(np.float32),
            (rng.normal(0, 1, 128) * 0.1).astype(np.float32),
            (rng.normal(0, 1, (128, 64)) * 0.1).astype(np.float32),
            (rng.normal(0, 1, 64) * 0.1).astype(np.float32),
            (rng.normal(0, 1, (64, d_out)) * 0.1).astype(np.float32),
            (rng.normal(0, 1, d_out) * 0.1).astype(np.float32)]


@pytest.mark.parametrize("b", [64, 300, 16])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_fused_mlp_plain_matches_reference_and_pallas(b, dtype, tol):
    """The reference sweep (``test_kernels.py::test_fused_mlp_sweep``):
    world-model widths 82 -> 128 -> 64 -> 52, max abs error below 1e-5 in
    fp32 and 3e-2 with bf16 input and output, against the jnp oracle and
    the Pallas kernel in interpret mode."""
    ws = _mlp_weights(52)
    x = RNG.normal(0, 1, (b, 82)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = policy_mlp.fused_mlp(tx, *(torch.as_tensor(w) for w in ws))
    assert got.dtype == tx.dtype and tuple(got.shape) == (b, 52)
    got = got.float().numpy()
    jws = [jnp.asarray(w) for w in ws]
    for want in (ref_ref.fused_mlp_reference(jx, *jws),
                 ref_ops.fused_mlp(jx, *jws)):
        err = np.abs(got - np.asarray(want, np.float32)).max()
        assert err < tol, err


def test_surrogate_and_world_model_inference_match_reference():
    """The search's inference calls through ``fused_mlp``: the surrogate's
    ``predict`` and the world model's step ``s + fused_mlp([s; a])``,
    against the reference's own functions on the same parameters."""
    jp, tp = _sur_params()
    x = RNG.normal(0, 1, (3, 7, 82)).astype(np.float32)
    np.testing.assert_allclose(
        sur.predict(tp, torch.as_tensor(x)).numpy(),
        np.asarray(ref_sur.predict(jp, jnp.asarray(x))), rtol=RTOL,
        atol=ATOL)
    wm_j = ref_nets.world_model_init(jax.random.PRNGKey(4))
    wm_t = convert.tree_to_torch(jax.tree_util.tree_map(np.asarray, wm_j))
    s = _states(5)
    a = RNG.uniform(-1, 1, (5, N_CONT)).astype(np.float32)
    np.testing.assert_allclose(
        nets.world_model_step(wm_t, torch.as_tensor(s),
                              torch.as_tensor(a)).numpy(),
        np.asarray(ref_nets.world_model_forward(
            wm_j, jnp.asarray(s), jnp.asarray(a))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cap", [8, 100, 257, 100_000])
def test_sumtree_plain_matches_host_oracle_bitwise(cap):
    """The plain sum-tree set against the reference's host float64 oracle
    (``ref.sumtree_set_many_reference``), bitwise: duplicate indices
    (last write wins), a scalar broadcast (the insert path), and the root
    against the sum of the leaves.  Not held against the Pallas sum-tree,
    which does not trace on this JAX version (ROADMAP §C)."""
    rng = np.random.default_rng(cap)
    base = ref_replay.SumTree(cap)
    base.set_many(np.arange(cap), rng.random(cap))
    for n in (1, 37, 448):
        idx = rng.integers(0, cap, n)          # duplicates when n is large
        idx[-1] = idx[0]                       # and always at least one
        for vals in (rng.random(n), 0.5):
            want = ref_ref.sumtree_set_many_reference(base.tree, idx, vals)
            tree = torch.as_tensor(base.tree.copy())
            out = sumtree.sumtree_set_many(
                tree, torch.as_tensor(idx),
                torch.as_tensor(vals) if np.ndim(vals) else vals)
            assert out is tree                  # in place
            np.testing.assert_array_equal(tree.numpy(), want)
            np.testing.assert_allclose(tree[1].item(), want[cap:].sum(),
                                       rtol=1e-12)


def test_wrappers_refuse_other_devices():
    _, ap = _actor_params()
    s = torch.zeros((2, SAC_STATE_DIM), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        actor_moe.actor_forward(ap, s)
    with pytest.raises(ValueError, match="unsupported device"):
        sumtree.sumtree_set_many(torch.zeros(8, dtype=torch.float64,
                                             device="meta"),
                                 torch.zeros(1, dtype=torch.int64), 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        sumtree_sample.sumtree_sample(torch.zeros(8, dtype=torch.float64,
                                                  device="meta"),
                                      torch.zeros(1, dtype=torch.float64), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        policy_mlp.fused_mlp(torch.zeros((2, 82), device="meta"),
                             *(torch.as_tensor(w) for w in _mlp_weights(3)))


_SENTINEL = np.uint64(2 ** 64 - 1)


def _emulate_sumtree_launch(tree, idx, values):
    """numpy emulation of one launch of ``csrc/sumtree.cu`` (<= 1024
    writes), step for step: composite keys (the leaf aligned to the deepest
    level, shifted left by 10, OR the position) through the same bitonic
    network, the run-last winners compacted in order, each winner's L*
    from its key and the previous one, the level loop from run buffers
    (value and end of the run that starts at e + 1) and siblings staged
    before the loop, and nodes 1..31 from level 5 by the top warp."""
    cap = len(tree) // 2
    n = len(idx)
    lmax = (2 * cap - 1).bit_length() - 1
    p = 32
    while p < n:
        p *= 2
    old = tree.copy()
    key = np.full(p, _SENTINEL, np.uint64)
    for t, x in enumerate(idx):
        if 0 <= x < cap:
            leaf = int(x) + cap
            key[t] = ((leaf << (lmax - (leaf.bit_length() - 1))) << 10) | t
    lanes = np.arange(p)
    k = 2
    while k <= p:
        j = k // 2
        while j:
            other = key[lanes ^ j]
            take_min = ((lanes & k) == 0) == ((lanes & j) == 0)
            key = np.where(take_min, np.minimum(key, other),
                           np.maximum(key, other))
            j //= 2
        k *= 2
    assert (np.diff(key.astype(np.float64)) >= 0).all()
    nxt = np.append(key[1:], _SENTINEL)
    win = (key != _SENTINEL) & ((nxt >> np.uint64(10)) != (key
                                                            >> np.uint64(10)))
    c0 = [int(x) >> 10 for x in key[win]]
    pos = [int(x) & 1023 for x in key[win]]
    m = len(c0)
    v = [float(values[j]) if np.ndim(values) else float(values)
         for j in pos]
    for c, val in zip(c0, v):
        tree[c >> 1 if c >= 2 * cap else c] = val
    staged = tree.copy()        # untouched siblings never change later
    lstar = [-1] + [lmax - (c0[f - 1] ^ c0[f]).bit_length()
                    for f in range(1, m)]
    e = list(range(m))
    stop = 5 if cap >= 64 else 0
    runv, rune = [0.0] * m, [0] * m
    for level in range(lmax - 1, stop - 1, -1):
        s = lmax - level
        for f in range(m):
            if lstar[f] == level:
                runv[f], rune[f] = v[f], e[f]
        for f in range(m):
            a = c0[f] >> s
            if lstar[f] >= level or a >= cap:
                continue
            c = c0[f] >> (s - 1)
            sib = staged[c ^ 1]
            if c & 1:
                v[f] = sib + v[f]
            elif e[f] + 1 < m and (c0[e[f] + 1] >> s) == a:
                v[f] = v[f] + runv[e[f] + 1]
                e[f] = rune[e[f] + 1]
            else:
                v[f] = v[f] + sib
            tree[a] = v[f]
    if stop:
        touched = np.zeros(32, bool)
        x = old[32:64].copy()
        for f in range(m):
            if lstar[f] < 5:
                a = (c0[f] >> (lmax - 5)) - 32
                touched[a], x[a] = True, v[f]
        for level in range(4, -1, -1):
            w = 1 << level
            tl, tr = touched[0:2 * w:2], touched[1:2 * w:2]
            x = np.where(tl | tr, x[0:2 * w:2] + x[1:2 * w:2],
                         old[w:2 * w])
            touched = tl | tr
            tree[w:2 * w][touched] = x[touched]
    return tree


def _sumtree_cases(cap, n, rng):
    """Index sets for one (cap, N): random, all N writes to one index, and
    (N >= 4) the first- and last-sorted leaves written again at the end
    with an out-of-range index in the middle."""
    lmax = (2 * cap - 1).bit_length() - 1
    idx = rng.integers(0, cap, n)
    yield "random", idx
    yield "one index", np.full(n, rng.integers(0, cap))
    if n >= 4:
        idx = rng.integers(0, cap, n)
        leaf = idx + cap
        aligned = [int(x) << (lmax - (int(x).bit_length() - 1)) for x in leaf]
        idx[-1], idx[-2] = idx[int(np.argmin(aligned))], idx[int(np.argmax(
            aligned))]
        idx[n // 2] = cap if n % 2 else -1
        yield "run ends + out of range", idx


@pytest.mark.parametrize("cap", [1, 8, 100, 257, 100_000])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 448, 1024, 1025])
def test_sumtree_kernel_algorithm_matches_host_oracle_bitwise(cap, n):
    """The CUDA kernel's algorithm (``_emulate_sumtree_launch``) against
    the reference's host float64 ``SumTree.set_many``, bitwise, on a tree
    whose inner nodes are not the sums of their children (so an untouched
    node must keep its value), with per-write values and a scalar; N >
    1024 goes through two launches in order, as the wrapper splits it."""
    rng = np.random.default_rng(cap * 1031 + n)
    base = rng.random(2 * cap)
    for label, idx in _sumtree_cases(cap, n, rng):
        for vals in (rng.random(n), 0.25):
            host = ref_replay.SumTree(cap)
            host.tree = base.copy()
            keep = (idx >= 0) & (idx < cap)
            host.set_many(idx[keep], vals[keep] if np.ndim(vals) else vals)
            got = base.copy()
            for lo in range(0, n, sumtree.MAX_N):
                part = slice(lo, lo + sumtree.MAX_N)
                got = _emulate_sumtree_launch(
                    got, idx[part], vals[part] if np.ndim(vals) else vals)
            np.testing.assert_array_equal(got, host.tree, err_msg=label)
