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
from repro.core.actions import N_CONT
from repro.core.state import SAC_STATE_DIM
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.ppa import surrogate as ref_sur
from repro_torch import convert
from repro_torch.core import networks as nets
from repro_torch.kernels import actor_moe, ops, ref, screen_score
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
    assert ops.launch_counts() == {"actor_moe": 0, "screen_score": 0}


def test_wrappers_refuse_other_devices():
    _, ap = _actor_params()
    s = torch.zeros((2, SAC_STATE_DIM), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        actor_moe.actor_forward(ap, s)
