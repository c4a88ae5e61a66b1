"""The port's batched env step against the JAX reference: reward, encoding,
partition stats, action application, and ``VecDSEEnv`` reset + steps from
the same numpy streams and action sequences (CPU, float32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import actions as ref_act
from repro.core import partition as ref_part
from repro.core import reward as ref_rw
from repro.core import state as ref_st
from repro.core.env import VecDSEEnv as RefVecDSEEnv
from repro.ppa import analytic as ref_an
from repro.ppa import config_space as ref_cs
from repro.workload.extract import extract as ref_extract
from repro_torch.core import actions as act
from repro_torch.core import partition as part
from repro_torch.core import reward as rw
from repro_torch.core import state as st
from repro_torch.core.env import VecDSEEnv
from repro_torch.ppa import analytic as an
from repro_torch.ppa.nodes import node_params

RTOL, ATOL = 1e-5, 1e-6
T = torch.as_tensor
J = jnp.asarray
# design fields on a quantisation grid (mesh, SC, ports, memories, ...)
DISCRETE = np.nonzero(ref_cs.STEP > 0)[0]


def _wl(arch="llama3.1-8b"):
    return ref_extract(ref_get_config(arch), seq_len=2048, batch=3)


def _cfgs(seed, n):
    rng = np.random.default_rng(seed)
    raw = ref_cs.default_config() + rng.normal(
        0, 0.2, (n, ref_cs.DIM)).astype(np.float32) * (ref_cs.HI - ref_cs.LO)
    return np.asarray(ref_cs.project(J(raw.astype(np.float32))))


def _assert_metrics_close(got, want, cfg):
    """RTOL/ATOL, but ``mem_overuse_mb`` (differences of near-equal byte
    counts) at RTOL of the terms it cancels, as in test_torch_ppa."""
    o = an.M_IDX["mem_overuse_mb"]
    rest = np.arange(an.M_DIM) != o
    np.testing.assert_allclose(got[:, rest], want[:, rest], rtol=RTOL,
                               atol=ATOL)
    c = lambda n: cfg[:, ref_cs.IDX[n]].astype(np.float64)
    n_cores = want[:, an.M_IDX["n_cores"]].astype(np.float64)
    terms = (n_cores * (c("wmem_kb") + c("dmem_kb")) * 1024.0
             + want[:, an.M_IDX["kv_total_mb"]] * 2.0 ** 20) / 1e6
    np.testing.assert_array_less(np.abs(got[:, o] - want[:, o]),
                                 RTOL * terms + ATOL)


def _node_mat(n, nodes=(3, 7, 28)):
    ps = [node_params(nodes[i % len(nodes)]) for i in range(n)]
    return an.node_matrix(ps)


def test_reward_step_matches_reference():
    wl = _wl().features
    cfg = _cfgs(0, 64)
    node = _node_mat(64)
    metrics = np.asarray(ref_an.evaluate_vec_jit(J(cfg), J(wl), J(node)))
    metrics = metrics.copy()
    rng = np.random.default_rng(1)
    ranges = np.asarray(ref_rw.init_ranges(J(node)))
    ranges = ranges * rng.uniform(0.5, 1.5, ranges.shape).astype(np.float32)
    weights = np.broadcast_to(np.asarray(ref_rw.adaptive_weights(.4, .4, .2),
                                         np.float32), (64, 3)).copy()
    r0, rg0, p0 = ref_rw.reward_step(J(metrics), J(ranges), J(node),
                                     J(weights))
    r1, rg1, p1 = rw.reward_step(T(metrics), T(ranges), T(node), T(weights))
    np.testing.assert_allclose(r1.numpy(), np.asarray(r0), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(rg1.numpy(), np.asarray(rg0))
    assert set(p0) == set(p1)
    for k in p0:
        np.testing.assert_allclose(p1[k].numpy(), np.asarray(p0[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(rw.init_ranges(T(node)).numpy(),
                                  np.asarray(ref_rw.init_ranges(J(node))))


@pytest.mark.parametrize("arch", ["llama3.1-8b", "smolvlm"])
def test_encode_and_stats_match_reference(arch):
    wl = _wl(arch).features
    cfg = _cfgs(2, 48)
    node = _node_mat(48)
    metrics = np.asarray(ref_an.evaluate_vec_jit(J(cfg), J(wl), J(node)))
    want_stats = np.asarray(ref_part.stats_vec(J(cfg), J(wl)))
    got_stats = part.stats_vec(T(cfg), T(wl)).numpy()
    np.testing.assert_allclose(got_stats, want_stats, rtol=RTOL, atol=ATOL)
    want = np.asarray(ref_st.sac_state_vec(ref_st.encode_vec(
        J(wl), J(cfg), J(metrics), J(node), J(want_stats))))
    got = st.sac_state_vec(st.encode_vec(T(wl), T(cfg), T(metrics), T(node),
                                         T(want_stats))).numpy()
    assert got.shape == (48, st.SAC_STATE_DIM)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(st.KEPT_IDX, ref_st.KEPT_IDX)


def test_apply_action_vec_bitwise():
    cfg = _cfgs(3, 64)
    rng = np.random.default_rng(4)
    a_c, a_d = ref_act.random_action_batch(rng, 64)
    delta = ref_act.cont_delta(a_c)
    np.testing.assert_array_equal(act.cont_delta(a_c), delta)
    want = np.asarray(ref_act.apply_action_vec(J(cfg), J(delta), J(a_d)))
    got = act.apply_action_vec(T(cfg), T(delta), T(a_d)).numpy()
    np.testing.assert_array_equal(got, want)
    # the numpy exploration draws are the reference's
    r1 = act.random_action_batch(np.random.default_rng(9), 16)
    r0 = ref_act.random_action_batch(np.random.default_rng(9), 16)
    for a, b in zip(r1, r0):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nodes", [[3] * 16, [3, 5, 7, 10, 14, 22, 28, 3]])
def test_vec_env_reset_and_steps_match_reference(nodes):
    wl = _wl()
    ref = RefVecDSEEnv(wl, nodes, seed=11)
    env = VecDSEEnv(wl, nodes, seed=11, device="cpu")
    b = len(nodes)
    obs0, obs1 = ref.reset(), env.reset()
    np.testing.assert_array_equal(env.cfg.numpy(), np.asarray(ref.cfg))
    np.testing.assert_allclose(obs1, obs0, rtol=RTOL, atol=ATOL)
    rng = np.random.default_rng(5)
    actions = [ref_act.random_action_batch(rng, b) for _ in range(5)]
    for a_c, a_d in actions:
        s0, r0, i0 = ref.step(a_c, a_d)
        s1, r1, i1 = env.step(a_c, a_d)
        np.testing.assert_array_equal(i1.cfg[:, DISCRETE], i0.cfg[:, DISCRETE])
        np.testing.assert_allclose(i1.cfg, i0.cfg, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(i1.feasible, i0.feasible)
        np.testing.assert_allclose(s1, s0, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r1, r0, rtol=RTOL, atol=ATOL)
        _assert_metrics_close(i1.metrics, i0.metrics, i0.cfg)
        np.testing.assert_allclose(i1.partition_stats, i0.partition_stats,
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(env.ranges.numpy(), np.asarray(ref.ranges),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nodes", [[7] * 6, [3, 28, 7, 3]])
def test_vec_env_exact_partition_mode_matches_reference(nodes):
    """``partition_mode="exact"``: the host placement per element, its
    caches and refresh triggers, so the partition stats are the
    reference's bit for bit and the states agree element by element."""
    wl = _wl("smolvlm")
    ref = RefVecDSEEnv(wl, nodes, seed=4, partition_mode="exact",
                       partition_period=3)
    env = VecDSEEnv(wl, nodes, seed=4, partition_mode="exact",
                    partition_period=3, device="cpu")
    np.testing.assert_allclose(env.reset(), ref.reset(), rtol=RTOL,
                               atol=ATOL)
    rng = np.random.default_rng(6)
    for t in range(12):
        a_c, a_d = ref_act.random_action_batch(rng, len(nodes))
        s0, r0, i0 = ref.step(a_c, a_d)
        s1, r1, i1 = env.step(a_c, a_d)
        np.testing.assert_array_equal(i1.cfg[:, DISCRETE], i0.cfg[:, DISCRETE])
        np.testing.assert_array_equal(i1.partition_stats, i0.partition_stats)
        np.testing.assert_allclose(s1, s0, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r1, r0, rtol=RTOL, atol=ATOL)
        if t == 6:
            np.testing.assert_allclose(env.reset(), ref.reset(), rtol=RTOL,
                                       atol=ATOL)
    for p1, p0 in zip(env.partition_results, ref.partition_results):
        np.testing.assert_array_equal(p1.flops_load, p0.flops_load)


def test_vec_env_evaluate_configs_matches_reference():
    wl = _wl("smolvlm")
    ref = RefVecDSEEnv(wl, 7, batch=8, seed=0)
    env = VecDSEEnv(wl, 7, batch=8, seed=0, device="cpu")
    for n in (8, 5):
        cfg = _cfgs(6, n)
        _assert_metrics_close(env.evaluate_configs(cfg),
                              ref.evaluate_configs(cfg), cfg)


def test_vec_env_refuses_unported_modes_and_missing_cuda(monkeypatch):
    wl = _wl()
    # devices (ported since) must divide the batch, as in the reference
    with pytest.raises(ValueError, match="divide evenly"):
        VecDSEEnv(wl, 3, batch=4, devices=3, device="cpu")
    with pytest.raises(ValueError, match="unknown partition_mode"):
        VecDSEEnv(wl, 3, batch=4, partition_mode="nope", device="cpu")
    # the default device is cuda, and without a card that is an error,
    # never a silent move to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VecDSEEnv(wl, 3, batch=4)
