"""The port's scalar engine and baselines against the JAX reference on the
CPU: the config-space helpers and the paper's anchor designs, the host
reward model and encoder, the scalar ``DSEEnv`` stepped on the same
actions, ``policy_act`` / ``policy_mean`` and ``mpc.refine`` on the
reference's weights and draws, the random and grid baselines (the
reference's configurations and archive), and ``run_sac`` (same-seed runs
identical; every archived and chosen design re-evaluated by the
reference)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import actions as ref_act
from repro.core import mpc as ref_mpc
from repro.core import reward as ref_rw
from repro.core import sac as ref_sac
from repro.core import search as ref_search
from repro.core import state as ref_st
from repro.core.env import DSEEnv as RefDSEEnv
from repro.core.state import SAC_STATE_DIM
from repro.ppa import analytic as ref_an
from repro.ppa import config_space as ref_cs
from repro.ppa.nodes import node_params as ref_node_params
from repro.workload.extract import extract as ref_extract
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import actions as act
from repro_torch.core import mpc
from repro_torch.core import networks as nets
from repro_torch.core import reward as rw
from repro_torch.core import sac
from repro_torch.core import search
from repro_torch.core import state as st
from repro_torch.core.env import DSEEnv
from repro_torch.kernels import ops
from repro_torch.ppa import analytic as an
from repro_torch.ppa import config_space as cs
from repro_torch.workload.extract import extract

RTOL, ATOL = 1e-5, 1e-6
T = torch.as_tensor
J = jnp.asarray
np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _wls(arch="llama3.1-8b", **kw):
    kw = dict(dict(seq_len=2048, batch=3), **kw)
    return (extract(get_config(arch), **kw),
            ref_extract(ref_get_config(arch), **kw))


def _ref_eval(cfgs, wl, node_nm, high_perf=True):
    node = ref_an.node_vector(ref_node_params(node_nm,
                                              low_power=not high_perf),
                              high_perf=high_perf)
    return np.asarray(ref_an.evaluate_batch(
        ref_cs.project(J(np.asarray(cfgs, np.float32))), J(wl.features),
        J(node)))


def _assert_metrics_close(got, want):
    """RTOL/ATOL but ``mem_overuse_mb``, a difference of near-equal byte
    counts (held at RTOL of its terms in test_torch_ppa)."""
    keep = np.arange(an.M_DIM) != an.M_IDX["mem_overuse_mb"]
    np.testing.assert_allclose(np.asarray(got)[..., keep],
                               np.asarray(want)[..., keep], rtol=RTOL,
                               atol=ATOL)


# ----------------------------------------------------------- config space
@pytest.mark.parametrize("name", ["default_config", "paper_llama_3nm_config",
                                  "paper_smolvlm_3nm_config"])
def test_anchor_configs_equal_the_reference(name):
    got, want = getattr(cs, name)(), getattr(ref_cs, name)()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for f_max in (1e9, 3.2e9, 4e6):
        np.testing.assert_array_equal(cs.paper_smolvlm_config(f_max),
                                      ref_cs.paper_smolvlm_config(f_max))


def test_config_helpers_match_the_reference():
    cfg = ref_cs.paper_llama_3nm_config()
    assert cs.to_dict(cfg) == ref_cs.to_dict(cfg)
    np.testing.assert_array_equal(cs.from_dict(cs.to_dict(cfg)), cfg)
    np.testing.assert_array_equal(cs.from_dict({"vlen": 1024.0}),
                                  ref_cs.from_dict({"vlen": 1024.0}))
    assert cs.get(cfg, "mesh_w") == ref_cs.get(cfg, "mesh_w") == 41
    new = cs.set_field(cfg, "vlen", 256.0)
    np.testing.assert_array_equal(new, np.asarray(
        ref_cs.set_field(J(cfg), "vlen", 256.0)))
    assert cfg[cs.IDX["vlen"]] == 1536          # a copy, as jax's .at[]
    t = cs.set_field(T(cfg), "fetch", 3.0)
    assert isinstance(t, torch.Tensor) and float(t[cs.IDX["fetch"]]) == 3.0
    g, rg = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(200):
        np.testing.assert_array_equal(cs.random_config(g),
                                      ref_cs.random_config(rg))


# ------------------------------------------------- reward, encoder, action
def test_reward_model_matches_the_reference():
    wl, rwl = _wls()
    cfgs = np.stack([ref_cs.random_config(np.random.default_rng(i))
                     for i in range(40)])
    metrics = _ref_eval(cfgs, rwl, 3)
    node = ref_node_params(3)
    kw = dict(power_budget_mw=node.power_budget_mw,
              area_budget_mm2=node.area_budget_mm2, w_perf=0.2, w_power=0.6,
              w_area=0.2)
    got, want = rw.RewardModel(**kw), ref_rw.RewardModel(**kw)
    for m in metrics:
        (r1, p1), (r2, p2) = got(m), want(m)
        assert r1 == r2 and p1 == p2
    for name in ("perf_rng", "power_rng", "area_rng"):
        assert dataclasses.asdict(getattr(got, name)) == \
            dataclasses.asdict(getattr(want, name))


def test_encode_and_apply_action_match_the_reference():
    wl, rwl = _wls("smolvlm")
    rng = np.random.default_rng(4)
    node = ref_an.node_vector(ref_node_params(7))
    cfg = ref_cs.default_config()
    for _ in range(20):
        a_c, a_d = ref_act.random_action(rng)
        new = act.apply_action(cfg, a_c, a_d)
        np.testing.assert_array_equal(new,
                                      ref_act.apply_action(cfg, a_c, a_d))
        m = _ref_eval(new[None], rwl, 7)[0]
        ps = rng.random(8).astype(np.float32)
        s73 = st.encode(np.asarray(rwl.features), new, m, node, ps)
        np.testing.assert_array_equal(s73, ref_st.encode(
            np.asarray(rwl.features), new, m, node, ps))
        np.testing.assert_array_equal(st.sac_state(s73),
                                      ref_st.sac_state(s73))
        cfg = new
    assert act.random_action(np.random.default_rng(1))[0].tolist() == \
        ref_act.random_action(np.random.default_rng(1))[0].tolist()


# ------------------------------------------------------------- scalar env
@pytest.mark.parametrize("arch,node,high_perf", [
    ("llama3.1-8b", 3, True), ("smolvlm", 28, False),
    ("mixtral-8x7b", 7, True)])
def test_dse_env_steps_match_the_reference(arch, node, high_perf):
    wl, rwl = _wls(arch)
    env = DSEEnv(wl, node, high_perf=high_perf, seed=5, device="cpu")
    ref = RefDSEEnv(rwl, node, high_perf=high_perf, seed=5)
    np.testing.assert_allclose(env.reset(), ref.reset(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(env.cfg, ref.cfg)
    rng = np.random.default_rng(9)
    for t in range(60):
        a_c, a_d = ref_act.random_action(rng)
        s, r, info = env.step(a_c, a_d)
        s_r, r_r, info_r = ref.step(a_c, a_d)
        np.testing.assert_array_equal(info.cfg, info_r.cfg)
        np.testing.assert_allclose(s, s_r, rtol=RTOL, atol=ATOL)
        assert r == pytest.approx(r_r, rel=RTOL, abs=ATOL)
        assert info.feasible == info_r.feasible
        np.testing.assert_array_equal(info.partition_stats,
                                      info_r.partition_stats)
        _assert_metrics_close(info.metrics, info_r.metrics)
        if t == 30:
            np.testing.assert_allclose(env.reset(), ref.reset(), rtol=RTOL,
                                       atol=ATOL)
    for name in ("perf_rng", "power_rng", "area_rng"):
        a = dataclasses.asdict(getattr(env.reward_model, name))
        b = dataclasses.asdict(getattr(ref.reward_model, name))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=RTOL, abs=ATOL)
    cfg = ref_cs.paper_llama_3nm_config()
    _assert_metrics_close(env.evaluate_config(cfg), ref.evaluate_config(cfg))


# ----------------------------------------------------- policy, MPC blend
def _ref_sac(seed=0):
    stt = ref_sac.create(seed)
    tree = {f: np_tree(getattr(stt.params, f))
            for f in ref_sac.SACParams._fields}
    return stt, convert.sac_params(tree)


def test_policy_act_and_mean_match_the_reference():
    stt, port = _ref_sac(3)
    rng = np.random.default_rng(2)
    for i in range(5):
        s = rng.normal(0, 1, SAC_STATE_DIM).astype(np.float32)
        key = jax.random.PRNGKey(i)
        kc, kd = jax.random.split(key)
        noise = nets.PolicyNoise(
            T(np.asarray(jax.random.normal(kc, (1, act.N_CONT)))),
            T(np.asarray(jax.random.gumbel(kd, (1, act.N_DISC, 5)))))
        a_r, d_r = ref_sac.policy_act(stt.params.actor, J(s), key)
        a, d = sac.policy_act(port.actor, T(s), noise=noise)
        assert a.shape == (act.N_CONT,) and d.shape == (act.N_DISC,)
        np.testing.assert_allclose(a.numpy(), np.asarray(a_r), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(d.numpy(), np.asarray(d_r))
        mu_r, dm_r = ref_sac.policy_mean(stt.params.actor, J(s))
        mu, dm = sac.policy_mean(port.actor, T(s))
        np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_array_equal(dm.numpy(), np.asarray(dm_r))


def test_mpc_refine_matches_the_reference():
    rng = np.random.default_rng(8)
    for _ in range(10):
        a_sac, a_mpc = (rng.uniform(-1, 1, act.N_CONT).astype(np.float32)
                        for _ in range(2))
        got = mpc.refine(T(a_sac), T(a_mpc))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref_mpc.refine(J(a_sac), J(a_mpc))))
        np.testing.assert_array_equal(got.numpy()[mpc.TCC_ACTION_DIMS:],
                                      a_sac[mpc.TCC_ACTION_DIMS:])


# -------------------------------------------------------------- baselines
def _assert_same_archive(got, want):
    assert len(got.archive) == len(want.archive) > 0
    for e, f in zip(got.archive.entries, want.archive.entries):
        np.testing.assert_array_equal(e.cfg, f.cfg)
        assert e.episode == f.episode
        for k in ("power_mw", "perf_gops", "area_mm2", "tok_s", "ppa_score"):
            assert getattr(e, k) == pytest.approx(getattr(f, k), rel=RTOL,
                                                  abs=ATOL)


@pytest.mark.parametrize("method,node,high_perf", [
    ("run_random", 3, True), ("run_random", 14, True),
    ("run_grid", 3, True), ("run_grid", 22, True)])
def test_baselines_match_the_reference(method, node, high_perf):
    wl, rwl = _wls()
    ops.reset_launch_counts()
    got = getattr(search, method)(wl, node, high_perf=high_perf,
                                  episodes=400, seed=2, device="cpu")
    want = getattr(ref_search, method)(rwl, node, high_perf=high_perf,
                                       episodes=400, seed=2)
    assert set(ops.launch_counts().values()) == {0}
    assert got.method == want.method == method[4:]
    for k in ("episodes_run", "feasible_count", "unique_configs",
              "screened", "evaluated"):
        assert getattr(got, k) == getattr(want, k), k
    np.testing.assert_array_equal(got.best_cfg, want.best_cfg)
    _assert_metrics_close(got.best_metrics, want.best_metrics)
    _assert_same_archive(got, want)
    assert [(p.episode, p.unique_configs, p.feasible_count)
            for p in got.trace] == [(p.episode, p.unique_configs,
                                     p.feasible_count) for p in want.trace]


# ------------------------------------------------------------ scalar SAC
@pytest.fixture(scope="module")
def sac_runs():
    """Two same-seed scalar runs on node 3: learning from step 32 on at a
    small batch, the surrogate every 8 steps, a reset every 60."""
    wl, rwl = _wls("smolvlm")
    sc = search.SearchConfig(episodes=140, seed=1, warmup=32, batch_size=32,
                             wm_batch=32, reset_period=60)
    ops.reset_launch_counts()
    runs = [search.run_sac(wl, 3, search=sc, device="cpu") for _ in range(2)]
    return rwl, runs, ops.launch_counts()


def _fingerprint(res):
    return json.dumps(dict(
        archive=[e.to_dict() for e in res.archive.entries],
        trace=[dataclasses.asdict(p) for p in res.trace],
        best=None if res.best_cfg is None else res.best_cfg.tolist(),
        counts=[res.episodes_run, res.feasible_count, res.unique_configs]))


def test_run_sac_same_seed_is_bitwise(sac_runs):
    _, (a, b), counts = sac_runs
    assert _fingerprint(a) == _fingerprint(b)
    assert a.method == "sac" and a.episodes_run == 140
    assert len(a.trace) == 4 and a.trace[-1].episode == 139
    assert a.trace[-1].entropy != 0.0          # the learner ran
    assert len(a.dispatch_s) == 140
    assert set(counts.values()) == {0}         # CPU: plain versions only


def test_run_sac_designs_re_evaluated_by_the_reference(sac_runs):
    rwl, (res, _), _ = sac_runs
    assert res.feasible_count > 0 and len(res.archive) > 0
    want = _ref_eval(np.stack([e.cfg for e in res.archive.entries]), rwl, 3)
    for e, m in zip(res.archive.entries, want):
        assert m[ref_an.M_IDX["feasible"]] == 1.0
        assert e.ppa_score == pytest.approx(
            float(m[ref_an.M_IDX["ppa_score"]]), rel=RTOL, abs=ATOL)
    _assert_metrics_close(res.best_metrics, _ref_eval(res.best_cfg[None],
                                                      rwl, 3)[0])
    assert res.hetero is not None
    sel = res.archive.select(0.4, 0.4, 0.2)
    np.testing.assert_array_equal(res.best_cfg, sel.cfg)


def test_run_all_nodes_runs_the_scalar_loop_per_node():
    wl, _ = _wls("smolvlm")
    sc = search.SearchConfig(episodes=6, seed=0, warmup=1000)
    out = search.run_all_nodes(wl, [3, 28], search=sc, device="cpu")
    assert sorted(out) == [3, 28]
    assert all(r.method == "sac" and r.episodes_run == 6 and r.node_nm == n
               for n, r in out.items())
