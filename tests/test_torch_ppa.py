"""The port's design space and analytic PPA evaluator against the JAX
reference, on the same random configurations (CPU, float32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.ppa import analytic as ref_an
from repro.ppa import config_space as ref_cs
from repro.ppa.nodes import NODES, node_params
from repro.workload.extract import extract as ref_extract
from repro_torch.configs import get_config
from repro_torch.ppa import analytic as an
from repro_torch.ppa import config_space as cs
from repro_torch.workload.extract import extract

ARCHS = ("llama3.1-8b", "smolvlm")
# float32 elementwise math: XLA and torch may differ by a few ulps in
# exp/log/sqrt/division chains
RTOL, ATOL = 1e-5, 1e-6
FLAG_NAMES = ("feasible", "wmem_ok", "dmem_ok", "power_ok", "area_ok")
OVERUSE = an.M_IDX["mem_overuse_mb"]


def assert_metrics_close(got, want, cfg):
    """Every metric at RTOL/ATOL, except ``mem_overuse_mb``: it is a sum of
    differences of near-equal terms (weight need vs weight memory, KV +
    activations vs DMEM, in bytes), so a one-ulp difference in a term
    shows up at the terms' scale; it is held at RTOL of that scale."""
    proj = np.asarray(ref_cs.project(jnp.asarray(cfg)))
    c = lambda n: proj[:, ref_cs.IDX[n]].astype(np.float64)
    n_cores = np.round(c("mesh_w")) * np.round(c("mesh_h"))
    kv_bytes = want[:, an.M_IDX["kv_total_mb"]].astype(np.float64) * 2 ** 20
    terms = (n_cores * c("wmem_kb") * 1024.0
             + n_cores * c("dmem_kb") * 1024.0 + kv_bytes) / 1e6
    rest = np.arange(an.M_DIM) != OVERUSE
    np.testing.assert_allclose(got[:, rest], want[:, rest], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_less(np.abs(got[:, OVERUSE] - want[:, OVERUSE]),
                                 RTOL * terms + ATOL)


def _random_cfgs(seed, n):
    rng = np.random.default_rng(seed)
    span = ref_cs.HI - ref_cs.LO
    # a spread around the bounds (clipping exercised) plus points near the
    # default design, where most of the search spends its time
    wide = rng.uniform(ref_cs.LO - 0.1 * span, ref_cs.HI + 0.1 * span,
                       size=(n // 2, ref_cs.DIM))
    near = ref_cs.default_config() + rng.normal(
        0, 0.15, size=(n - n // 2, ref_cs.DIM)) * span * 0.3
    return np.concatenate([wide, near]).astype(np.float32)


def test_config_space_tables_and_default():
    for name in ("LO", "HI", "STEP"):
        np.testing.assert_array_equal(getattr(cs, name), getattr(ref_cs, name))
    assert cs.IDX == ref_cs.IDX and cs.DIM == ref_cs.DIM
    np.testing.assert_array_equal(cs.default_config(),
                                  ref_cs.default_config())


@pytest.mark.parametrize("fn", ["clip", "quantize", "project"])
def test_config_space_projection_bitwise(fn):
    cfg = _random_cfgs(1, 512)
    # exact half-steps: jnp.round and torch.round both round half to even
    cfg[:8, :4] = np.array([2.5, 3.5, 4.5, 5.5], np.float32)
    want = np.asarray(getattr(ref_cs, fn)(jnp.asarray(cfg)))
    got = getattr(cs, fn)(torch.as_tensor(cfg)).numpy()
    np.testing.assert_array_equal(got, want)


def test_workload_features_and_tables_match():
    for arch in ARCHS:
        for phase in ("decode", "prefill"):
            a = ref_extract(ref_get_config(arch), seq_len=2048, batch=3,
                            phase=phase)
            b = extract(get_config(arch), seq_len=2048, batch=3, phase=phase)
            np.testing.assert_array_equal(a.features, b.features)
    assert an.M_IDX == ref_an.M_IDX and an.NODE_IDX == ref_an.NODE_IDX
    for hp in (True, False):
        nodes = [node_params(n, low_power=not hp) for n in NODES]
        np.testing.assert_array_equal(
            an.node_matrix(nodes, high_perf=hp),
            ref_an.node_matrix(nodes, high_perf=hp))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("high_perf", [True, False])
def test_evaluate_vec_matches_reference(arch, high_perf):
    """Random configs x every node, per-row node constants."""
    wl = extract(get_config(arch), seq_len=2048, batch=3).features
    nodes = [node_params(n, low_power=not high_perf) for n in NODES]
    n_per = 48
    node_mat = np.repeat(an.node_matrix(nodes, high_perf=high_perf), n_per,
                         axis=0)
    cfg = _random_cfgs(7 + int(high_perf), len(node_mat))
    want = np.asarray(ref_an.evaluate_vec_jit(
        jnp.asarray(cfg), jnp.asarray(wl), jnp.asarray(node_mat)))
    got = an.evaluate_vec(torch.as_tensor(cfg), torch.as_tensor(wl),
                          torch.as_tensor(node_mat)).numpy()
    assert got.shape == want.shape == (len(cfg), an.M_DIM)
    assert np.isfinite(got).all()
    for name in FLAG_NAMES:
        i = an.M_IDX[name]
        np.testing.assert_array_equal(got[:, i], want[:, i], err_msg=name)
    assert_metrics_close(got, want, cfg)


def test_evaluate_one_point_and_batch_forms():
    """One node vector broadcast over many configs (the reference's
    ``evaluate_batch``) and a single design point (``evaluate_jit``)."""
    wl = extract(get_config("smolvlm"), seq_len=2048, batch=3).features
    node = an.node_vector(node_params(7), high_perf=True)
    cfg = _random_cfgs(3, 64)
    want = np.asarray(ref_an.evaluate_batch(jnp.asarray(cfg), jnp.asarray(wl),
                                            jnp.asarray(node)))
    got = an.evaluate_batch(torch.as_tensor(cfg), torch.as_tensor(wl),
                            torch.as_tensor(node)).numpy()
    assert_metrics_close(got, want, cfg)
    one = an.evaluate(torch.as_tensor(cfg[5]), torch.as_tensor(wl),
                      torch.as_tensor(node)).numpy()
    np.testing.assert_allclose(one, np.asarray(ref_an.evaluate_jit(
        jnp.asarray(cfg[5]), jnp.asarray(wl), jnp.asarray(node))),
        rtol=RTOL, atol=ATOL)


def test_paper_anchor_design_is_feasible_on_both():
    """The paper's 3 nm Llama 3.1 8B design evaluates alike in both."""
    wl = extract(get_config("llama3.1-8b"), seq_len=2048, batch=3).features
    node = an.node_vector(node_params(3), high_perf=True)
    cfg = ref_cs.paper_llama_3nm_config()
    want = np.asarray(ref_an.evaluate_jit(jnp.asarray(cfg), jnp.asarray(wl),
                                          jnp.asarray(node)))
    got = an.evaluate(torch.as_tensor(cfg), torch.as_tensor(wl),
                      torch.as_tensor(node)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[an.M_IDX["feasible"]] == want[an.M_IDX["feasible"]]
