"""The port on the card: each CUDA kernel against its plain PyTorch version
at the main path's shapes and ragged ones, the batched env step on the card
against the CPU, and the search's determinism guarantees on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU; the
file imports no JAX, so it runs on a machine that has only PyTorch:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``."""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import mpc, sac
from repro_torch.core import world_model as wm
from repro_torch.core.networks import to_device
from repro_torch.core.env import VecDSEEnv
from repro_torch.core.search import SearchConfig, run_search
from repro_torch.kernels import actor_moe, ops, screen_score
from repro_torch.ppa import analytic as an
from repro_torch.ppa import surrogate as sur
from repro_torch.workload.extract import extract

# fp32 with sums in another order than the plain version's
RTOL, ATOL = 1e-4, 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see README: tests on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("b", [1, 33, 64, 192])
@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_actor_kernel_matches_plain(dev, b, scale):
    actor = sac.create(0, dev).params.actor
    if scale != 1.0:     # larger heads: exercise the tanh and the clip
        actor = {k: ({"w": v["w"] * scale, "b": v["b"]} if k in (
            "disc", "mu", "log_std") else v) for k, v in actor.items()}
    s = torch.randn((b, 52), generator=_gen(dev, b), device=dev)
    before = actor_moe.launches
    got = actor_moe.actor_forward(actor, s)
    torch.cuda.synchronize()
    assert actor_moe.launches == before + 1
    with torch.no_grad():
        want = actor_moe.actor_forward_plain(actor, s)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    for g, a in zip(got, actor_moe.actor_forward(actor, s)):
        assert torch.equal(g, a)          # deterministic


@pytest.mark.parametrize("b,k", [(64, 4), (33, 4), (7, 8), (5, 1)])
def test_screen_kernel_matches_plain(dev, b, k):
    params = sur.Surrogate.create(82, seed=2, device=dev).params
    g = _gen(dev, b * 10 + k)
    s = torch.randn((b, 52), generator=g, device=dev)
    cand = torch.rand((b, k, 30), generator=g, device=dev) * 2 - 1
    w = torch.softmax(torch.randn((b, 3), generator=g, device=dev), -1)
    before = screen_score.launches
    got = screen_score.screen_scores(params, s, cand, w)
    torch.cuda.synchronize()
    assert screen_score.launches == before + 1
    with torch.no_grad():
        want = screen_score.screen_scores_plain(params, s, cand, w)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, screen_score.screen_scores(params, s, cand, w))


def test_wrappers_check_their_inputs(dev):
    actor = sac.create(0, dev).params.actor
    with pytest.raises(ValueError, match="actor_moe"):
        actor_moe.actor_forward(actor, torch.zeros((4, 51), device=dev))
    with pytest.raises(ValueError, match="actor_moe"):
        actor_moe.actor_forward(actor, torch.zeros((4, 52), device=dev,
                                                   dtype=torch.float64))
    params = sur.Surrogate.create(82, seed=2, device=dev).params
    s = torch.zeros((4, 52), device=dev)
    with pytest.raises(ValueError, match="K must be"):
        screen_score.screen_scores(params, s, torch.zeros((4, 9, 30),
                                                          device=dev),
                                   torch.zeros((4, 3), device=dev))


def test_env_step_on_card_matches_cpu(dev):
    wl = extract(get_config("llama3.1-8b"), seq_len=2048, batch=3)
    gpu = VecDSEEnv(wl, [3, 5, 7, 28] * 16, seed=0, device=dev)
    cpu = VecDSEEnv(wl, [3, 5, 7, 28] * 16, seed=0, device="cpu")
    np.testing.assert_allclose(gpu.reset(), cpu.reset(), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(gpu.cfg.cpu(), cpu.cfg)
    rng = np.random.default_rng(1)
    keep = np.arange(an.M_DIM) != an.M_IDX["mem_overuse_mb"]
    for _ in range(5):
        a_c = rng.uniform(-1, 1, (64, 30)).astype(np.float32)
        a_d = rng.integers(0, 5, (64, 4)).astype(np.int32)
        s_g, r_g, i_g = gpu.step(a_c, a_d)
        s_c, r_c, i_c = cpu.step(a_c, a_d)
        np.testing.assert_array_equal(i_g.feasible, i_c.feasible)
        np.testing.assert_allclose(s_g, s_c, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r_g, r_c, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(i_g.metrics[:, keep], i_c.metrics[:, keep],
                                   rtol=1e-5, atol=1e-6)


def test_mpc_plan_on_card_matches_cpu(dev):
    nets_cpu = [sac.create(0, "cpu").params.actor,
                wm.create(1, "cpu").params,
                sur.Surrogate.create(82, seed=2).params]
    g = torch.Generator().manual_seed(0)
    s = torch.randn((64, 52), generator=g)
    noise = torch.randn((64, mpc.K_CANDIDATES, 30), generator=g)
    want = mpc.plan(*nets_cpu, s, noise=noise)
    got = mpc.plan(*[to_device(t, dev) for t in nets_cpu], s.to(dev),
                   noise=noise.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)


def _short(**kw):
    wl = extract(get_config("llama3.1-8b"), seq_len=2048, batch=3)
    sc = SearchConfig(**{**dict(episodes=640, seed=0, batch_size=64,
                                warmup=64), **kw})
    r = run_search(wl, 3, search=sc, n_envs=64, device="cuda")
    return r, json.dumps(dict(
        archive=[e.to_dict() for e in r.archive.entries],
        trace=[t.__dict__ for t in r.trace],
        best=None if r.best_cfg is None else r.best_cfg.tolist()))


def test_search_on_card_is_deterministic_and_uses_the_kernels(dev):
    ops.reset_launch_counts()
    r, a = _short(gate_threshold=1e9)
    counts = ops.launch_counts()
    assert counts["actor_moe"] >= 10 and counts["screen_score"] > 0
    assert r.gate_open_episode is not None
    assert a == _short(gate_threshold=1e9)[1]
    assert _short(gate_threshold=0.0)[1] == _short(surrogate_gate=False)[1]
