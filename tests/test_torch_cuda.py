"""The port on the card: each CUDA kernel against its plain PyTorch version
at the main path's shapes and ragged ones, the device PER on the card
against the same buffer on the CPU, the batched env step on the card
against the CPU, the search's determinism guarantees on the card, and a
short campaign that launches every search kernel and resumes
bit-for-bit, a scenario campaign (SLO selection) and the scalar act path
against the same on the CPU, and the LM kernels (``flash_attention``,
``ssm_scan``, the windowed Mixtral shape among them) and reduced LM
generation on the card against the same on the CPU, ``devices=1``
bitwise ``devices=None``, a W=2 fleet of two processes on the card
fingerprinting as the W=1 campaign, ``fused_mlp`` at the index
surrogate's serving widths and the recommender on the card against the
CPU, and the two backward kernels (``flash_attention_backward``,
``ssm_scan_backward``) against autograd over the plain versions, bitwise
repeatable, with the operators' autograd running both kernels; the
``torch.library`` operators on the card against the CPU (their fake
implementations' shapes too) and on a DTensor mesh, two steps on a 1x1
NCCL mesh against the one-device path, and a NCCL start that must
fail.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU; the
file imports no JAX, so it runs on a machine that has only PyTorch:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``."""
import json
import os

import numpy as np
import pytest
import torch

import repro_torch.core.search as search_mod
from repro_torch.campaign import CampaignSpec, CampaignStore, run_campaign
from repro_torch.configs import get_config
from repro_torch.core import mpc, replay, sac
from repro_torch.core import world_model as wm
from repro_torch.core.networks import to_device
from repro_torch.core.env import VecDSEEnv
from repro_torch.core.search import SearchConfig, run_search
from repro_torch.kernels import (actor_moe, flash_attention, ops,
                                  policy_mlp, screen_score, ssm_scan, sumtree,
                                  sumtree_sample)
from repro_torch.configs import get_reduced
from repro_torch.launch.serve import generate
from repro_torch.models import lm
from repro_torch.ppa import analytic as an
from repro_torch.ppa import surrogate as sur
from repro_torch.workload.extract import extract

# fp32 with sums in another order than the plain version's
RTOL, ATOL = 1e-4, 1e-5
SEARCH_KERNELS = ("actor_moe", "screen_score", "sumtree", "sumtree_sample",
                  "fused_mlp")

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


@pytest.mark.parametrize("b,k", [(64, 4), (33, 4), (7, 8), (5, 1),
                                 (448, 4), (64, 8), (3, 3), (1, 1)])
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


@pytest.mark.parametrize("b,k", [(64, 4), (33, 3), (5, 7)])
def test_screen_kernel_takes_unaligned_rows(dev, b, k):
    """s and cand one float off their 16- and 8-byte boundaries: the kernel
    gathers the rows in 4-byte pieces instead of 16- and 8-byte ones and
    still matches the plain version."""
    params = sur.Surrogate.create(82, seed=2, device=dev).params
    g = _gen(dev, 11 * b + k)
    s = torch.randn(b * 52 + 1, generator=g, device=dev)[1:].view(b, 52)
    cand = (torch.rand(b * k * 30 + 1, generator=g, device=dev) * 2
            - 1)[1:].view(b, k, 30)
    w = torch.softmax(torch.randn((b, 3), generator=g, device=dev), -1)
    got = screen_score.screen_scores(params, s, cand, w)
    with torch.no_grad():
        want = screen_score.screen_scores_plain(params, s, cand, w)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,k", [(64, 4), (448, 4), (33, 6)])
def test_screen_batch_kernel_picks_match_plain(dev, b, k):
    """screen_batch through the kernel, half the gates open, picks the
    plain scores' argmin wherever an env's two best plain scores are well
    apart (1e-3, a hundred times the kernel's tolerance), and 0 where the
    gate is closed."""
    params = sur.Surrogate.create(82, seed=2, device=dev).params
    g = _gen(dev, 7 * b + k)
    s = torch.randn((b, 52), generator=g, device=dev)
    cand = torch.rand((b, k, 30), generator=g, device=dev) * 2 - 1
    w = torch.softmax(torch.randn((b, 3), generator=g, device=dev), -1)
    mask = torch.arange(b, device=dev) % 2 == 0
    before = screen_score.launches
    pick = sur.screen_batch(params, s, cand, w, mask)
    assert screen_score.launches == before + 1
    with torch.no_grad():
        plain = screen_score.screen_scores_plain(params, s, cand, w)
    two = plain.topk(2, dim=1, largest=False).values
    apart = two[:, 1] - two[:, 0] > 1e-3
    assert int(apart.sum()) >= b // 2
    want = torch.where(mask, plain.argmin(1), torch.zeros_like(pick))
    assert torch.equal(pick[apart], want[apart])
    assert (pick[~mask] == 0).all()


def test_policy_act_goes_through_the_actor_kernel_at_b1(dev):
    """The scalar engine's act path: ``sac.policy_act`` on one state is one
    ``actor_moe`` launch at B = 1, and with the same noise picks the CPU
    path's actions."""
    from repro_torch.core import networks as nets
    actor_cpu = sac.create(0, "cpu").params.actor
    actor = to_device(actor_cpu, dev)
    g = torch.Generator().manual_seed(4)
    for _ in range(4):
        s = torch.randn(52, generator=g)
        noise = nets.draw_policy_noise(1, g, "cpu")
        before = actor_moe.launches
        a, d = sac.policy_act(actor, s.to(dev), noise=nets.PolicyNoise(
            noise.normal.to(dev), noise.gumbel.to(dev)))
        torch.cuda.synchronize()
        assert actor_moe.launches == before + 1
        a_c, d_c = sac.policy_act(actor_cpu, s, noise=noise)
        torch.testing.assert_close(a.cpu(), a_c, rtol=RTOL, atol=ATOL)
        assert torch.equal(d.cpu(), d_c)
        mu, dm = sac.policy_mean(actor, s.to(dev))
        mu_c, dm_c = sac.policy_mean(actor_cpu, s)
        torch.testing.assert_close(mu.cpu(), mu_c, rtol=RTOL, atol=ATOL)


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


@pytest.mark.parametrize("cap", [8, 100, 257, 100_000])
@pytest.mark.parametrize("n", [1, 64, 256, 448, 1500])
def test_sumtree_kernel_matches_plain_bitwise(dev, cap, n):
    """Both are float64 sums of final children, so bitwise; duplicates are
    last-write-wins and N > 1024 is split into ordered launches."""
    rng = np.random.default_rng(cap + n)
    base = replay.SumTree(cap)
    base.set_many(np.arange(cap), rng.random(cap))
    idx = rng.integers(0, cap, n)
    idx[-1] = idx[0]
    for vals in (rng.random(n), 0.25):
        want = torch.as_tensor(base.tree.copy())
        sumtree.sumtree_set_many_plain(want, torch.as_tensor(idx), vals if
                                       np.ndim(vals) == 0 else
                                       torch.as_tensor(vals))
        got = torch.as_tensor(base.tree.copy(), device=dev)
        before = sumtree.launches
        sumtree.sumtree_set_many(got, torch.as_tensor(idx, device=dev),
                                 vals if np.ndim(vals) == 0 else
                                 torch.as_tensor(vals, device=dev))
        torch.cuda.synchronize()
        assert sumtree.launches == before + -(-n // sumtree.MAX_N)
        assert torch.equal(got.cpu(), want)
        assert float(got[1]) == pytest.approx(float(got[cap:].sum()),
                                              rel=1e-12)


def _sumtree_index_sets(cap, n, rng):
    """Random indices; all N writes to one index; and (N >= 4) the leaves
    first and last in the kernel's sorted order (leaf aligned to the
    deepest level) written again at the end, with an out-of-range index in
    the middle."""
    lmax = (2 * cap - 1).bit_length() - 1
    yield rng.integers(0, cap, n)
    yield np.full(n, rng.integers(0, cap))
    if n >= 4:
        idx = rng.integers(0, cap, n)
        aligned = [int(x) << (lmax - (int(x).bit_length() - 1))
                   for x in idx + cap]
        idx[-1] = idx[int(np.argmin(aligned))]
        idx[-2] = idx[int(np.argmax(aligned))]
        idx[n // 2] = cap if n % 2 else -1
        yield idx


@pytest.mark.parametrize("cap", [1, 8, 100, 257, 100_000, 2 ** 21 + 3])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 448, 1024, 1025])
def test_sumtree_kernel_matches_host_sumtree_bitwise(dev, cap, n):
    """The kernel against the host float64 ``SumTree.set_many``, bitwise,
    on a tree whose inner nodes are not the sums of their children (an
    untouched node keeps its value): duplicates at a run's ends, one index
    written N times, an out-of-range index, per-write values and a scalar;
    N > 1024 in two ordered launches.  A capacity above 2^20 takes the
    64-bit keys and loads the upper levels' siblings in the loop."""
    rng = np.random.default_rng(cap * 31 + n)
    base = rng.random(2 * cap)
    for idx in _sumtree_index_sets(cap, n, rng):
        for vals in (rng.random(n), 0.25):
            host = replay.SumTree(cap)
            host.tree = base.copy()
            keep = (idx >= 0) & (idx < cap)
            host.set_many(idx[keep], vals[keep] if np.ndim(vals) else vals)
            got = torch.as_tensor(base, device=dev)
            before = sumtree.launches
            sumtree.sumtree_set_many(
                got, torch.as_tensor(idx, device=dev),
                torch.as_tensor(vals, device=dev) if np.ndim(vals) else vals)
            torch.cuda.synchronize()
            assert sumtree.launches == before + -(-n // sumtree.MAX_N)
            np.testing.assert_array_equal(got.cpu().numpy(), host.tree)


@pytest.mark.parametrize("b", [1, 7, 8, 9, 33, 64, 192, 448, 4096])
def test_actor_kernel_one_launch_repeatable(dev, b):
    """One launch per call at every row tiling (ragged tiles, the search's,
    the campaign's and the MPC rollouts' batches), within rtol 1e-4 / atol
    1e-5 of the plain version, and bitwise equal on a repeat."""
    actor = sac.create(1, dev).params.actor
    s = torch.randn((b, 52), generator=_gen(dev, 1000 + b), device=dev)
    before = actor_moe.launches
    got = actor_moe.actor_forward(actor, s)
    torch.cuda.synchronize()
    assert actor_moe.launches == before + 1
    with torch.no_grad():
        want = actor_moe.actor_forward_plain(actor, s)
    for g, w, a in zip(got, want, actor_moe.actor_forward(actor, s)):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
        assert torch.equal(g, a)


def test_actor_kernel_refuses_unaligned_tensors(dev):
    """The kernel copies with 16-byte cp.async: a contiguous view that
    starts off a 16-byte boundary is refused, not read."""
    actor = sac.create(0, dev).params.actor
    w = actor["l2"]["w"]
    flat = torch.empty(w.numel() + 1, device=dev)
    shifted = flat[1:].view(w.shape)
    shifted.copy_(w)
    bad = dict(actor, l2={"w": shifted, "b": actor["l2"]["b"]})
    with pytest.raises(ValueError, match="16-byte aligned"):
        actor_moe.actor_forward(bad, torch.zeros((4, 52), device=dev))


@pytest.mark.parametrize("cap", [1, 8, 257, 100_000])
@pytest.mark.parametrize("n", [1, 256, 448])
def test_sumtree_sample_kernel_matches_plain_bitwise(dev, cap, n):
    """The descent kernel against the plain descent and the host walk:
    integer leaves, so prefix sums land on boundaries and some leaves are
    zero; both leaf levels of a non-power-of-two tree; the size clamp."""
    rng = np.random.default_rng(cap * 7 + n)
    host = replay.SumTree(cap)
    host.set_many(np.arange(cap), rng.integers(0, 4, cap).astype(np.float64))
    size = max(1, cap // 2)
    u = rng.random(n)
    before = sumtree_sample.launches
    got = sumtree_sample.sumtree_sample(
        torch.as_tensor(host.tree, device=dev),
        torch.as_tensor(u, device=dev), size)
    torch.cuda.synchronize()
    assert sumtree_sample.launches == before + 1
    want = sumtree_sample.sumtree_sample_plain(
        torch.as_tensor(host.tree), torch.as_tensor(u), size)
    assert torch.equal(got.cpu(), want)
    walk = np.minimum([host.sample(float(v)) for v in
                       (np.arange(n) + u) * (host.total() / n)], size - 1)
    np.testing.assert_array_equal(got.cpu().numpy(), walk)


# every depth from 1 to 20 (so every length of the last round of the
# kernel's 6-level rounds), leaves on two levels (257, 100,000, 200,000);
# N each side of the warp and of a block's 4 warps
@pytest.mark.parametrize("cap", [2 ** e for e in range(1, 21)]
                         + [257, 100_000, 200_000])
def test_sumtree_sample_kernel_partial_rounds_bitwise(dev, cap):
    """The descent kernel against the plain descent, bitwise, one launch a
    call and the same bits again, on trees with zero leaves."""
    rng = np.random.default_rng(cap)
    tree = np.zeros(2 * cap)
    tree[cap:] = rng.integers(0, 4, cap)
    for i in range(cap - 1, 0, -1):
        tree[i] = tree[2 * i] + tree[2 * i + 1]
    tree_d = torch.as_tensor(tree, device=dev)
    for n in (1, 3, 4, 5, 31, 32, 33, 127, 128, 129, 448):
        u = rng.random(n)
        size = max(1, cap // 2) if n % 2 else cap
        before = sumtree_sample.launches
        got = sumtree_sample.sumtree_sample(
            tree_d, torch.as_tensor(u, device=dev), size)
        again = sumtree_sample.sumtree_sample(
            tree_d, torch.as_tensor(u, device=dev), size)
        torch.cuda.synchronize()
        assert sumtree_sample.launches == before + 2
        want = sumtree_sample.sumtree_sample_plain(
            torch.as_tensor(tree), torch.as_tensor(u), size)
        assert torch.equal(got.cpu(), want), (cap, n)
        assert torch.equal(got, again)


def test_device_per_on_card_matches_cpu(dev):
    """The same calls on the card and on the CPU: identical sampled
    indices, transitions and trees (the CPU buffer is held to the
    reference's in test_torch_replay.py); is_w to rtol 1e-6 (CUDA's
    float64 pow is not libm's)."""
    rng = np.random.default_rng(0)
    bufs = [replay.PERBuffer(52, 30, 4, seed=1, device=d)
            for d in (dev, "cpu")]
    for _ in range(4):
        tr = (rng.normal(size=(448, 52)).astype(np.float32),
              rng.uniform(-1, 1, (448, 30)).astype(np.float32),
              rng.integers(0, 5, (448, 4)).astype(np.int32),
              rng.normal(size=448).astype(np.float32),
              rng.normal(size=(448, 52)).astype(np.float32),
              np.zeros(448, np.float32))
        for b in bufs:
            b.add_batch(*tr)
        for _ in range(4):
            (og, ig), (oc, ic) = (b.sample(256) for b in bufs)
            assert torch.equal(ig.cpu(), ic)
            for k in replay.PERBuffer.FIELDS:
                assert torch.equal(og[k].cpu(), oc[k])
            torch.testing.assert_close(og["is_w"].cpu(), oc["is_w"],
                                       rtol=1e-6, atol=0)
            td = np.abs(rng.normal(size=256)).astype(np.float32)
            bufs[0].update_priorities(ig, torch.as_tensor(td, device=dev))
            bufs[1].update_priorities(ic, torch.as_tensor(td))
        assert torch.equal(bufs[0].tree.cpu(), bufs[1].tree)


# the paths' shapes, each side of the 16-row tile, and each side of the
# launch's switch from 1 to 2 to 4 groups a CTA on 132 SMs (2,112 and
# 4,224 rows)
@pytest.mark.parametrize("b,d_out", [(448, 3), (4096, 52), (33, 3),
                                     (33, 52), (1, 52), (16, 3), (17, 3),
                                     (2112, 52), (2113, 52), (4224, 3),
                                     (4225, 3), (28672, 52)])
@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, RTOL, ATOL), (torch.bfloat16, 3e-2, 3e-2)])
def test_fused_mlp_kernel_matches_plain(dev, b, d_out, dtype, rtol, atol):
    g = _gen(dev, b + d_out)
    ws = [torch.randn(s, generator=g, device=dev) * 0.1
          for s in ((82, 128), (128,), (128, 64), (64,), (64, d_out),
                    (d_out,))]
    x = torch.randn((b, 82), generator=g, device=dev).to(dtype)
    before = policy_mlp.launches
    with torch.no_grad():
        got = policy_mlp.fused_mlp(x, *ws)
        torch.cuda.synchronize()
        want = policy_mlp.fused_mlp_plain(x, *ws)
    assert policy_mlp.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, d_out)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    with torch.no_grad():
        assert torch.equal(got, policy_mlp.fused_mlp(x, *ws))


# the index surrogate's serving widths, 82 -> 32 -> 16 -> 3 (SERVE_HIDDEN):
# a tile's 4 column warps share 4, 2 and 1 n-tiles of 8 columns
@pytest.mark.parametrize("b", [1, 17, 22, 448, 4225])
def test_fused_mlp_kernel_at_the_serving_widths(dev, b):
    g = _gen(dev, b)
    ws = [torch.randn(s, generator=g, device=dev) * 0.3
          for s in ((82, 32), (32,), (32, 16), (16,), (16, 3), (3,))]
    x = torch.randn((b, 82), generator=g, device=dev)
    before = policy_mlp.launches
    with torch.no_grad():
        got = policy_mlp.fused_mlp(x, *ws)
        torch.cuda.synchronize()
        want = policy_mlp.fused_mlp_plain(x, *ws)
    assert policy_mlp.launches == before + 1
    assert got.shape == (b, 3)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        assert torch.equal(got, policy_mlp.fused_mlp(x, *ws))


def _query_score(q, ans):
    """The scalarized log1p score ``score_query_batch`` ranks an answer
    by (lower = better)."""
    w_perf, w_power, w_area = np.asarray(q.weights) / sum(q.weights)
    p, f, a = np.log1p([ans.power_mw, ans.perf_gops, ans.area_mm2])
    return w_power * p + w_area * a - w_perf * f


def test_recommender_on_card_matches_cpu(dev, tmp_path):
    """A campaign's archive index served on the card: the index fit
    launches ``fused_mlp``; exact answers equal the CPU recommender's
    bitwise; surrogate answers, the CPU recommender given the card's
    fitted parameters, pick the same design with predictions within rtol
    1e-4, or (a near-tie) designs whose scores are within 1e-4; one
    dispatch for the batch, none for an all-exact one."""
    from repro_torch.launch.recommend import Query, Recommender
    spec = CampaignSpec(name="cardrec", workloads=["smolvlm"],
                        nodes=[3, 28], modes=["high_perf"], episodes=640,
                        lanes=64, max_envs=128, checkpoint_every=0)
    store = run_campaign(str(tmp_path / "camp"), spec,
                         progress=lambda m: None)
    before = policy_mlp.launches
    card = Recommender.build([store.root], fit_steps=100, device="cuda")
    assert policy_mlp.launches > before
    params = {k: {kk: v.cpu() for kk, v in d.items()}
              for k, d in card.surrogate.params.items()}
    cpu = Recommender.build([store.root], fit_steps=0, params=params,
                            device="cpu")
    exact = [Query(arch="smolvlm", node_nm=n) for n in (3, 28)]
    queries = exact + [Query(arch=a, node_nm=n, mode=m)
                       for a in ("smolvlm", "llama3.1-8b")
                       for n in (5, 7, 10) for m in ("high_perf",
                                                      "low_power")]
    got, want = card.recommend_batch(queries), cpu.recommend_batch(queries)
    assert card.n_dispatches == cpu.n_dispatches == 1
    for q, g, w in zip(queries, got, want):
        assert g.source == w.source and g.cell_id == w.cell_id
        if g.source == "archive":
            assert np.array_equal(g.cfg, w.cfg)
            assert g.to_dict() == w.to_dict()
        elif np.array_equal(g.cfg, w.cfg):
            np.testing.assert_allclose(
                [g.power_mw, g.perf_gops, g.area_mm2],
                [w.power_mw, w.perf_gops, w.area_mm2], rtol=1e-4)
        else:
            assert abs(_query_score(q, g) - _query_score(q, w)) <= 1e-4
    card.recommend_batch(exact)
    assert card.n_dispatches == 1


def test_new_wrappers_check_their_inputs(dev):
    tree = torch.zeros(16, dtype=torch.float64, device=dev)
    idx = torch.zeros(3, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="sumtree: tree"):
        sumtree.sumtree_set_many(tree.float(), idx, 1.0)
    with pytest.raises(ValueError, match="sumtree: idx"):
        sumtree.sumtree_set_many(tree, idx.int(), 1.0)
    with pytest.raises(ValueError, match="sumtree: values"):
        sumtree.sumtree_set_many(tree, idx, torch.ones(2, dtype=torch.float64,
                                                       device=dev))
    with pytest.raises(ValueError, match="sumtree_sample: tree"):
        sumtree_sample.sumtree_sample(tree.float(), tree[:3], 4)
    with pytest.raises(ValueError, match="sumtree_sample: u"):
        sumtree_sample.sumtree_sample(tree, tree[:3].float(), 4)
    with pytest.raises(ValueError, match="sumtree_sample: u"):
        sumtree_sample.sumtree_sample(tree, tree[:3].cpu(), 4)
    ws = [torch.zeros(s, device=dev) for s in ((82, 128), (128,), (128, 64),
                                               (64,), (64, 3), (3,))]
    x = torch.zeros((4, 82), device=dev)
    with pytest.raises(ValueError, match="fused_mlp: x"):
        policy_mlp.fused_mlp(x.double(), *ws)
    with pytest.raises(ValueError, match="fused_mlp: x"):
        policy_mlp.fused_mlp(torch.zeros((82, 4), device=dev).t(), *ws)
    with pytest.raises(ValueError, match="fused_mlp: expected"):
        policy_mlp.fused_mlp(torch.zeros((4, 81), device=dev), *ws)
    with pytest.raises(RuntimeError, match="no backward"):
        policy_mlp.fused_mlp(x, ws[0].requires_grad_(True), *ws[1:])
    ws[0].requires_grad_(False)
    flat = torch.zeros(4 * 82 + 1, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="4-byte aligned"):
        policy_mlp.fused_mlp(flat[1:].view(4, 82), *ws)   # bf16 pairs
    flat = torch.zeros(82 * 128 + 1, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        policy_mlp.fused_mlp(x, flat[1:].view(82, 128), *ws[1:])


def test_campaign_on_card_launches_every_kernel_and_resumes_bitwise(
        dev, tmp_path, monkeypatch):
    # high-performance SmolVLM finds designs at this budget (low-power
    # cells do not), so the frontiers compared below are not empty
    spec = CampaignSpec(name="card", workloads=["smolvlm"], nodes=[3, 28],
                        modes=["high_perf"], episodes=640, lanes=64,
                        max_envs=448, checkpoint_every=4,
                        gate_threshold=1e9)
    ops.reset_launch_counts()
    ref = run_campaign(str(tmp_path / "ref"), spec, progress=lambda m: None)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in SEARCH_KERNELS), counts
    real_save = search_mod._save_search_ckpt

    def killing_save(*args, **kw):
        real_save(*args, **kw)
        raise KeyboardInterrupt("simulated kill after the first checkpoint")

    monkeypatch.setattr(search_mod, "_save_search_ckpt", killing_save)
    root = str(tmp_path / "ck")
    with pytest.raises(KeyboardInterrupt):
        run_campaign(root, spec, progress=lambda m: None)
    monkeypatch.setattr(search_mod, "_save_search_ckpt", real_save)
    store = run_campaign(root, resume=True, progress=lambda m: None)
    assert store.all_done()
    for cid in ref.manifest["cells"]:
        a = {k: v for k, v in ref.load_summary(cid).items() if k != "wall_s"}
        b = {k: v for k, v in store.load_summary(cid).items()
             if k != "wall_s"}
        assert a == b, cid
        assert len(ref.load_archive(cid)) > 0, cid
        fa, fb = (s.load_archive(cid).frontier() for s in (ref, store))
        for k in fa:
            np.testing.assert_array_equal(np.sort(fa[k]), np.sort(fb[k]))
    assert os.path.isfile(os.path.join(root, "report", "cells.json"))
    assert isinstance(CampaignStore.open(root), CampaignStore)


def test_scenario_campaign_on_card_matches_cpu(dev, tmp_path):
    """A 2-cell scenario campaign (SmolVLM at node 3, high-performance,
    decode and prefill, default SLOs; its cells find designs at this
    budget) on the card and on the CPU: the same cells and summary keys;
    each card pick is the argmin of the SLO objective over its own
    frontier, its TTFT recomputed here on the CPU at rtol 1e-5."""
    from repro_torch.core import reward as rw
    from repro_torch.ppa import config_space as cs
    from repro_torch.ppa.nodes import node_params
    spec = CampaignSpec(name="scen", workloads=["smolvlm"], nodes=[3],
                        modes=["high_perf"], episodes=640, lanes=64,
                        max_envs=64, phases=["decode", "prefill"],
                        slo=rw.DEFAULT_SLOS)
    card = run_campaign(str(tmp_path / "card"), spec,
                        progress=lambda m: None)
    cpu = run_campaign(str(tmp_path / "cpu"), spec, progress=lambda m: None,
                       device="cpu")
    assert sorted(card.manifest["cells"]) == sorted(cpu.manifest["cells"])
    aux = extract(get_config("smolvlm"), seq_len=2048, batch=3,
                  phase="prefill")
    node = torch.as_tensor(an.node_vector(node_params(3)))
    slo = rw.resolve_slo(rw.DEFAULT_SLOS, "high_perf")
    picked = 0
    for cid in card.manifest["cells"]:
        s_card = card.load_summary(cid)
        ents = card.load_archive(cid).entries
        if ents and cpu.load_archive(cid).entries:
            assert s_card.keys() == cpu.load_summary(cid).keys()
        if not ents:
            assert "ttft_ms" not in s_card
            continue
        picked += 1
        assert isinstance(s_card["slo_ok"], bool) and s_card["ttft_ms"] > 0
        with torch.no_grad():
            pre = an.evaluate_batch(cs.project(torch.as_tensor(
                np.stack([e.cfg for e in ents]))),
                torch.as_tensor(aux.features), node).numpy()
        ttfts = [rw.ttft_ms(pre[i, an.M_IDX["tok_s"]], 2048, 3)
                 for i in range(len(ents))]
        pick = int(np.argmin([rw.slo_objective(e.ppa_score, e.tok_s, t, slo)
                              for e, t in zip(ents, ttfts)]))
        assert s_card["ttft_ms"] == pytest.approx(ttfts[pick], rel=1e-5)
    assert picked >= 1


# ------------------------------------------------------------- LM kernels
# test_kernels.py's tolerances: fp32 with another order of sums, and the
# rounding of a half-precision output
ATTN_TOL = {torch.float32: 2e-5, torch.float16: 2e-2, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("B,H,Hk,Sq,Sk,hd,causal,window", [
    (1, 4, 2, 256, 256, 64, True, 0), (2, 8, 8, 128, 128, 128, True, 0),
    (1, 2, 1, 256, 256, 64, False, 0), (1, 4, 4, 256, 256, 64, True, 64),
    (2, 16, 4, 128, 128, 64, True, 0),
    (2, 4, 2, 33, 33, 128, True, 0), (1, 8, 2, 200, 200, 128, True, 0),
    (2, 4, 2, 200, 200, 16, False, 16), (1, 4, 1, 7, 40, 64, False, 0),
    (1, 4, 2, 40, 9, 32, False, 4), (1, 4, 4, 1, 1, 96, True, 0),
    # the fp16/bf16 kernel's edges: hd zero-padded to 64 and 128; several
    # 64-key tiles and a ragged last one; causal with Sq != Sk both ways;
    # a window across 64-key tiles with Sq > Sk (rows from Sk + window - 1
    # on see no key and average all of them)
    (1, 4, 2, 100, 100, 40, True, 0), (1, 4, 2, 150, 150, 80, True, 0),
    (1, 4, 2, 1000, 1000, 128, True, 0), (1, 4, 2, 300, 170, 64, True, 0),
    (1, 4, 2, 70, 300, 128, True, 0), (1, 4, 2, 200, 100, 64, False, 70),
    (1, 4, 2, 200, 100, 80, True, 70)])
def test_flash_attention_kernel_matches_plain(dev, B, H, Hk, Sq, Sk, hd,
                                              causal, window, dtype):
    g = _gen(dev, Sq * 7 + hd)
    q = torch.randn((B, H, Sq, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Hk, Sk, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Hk, Sk, hd), generator=g, device=dev).to(dtype)
    before = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                 window=window)
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err < ATTN_TOL[dtype], err
    assert torch.equal(got, flash_attention.flash_attention(
        q, k, v, causal=causal, window=window))          # deterministic


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("layout", ["transposed", "unaligned"])
def test_flash_attention_kernel_reads_strided_views(dev, layout, dtype):
    """The model passes its [B,S,H,hd] projections transposed, without a
    copy; the output keeps q's layout.  "unaligned": q, k and v are
    x[..., 1:65] of [..., 66] tensors, whose base and row stride are not
    16-byte aligned, so the kernel loads them element by element."""
    g = _gen(dev, 3)
    if layout == "transposed":
        q = torch.randn((2, 50, 8, 64), generator=g, device=dev).to(dtype)
        kv = torch.randn((2, 50, 2, 2, 64), generator=g,
                         device=dev).to(dtype)
        q = q.transpose(1, 2)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    else:
        q, k, v = (torch.randn(s, generator=g, device=dev).to(dtype)
                   [..., 1:65] for s in ((2, 8, 150, 66), (2, 2, 150, 66),
                                         (2, 2, 150, 66)))
    before = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    if layout == "transposed":
        assert got.transpose(1, 2).is_contiguous()
    want = flash_attention.flash_attention_plain(q, k, v)
    err = float((got.float() - want.float()).abs().max())
    assert err < ATTN_TOL[dtype], err
    assert torch.equal(got, flash_attention.flash_attention(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_flash_attention_kernel_at_the_mixtral_window(dev, dtype):
    """Mixtral 8x7B's prefill of 4,608 tokens, longer than its 4,096-token
    window: q [1,32,4608,128], k/v [1,8,4608,128], causal, window 4,096
    (rows past 4,096 mask their oldest keys), at the tolerances above."""
    g = _gen(dev, 4608)
    q = torch.randn((1, 32, 4608, 128), generator=g, device=dev).to(dtype)
    k = torch.randn((1, 8, 4608, 128), generator=g, device=dev).to(dtype)
    v = torch.randn((1, 8, 4608, 128), generator=g, device=dev).to(dtype)
    before = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=True, window=4096)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention.flash_attention_plain(q, k, v, causal=True,
                                                 window=4096)
    err = float((got.float() - want.float()).abs().max())
    assert got.dtype == dtype and err < ATTN_TOL[dtype], err
    # the window does mask: the last row differs from full causal attention
    full = flash_attention.flash_attention_plain(q[:, :, -1:], k, v,
                                                 causal=False)
    assert float((full.float() - want[:, :, -1:].float()).abs().max()) > \
        ATTN_TOL[dtype]


# the LM prefill's shape (runs c and d), the paper's sequence length, and
# each head width the fp32 kernel pads (hd 32, 64, 80 -> 128, 128) over
# several 32-key tiles with a ragged last one
@pytest.mark.parametrize("B,H,Hk,Sq,Sk,hd", [
    (4, 32, 8, 512, 512, 128), (1, 32, 8, 2048, 2048, 128),
    (1, 8, 2, 333, 333, 32), (1, 8, 2, 333, 333, 64),
    (1, 8, 2, 333, 333, 80), (1, 8, 2, 333, 333, 128)])
def test_flash_attention_fp32_kernel_at_the_lm_shapes(dev, B, H, Hk, Sq, Sk,
                                                      hd):
    """The fp32 (3xTF32) kernel against the plain version at 2e-5, causal,
    one launch a call and the same bits again."""
    g = _gen(dev, Sq + hd)
    q = torch.randn((B, H, Sq, hd), generator=g, device=dev)
    k = torch.randn((B, Hk, Sk, hd), generator=g, device=dev)
    v = torch.randn((B, Hk, Sk, hd), generator=g, device=dev)
    before = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v)
    again = flash_attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert torch.equal(got, again)
    want = flash_attention.flash_attention_plain(q, k, v)
    err = float((got - want).abs().max())
    assert err < ATTN_TOL[torch.float32], err


# the sweep's shapes, ragged D and N < 16 (16-byte and 4-byte copies),
# S = 1, each side of the 16-step stage, and a long prefill
@pytest.mark.parametrize("B,S,D,N", [(1, 128, 64, 8), (2, 256, 128, 16),
                                     (1, 64, 32, 4), (2, 33, 200, 16),
                                     (3, 1, 8, 5), (4, 512, 1024, 16),
                                     (2, 15, 64, 16), (2, 16, 64, 16),
                                     (2, 17, 130, 13), (1, 2048, 256, 16)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_scan_kernel_matches_plain(dev, B, S, D, N, with_h0):
    g = _gen(dev, S + D + N)
    dt = torch.rand((B, S, D), generator=g, device=dev) * 0.1 + 1e-3
    b_in = torch.randn((B, S, N), generator=g, device=dev)
    c_in = torch.randn((B, S, N), generator=g, device=dev)
    x = torch.randn((B, S, D), generator=g, device=dev)
    a = -torch.exp(torch.randn((D, N), generator=g, device=dev) * 0.5)
    h0 = torch.randn((B, D, N), generator=g, device=dev) if with_h0 \
        else None
    before = ssm_scan.launches
    y, h = ssm_scan.ssm_scan(dt, b_in, c_in, x, a, h0)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    want_y, want_h = ssm_scan.ssm_scan_plain(dt, b_in, c_in, x, a, h0)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)
    y2, h2 = ssm_scan.ssm_scan(dt, b_in, c_in, x, a, h0)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_ssm_scan_kernel_reads_unaligned_tensors(dev):
    """Views that start off a 16-byte boundary take the kernel's 4-byte
    copies: the same values as the plain version, one launch."""
    g = _gen(dev, 5)
    B, S, D, N = 2, 40, 64, 16

    def shifted(shape, fill):
        flat = torch.empty(int(np.prod(shape)) + 1, device=dev)
        view = flat[1:].view(shape)
        view.copy_(fill)
        return view
    dt = shifted((B, S, D), torch.rand((B, S, D), generator=g, device=dev)
                 * 0.1 + 1e-3)
    b_in, c_in = (shifted((B, S, N), torch.randn((B, S, N), generator=g,
                                                 device=dev))
                  for _ in range(2))
    x = shifted((B, S, D), torch.randn((B, S, D), generator=g, device=dev))
    a = -torch.exp(torch.randn((D, N), generator=g, device=dev) * 0.5)
    assert dt.data_ptr() % 16 != 0
    before = ssm_scan.launches
    y, h = ssm_scan.ssm_scan(dt, b_in, c_in, x, a)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    want_y, want_h = ssm_scan.ssm_scan_plain(dt, b_in, c_in, x, a)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)


def test_lm_wrappers_check_their_inputs(dev):
    q = torch.zeros((1, 4, 8, 160), device=dev)
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention.flash_attention(q, q[:, :2], q[:, :2])      # hd
    q = torch.zeros((1, 4, 8, 64), device=dev)
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention.flash_attention(q, q[:, :3], q[:, :3])      # H % Hk
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention.flash_attention(q, q.double(), q.double())
    x = torch.zeros((1, 8, 16), device=dev)
    with pytest.raises(ValueError, match="ssm_scan"):
        ssm_scan.ssm_scan(x, torch.zeros((1, 8, 17), device=dev),
                          torch.zeros((1, 8, 17), device=dev), x,
                          torch.zeros((16, 17), device=dev))        # N > 16
    with pytest.raises(ValueError, match="ssm_scan"):
        ssm_scan.ssm_scan(x, x[..., :4], x[..., :4], x,
                          torch.zeros((16, 4), device=dev))  # strided B/C


@pytest.mark.parametrize("arch", ["llama3.1-8b", "jamba-v0.1-52b",
                                  "smolvlm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_generation_on_card_matches_cpu(dev, arch, dtype):
    """Reduced models, the same weights on both: the card's prefill goes
    through the kernels (counted), the CPU's through their plain versions.
    float32: logits within 1e-4 of max |logit| and the same 72 greedy
    tokens (one tail flush); bf16: the prefill logits within 5e-2."""
    import dataclasses
    cfg = dataclasses.replace(get_reduced(arch), param_dtype=dtype)
    params = lm.init_params(cfg, seed=1, device="cpu")
    g = torch.Generator().manual_seed(2)
    prompts = torch.randint(0, cfg.vocab, (2, 12), generator=g)
    ctx = None
    if cfg.n_context_tokens:
        ctx = (torch.randn((2, cfg.n_context_tokens, cfg.d_model),
                           generator=g) * 0.1).to(params["embed"]["w"].dtype)
    n = 72 if dtype == "float32" else 8
    want = generate(params, cfg, prompts, n, ctx)
    ops.reset_launch_counts()
    got = generate(to_device(params, dev), cfg, prompts.to(dev), n,
                   None if ctx is None else ctx.to(dev))
    counts = ops.launch_counts()
    kinds = lm.decoder_kinds(cfg)
    assert counts["flash_attention"] == kinds.count("attn")
    assert counts["ssm_scan"] == kinds.count("mamba")
    scale = float(want.prefill_logits.float().abs().max())
    err = float((got.prefill_logits.cpu().float()
                 - want.prefill_logits.float()).abs().max())
    if dtype == "float32":
        assert err <= 1e-4 * scale, (err, scale)
        np.testing.assert_array_equal(got.tokens, want.tokens)
    else:
        assert err <= 5e-2 * scale, (err, scale)


def test_devices_one_on_card_is_bitwise_devices_none(dev):
    """``devices=1`` runs the chunked env path with one chunk on the card;
    its env rollout and a short search (gate open, learning on) are
    bitwise the ``devices=None`` run's."""
    wl = extract(get_config("llama3.1-8b"), seq_len=2048, batch=3)
    rollouts = []
    for devices in (None, 1):
        env = VecDSEEnv(wl, [3, 7] * 32, batch=64, seed=0, devices=devices,
                        device="cuda")
        out, rng = [env.reset()], np.random.default_rng(0)
        for _ in range(4):
            a_c = rng.uniform(-1, 1, (64, 30)).astype(np.float32)
            a_d = rng.integers(0, 5, (64, 4))
            o, r, info = env.step(a_c, a_d)
            out += [o, r, info.metrics]
        rollouts.append(out)
    for a, b in zip(*rollouts):
        np.testing.assert_array_equal(a, b)
    sc = SearchConfig(episodes=640, seed=0, batch_size=64, warmup=64,
                      gate_threshold=1e9)
    plain, one = (run_search(wl, 3, search=sc, n_envs=64, devices=d,
                             device="cuda") for d in (None, 1))
    assert plain.gate_open_episode is not None
    assert json.dumps([e.to_dict() for e in plain.archive.entries]) == \
        json.dumps([e.to_dict() for e in one.archive.entries])
    assert [t.__dict__ for t in plain.trace] == [t.__dict__
                                                 for t in one.trace]
    assert plain.best_score == one.best_score


def test_fleet_w2_on_card_fingerprints_as_w1(dev, tmp_path):
    """Two worker processes share the card: the W=2 fleet fingerprints as
    the W=1 campaign, every worker ran on ``cuda`` and its final lease
    counts ``actor_moe``, ``sumtree`` and ``sumtree_sample`` launches."""
    from repro_torch.campaign import fingerprint
    from repro_torch.campaign.distrib import worker_root
    from repro_torch.campaign.store import read_lease
    from repro_torch.launch.fleet import run_fleet
    from repro_torch.obs.metrics import snapshot_value
    spec = CampaignSpec(name="cardfleet", workloads=["smolvlm"],
                        nodes=[3, 28], modes=["high_perf"], episodes=640,
                        lanes=64, max_envs=64, checkpoint_every=4)
    ref = run_campaign(str(tmp_path / "w1"), spec, progress=lambda m: None)
    store = run_fleet(str(tmp_path / "w2"), spec, workers=2,
                      progress=lambda m: None, device="cuda")
    assert store.all_done()
    assert fingerprint(store) == fingerprint(ref)
    for i in (0, 1):
        # a launch is counted only for a CUDA tensor: the worker ran on
        # the card
        snap = read_lease(worker_root(store.root, i))["metrics"]
        for name in ("actor_moe", "sumtree", "sumtree_sample"):
            assert snapshot_value(snap, "counters", "kernel_launches_total",
                                  {"kernel": name}) > 0, (i, name)


# ---- the backward kernels (LM training) -------------------------------------
def _rel_err(got, want):
    """max |got - want| over max |want| (the bf16/fp16 measure)."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


BWD_CASES = [(2, 4, 2, 130, 130, 64, True, 0),     # GQA, ragged tiles
             (1, 4, 4, 77, 131, 64, False, 0),     # non-causal, Sq != Sk
             (1, 4, 2, 77, 131, 64, True, 0),      # causal, Sq < Sk
             (1, 4, 2, 200, 200, 64, True, 70),    # window
             (1, 4, 2, 200, 100, 80, True, 70),    # rows that see no key
             (1, 4, 2, 40, 9, 32, False, 4),       # ... and non-causal
             (1, 4, 4, 100, 100, 96, True, 0),     # MLA's width
             (1, 2, 1, 70, 300, 128, True, 0),
             (2, 9, 3, 200, 200, 64, True, 0),     # SmolLM's group of 3
             (1, 4, 2, 150, 170, 128, True, 0),    # hd 128, ragged tiles
             (1, 4, 2, 190, 100, 128, False, 0),   # ... and non-causal
             (1, 16, 16, 1500, 1500, 64, False, 0),   # Whisper's encoder
             (1, 4, 4, 64, 1500, 64, False, 0)]    # ... its cross keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("B,H,Hk,Sq,Sk,hd,causal,window", BWD_CASES)
def test_flash_attention_backward_matches_plain(dev, B, H, Hk, Sq, Sk, hd,
                                                causal, window, dtype):
    g = _gen(dev, Sq + Sk + hd)
    q = torch.randn((B, H, Sq, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Hk, Sk, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Hk, Sk, hd), generator=g, device=dev).to(dtype)
    do = torch.randn((B, H, Sq, hd), generator=g, device=dev).to(dtype)
    o, lse = flash_attention._forward_cuda(q, k, v, causal, window, True)
    want_o = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                   window=window)
    assert _rel_err(o, want_o) < (2e-5 if dtype == torch.float32 else 2e-2)
    before = flash_attention.backward_launches
    got = flash_attention.flash_attention_backward_cuda(
        q, k, v, o, lse, do, causal=causal, window=window)
    again = flash_attention.flash_attention_backward_cuda(
        q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.backward_launches == before + 2
    want = flash_attention.flash_attention_backward_plain(
        q, k, v, do, causal=causal, window=window)
    for name, a_, b_, w_ in zip("qkv", got, again, want):
        assert a_.dtype == dtype and a_.shape == w_.shape, name
        assert torch.equal(a_, b_), name                   # repeatable bits
        if dtype == torch.float32:
            torch.testing.assert_close(a_, w_, rtol=1e-4, atol=1e-5)
        else:
            assert _rel_err(a_, w_) < 2e-2, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("B,H,Hk,Sq,Sk,hd,causal,window", [
    (2, 9, 3, 130, 130, 64, True, 0), (1, 4, 2, 77, 131, 128, True, 0),
    (1, 4, 2, 200, 100, 80, True, 70), (1, 4, 4, 100, 100, 96, False, 0)])
def test_flash_attention_backward_transposed_views(dev, B, H, Hk, Sq, Sk, hd,
                                                   causal, window, dtype):
    """q, k, v and dO as transposed [B,S,H,hd] views (the model's layout,
    ``models/attention.py``): the gradients those of the plain version, in
    the views' layouts, two calls bitwise equal."""
    g = _gen(dev, 3 * Sq + hd)
    q, k, v, do = (torch.randn((B, s, h, hd), generator=g,
                               device=dev).to(dtype).transpose(1, 2)
                   for s, h in ((Sq, H), (Sk, Hk), (Sk, Hk), (Sq, H)))
    o, lse = flash_attention._forward_cuda(q, k, v, causal, window, True)
    got = flash_attention.flash_attention_backward_cuda(
        q, k, v, o, lse, do, causal=causal, window=window)
    again = flash_attention.flash_attention_backward_cuda(
        q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_attention.flash_attention_backward_plain(
        q, k, v, do, causal=causal, window=window)
    for name, a_, b_, w_, x_ in zip("qkv", got, again, want, (q, k, v)):
        assert a_.stride() == x_.stride(), name
        assert torch.equal(a_, b_), name
        if dtype == torch.float32:
            torch.testing.assert_close(a_, w_, rtol=1e-4, atol=1e-5)
        else:
            assert _rel_err(a_, w_) < 2e-2, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_runs_both_kernels(dev, dtype):
    """On CUDA tensors that need a gradient, ``flash_attention`` is the
    autograd Function: one forward and one backward launch, the gradients
    of transposed views (the model's layout) those of the plain version."""
    g = _gen(dev, 7)
    base = [torch.randn((2, 96, n, 64), generator=g, device=dev).to(dtype)
            for n in (8, 2, 2)]
    leaves = [t.requires_grad_(True) for t in base]
    ops.reset_launch_counts()
    o = flash_attention.flash_attention(*(t.transpose(1, 2) for t in leaves),
                                        window=40)
    o.float().square().sum().backward()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_backward"] == 1
    plain = [t.detach().clone().requires_grad_(True) for t in base]
    o2 = flash_attention.flash_attention_plain(
        *(t.transpose(1, 2) for t in plain), window=40)
    o2.float().square().sum().backward()
    for a_, b_ in zip(leaves, plain):
        if dtype == torch.float32:
            torch.testing.assert_close(a_.grad, b_.grad, rtol=1e-4,
                                       atol=1e-5)
        else:
            assert _rel_err(a_.grad, b_.grad) < 2e-2


def _ssm_inputs(dev, B, S, D, N, seed):
    g = _gen(dev, seed)
    return (torch.rand((B, S, D), generator=g, device=dev) * 0.1 + 1e-3,
            torch.randn((B, S, N), generator=g, device=dev),
            torch.randn((B, S, N), generator=g, device=dev),
            torch.randn((B, S, D), generator=g, device=dev),
            -torch.exp(0.5 * torch.randn((D, N), generator=g, device=dev)))


@pytest.mark.parametrize("B,S,D,N", [(2, 300, 200, 16), (1, 128, 64, 8),
                                     (2, 33, 130, 13), (1, 1, 8, 5),
                                     (2, 129, 200, 16), (2, 256, 200, 16),
                                     (2, 257, 200, 16), (1, 300, 1000, 16),
                                     (2, 300, 200, 1)])
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_scan_backward_matches_plain(dev, B, S, D, N, with_dh, with_h0):
    ins = _ssm_inputs(dev, B, S, D, N, S + D)
    g = _gen(dev, 11)
    h0 = torch.randn((B, D, N), generator=g, device=dev) if with_h0 else None
    dy = torch.randn((B, S, D), generator=g, device=dev)
    dh = torch.randn((B, D, N), generator=g, device=dev) if with_dh else None
    y, h_final, h_chunks = ssm_scan._forward_cuda(*ins, h0, True)
    want_y, want_h = ssm_scan.ssm_scan_plain(*ins, h0)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h_final, want_h, rtol=1e-4, atol=1e-4)
    got = ssm_scan.ssm_scan_backward_cuda(*ins, h_chunks, dy, dh, with_h0)
    again = ssm_scan.ssm_scan_backward_cuda(*ins, h_chunks, dy, dh, with_h0)
    torch.cuda.synchronize()
    want = ssm_scan.ssm_scan_backward_plain(*ins, h0, dy, dh)
    exact = ssm_scan.ssm_scan_backward_plain(
        *(None if t is None else t.double() for t in (*ins, h0, dy, dh)))
    for name, a_, b_, w_, x_ in zip(("dt", "B", "C", "x", "A", "h0"), got,
                                    again, want, exact):
        if w_ is None:
            assert a_ is None, name
            continue
        assert torch.equal(a_, b_), name                   # repeatable bits
        _hold_fp32_gradient(a_, w_, x_, name)


def _hold_fp32_gradient(got, plain, exact, name):
    """A float32 gradient of the scan against the plain version's: rtol
    1e-4 and atol 1e-5 of the largest magnitude (chained over hundreds of
    steps, the terms reach 10^2 and entries near 0 come from cancelling
    them, where the two float32 computations differ by their rounding);
    and within 1e-5 of the largest magnitude from the plain version run in
    float64."""
    scale = float(plain.abs().max())
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-5 * scale,
                               msg=name)
    err_kernel = float((got.double() - exact).abs().max())
    assert err_kernel <= 1e-5 * scale, (name, err_kernel, scale)


def test_ssm_scan_autograd_runs_both_kernels(dev):
    ins = [t.requires_grad_(True) for t in _ssm_inputs(dev, 2, 260, 96, 16,
                                                        3)]
    ops.reset_launch_counts()
    y, _ = ssm_scan.ssm_scan(*ins)
    y.square().sum().backward()
    counts = ops.launch_counts()
    assert counts["ssm_scan"] == 1 and counts["ssm_scan_backward"] == 1
    plain = [t.detach().clone().requires_grad_(True) for t in ins]
    y2, _ = ssm_scan.ssm_scan_plain(*plain)
    y2.square().sum().backward()
    exact = [t.detach().double().requires_grad_(True) for t in ins]
    y3, _ = ssm_scan.ssm_scan_plain(*exact)
    y3.square().sum().backward()
    for name, a_, b_, c_ in zip(("dt", "B", "C", "x", "A"), ins, plain,
                                exact):
        _hold_fp32_gradient(a_.grad, b_.grad, c_.grad, name)


# ------------------------------------------- the kernels' operators, meshes
def _free_port():
    import socket
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        return s_.getsockname()[1]


@pytest.fixture
def nccl_mesh(dev):
    """A 1x1 (data, model) mesh over a 1-rank NCCL group."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    mesh_mod.init_distributed("cuda", init_method="tcp://127.0.0.1:%d"
                              % _free_port(), rank=0, world_size=1)
    try:
        yield mesh_mod.make_test_mesh(1, 1, device="cuda")
    finally:
        dist.destroy_process_group()


def test_mesh_1x1_nccl_steps_match_one_device(nccl_mesh):
    """Two steps of reduced SmolLM and Jamba (float32) through
    ``train(mesh=...)`` on the card's 1x1 NCCL mesh: losses within rtol
    1e-5 of the one-device path's, the same kernel launches."""
    import dataclasses
    from repro_torch.launch import train as train_mod
    for arch in ("smollm-135m", "jamba-v0.1-52b"):
        cfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
        out = {}
        for name, m in (("mesh", nccl_mesh), ("one", None)):
            ops.reset_launch_counts()
            _, losses = train_mod.train(arch, cfg=cfg, steps=2,
                                        global_batch=4, seq_len=64,
                                        device="cuda", mesh=m)
            out[name] = (losses, ops.launch_counts())
        np.testing.assert_allclose(out["mesh"][0], out["one"][0], rtol=1e-5)
        assert out["mesh"][1] == out["one"][1], arch
        assert out["mesh"][1]["flash_attention_backward"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_operator_on_card_matches_plain(dev, dtype):
    """``repro_torch::flash_attention`` and its autograd formula on CUDA
    tensors (the kernels) against the plain versions on the CPU copies;
    its fake implementation gives the kernel's shapes and layout."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    g = _gen(dev, 5)
    base = [torch.randn((2, 40, n, 64), generator=g, device=dev).to(dtype)
            for n in (6, 2, 2)]
    cuda_in = [t.clone().requires_grad_(True) for t in base]
    cpu_in = [t.cpu().float().requires_grad_(True) for t in base]
    ops.reset_launch_counts()
    o = flash_attention.flash_attention(*(t.transpose(1, 2) for t in cuda_in))
    o.float().square().sum().backward()
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.launch_counts()["flash_attention_backward"] == 1
    o2 = flash_attention.flash_attention(*(t.transpose(1, 2) for t in cpu_in))
    o2.square().sum().backward()
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else None
    for a_, b_ in [(o, o2)] + [(x.grad, y.grad)
                               for x, y in zip(cuda_in, cpu_in)]:
        if tol:
            torch.testing.assert_close(a_.float().cpu(), b_, **tol)
        else:
            assert _rel_err(a_.float().cpu(), b_) < 2e-2
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty((2, 40, 6, 64), device="cuda").transpose(1, 2)
        k = torch.empty((2, 2, 40, 64), device="cuda")
        fo, lse = flash_attention.attention_op(q, k, k, True, 0, True)
        assert fo.shape == q.shape and fo.stride() == q.stride()
        assert lse.shape == (2, 6, 40) and lse.device.type == "cuda"


def test_scan_operator_on_card_matches_plain(dev):
    """``repro_torch::ssm_scan`` and its autograd formula on CUDA (the
    kernels) against the plain versions on the CPU; the fake
    implementation's shapes, saved states included."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    ins = _ssm_inputs(dev, 2, 200, 96, 16, 9)
    cuda_in = [t.clone().requires_grad_(True) for t in ins]
    cpu_in = [t.cpu().requires_grad_(True) for t in ins]
    ops.reset_launch_counts()
    y, h = ssm_scan.ssm_scan(*cuda_in)
    (y.square().sum() + h.sum()).backward()
    assert ops.launch_counts()["ssm_scan"] == 1
    assert ops.launch_counts()["ssm_scan_backward"] == 1
    y2, h2 = ssm_scan.ssm_scan(*cpu_in)
    (y2.square().sum() + h2.sum()).backward()
    torch.testing.assert_close(y.cpu(), y2, rtol=1e-4, atol=1e-4)
    for a_, b_ in zip(cuda_in, cpu_in):
        scale = float(b_.grad.abs().max())
        torch.testing.assert_close(a_.grad.cpu(), b_.grad, rtol=1e-4,
                                   atol=1e-5 * scale)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = [torch.empty(t.shape, device="cuda") for t in ins]
        fy, fh, fc = ssm_scan.scan_op(*fake, None, True)
        assert fy.shape == (2, 200, 96) and fh.shape == (2, 96, 16)
        assert fc.shape == (2, 2, 96, 16)


def test_operators_on_a_dtensor_mesh_launch_the_kernels(nccl_mesh):
    """On DTensors of the card's 1x1 mesh the operators run the kernels on
    the local tensors and keep the placements."""
    from repro_torch.distributed import sharding as sh
    g = _gen(torch.device("cuda"), 2)
    q, k = (torch.randn((4, 8, 32, 64), generator=g, device="cuda")
            for _ in range(2))
    place = sh.placements(("data", "model", None, None), nccl_mesh)
    dq, dk = (sh.local_shard(t, nccl_mesh, place) for t in (q, k))
    ops.reset_launch_counts()
    o = flash_attention.flash_attention(dq, dk, dk)
    assert ops.launch_counts()["flash_attention"] == 1
    assert tuple(o.placements) == tuple(place)
    torch.testing.assert_close(o.full_tensor(),
                               flash_attention.flash_attention(q, k, k))


def test_failed_nccl_start_raises(dev):
    """A NCCL group whose second rank never comes raises within its
    timeout (no gloo fallback)."""
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from repro_torch.launch import mesh\n"
            "mesh.init_distributed('cuda', init_method='tcp://127.0.0.1:%d',"
            " rank=0, world_size=2, timeout=5)\n") % (src, _free_port())
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
