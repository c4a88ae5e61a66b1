"""The port on the card: each CUDA kernel against its plain PyTorch version
at the main path's shapes and ragged ones, the device PER on the card
against the same buffer on the CPU, the batched env step on the card
against the CPU, the search's determinism guarantees on the card, and a
short campaign that launches every search kernel and resumes
bit-for-bit, and the LM kernels (``flash_attention``, ``ssm_scan``) and
reduced LM generation on the card against the same on the CPU.

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


@pytest.mark.parametrize("b,d_out", [(448, 3), (4096, 52), (33, 3),
                                     (33, 52), (1, 52)])
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


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
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


@pytest.mark.parametrize("B,S,D,N", [(1, 128, 64, 8), (2, 256, 128, 16),
                                     (1, 64, 32, 4), (2, 33, 200, 16),
                                     (3, 1, 8, 5), (4, 512, 1024, 16)])
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
