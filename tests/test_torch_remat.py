"""The port's activation rematerialisation (``layers.remat`` at the
reference's ``jax.checkpoint`` sites: each period of ``lm.forward``, each
Whisper encoder block, each MoE token group when a batch splits into
several, each cross-entropy chunk), on the CPU:

* the loss and every gradient are bitwise those of the same code with the
  checkpoints patched out (``layers.checkpoint`` made a plain call), for
  float32 copies of reduced SmolLM (2 periods, 2 cross-entropy chunks),
  Mixtral (one period of its two, with two 8,192-token MoE groups: B =
  256 x S = 64), Jamba and Whisper (its encoder over stub frames);
* Mixtral's grouped path against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` on the same weights (``convert.lm_params``),
  within 1e-4 of the largest magnitude, as ``tests/test_torch_train.py``;
* what autograd saves outside the checkpoints: no group's dispatch tensor
  ([tg, E, cap]), and activations within a stated byte bound (the period
  inputs, the embedding's token ids, the final norm and the head's inputs);
* without grad mode nothing is checkpointed (prefill and decode as before);
* a reduced Mixtral train cell's dry-run peak on a fake 2x2 mesh falls
  below the same cell's peak with the checkpoints patched out.

The bitwise runs take one torch thread: a multi-threaded CPU product is
not bitwise repeatable from one call to the next, with or without
recomputation."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

from repro.configs import get_reduced as ref_reduced
from repro.models import lm as ref_lm
from repro_torch import convert
from repro_torch.checkpoint.manager import _leaves_with_names
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun, shapes
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.blocks import MOE_CAPACITY
from repro_torch.optim.adam import tree_map

# (arch, B, S): Mixtral's 16,384 tokens are the fewest that split into two
# groups (a group holds 8,192 // B rows of the batch); its depth is cut to
# one period, whose backward holds two groups' dispatch tensors (~1.5 GB)
# when nothing is recomputed
CASES = {"smollm-135m": (2, 1024), "mixtral-8x7b": (256, 64),
         "jamba-v0.1-52b": (2, 64), "whisper-medium": (2, 32)}
DEPTH = {"mixtral-8x7b": dict(n_layers=1)}


@pytest.fixture(autouse=True, scope="module")
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _no_remat():
    return mock.patch.object(L, "checkpoint", lambda f, *a, **k: f(*a))


def _setup(arch):
    kw = dict(param_dtype="float32", **DEPTH.get(arch, {}))
    rcfg = dataclasses.replace(ref_reduced(arch), **kw)
    cfg = dataclasses.replace(get_reduced(arch), **kw)
    params = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    B, S = CASES[arch]
    rng = np.random.default_rng(0)
    batch = dict(tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                 labels=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    if cfg.is_encdec:
        batch["ctx"] = (rng.normal(0, 1, (B, cfg.n_audio_frames,
                                          cfg.d_model)) * 0.1).astype(
            np.float32)
    return rcfg, cfg, params, batch


def _run(cfg, ref_params, batch, saved=None):
    """(loss, gradients by leaf name); ``saved`` collects the tensors
    autograd saves outside the checkpoints."""
    params = tree_map(lambda t: t.requires_grad_(True),
                      convert.lm_params(jax.tree_util.tree_map(np.asarray,
                                                               ref_params)))
    names = [n for n, _ in _leaves_with_names(params)]
    leaves = [t for _, t in _leaves_with_names(params)]
    args = [torch.as_tensor(batch[k]).long() for k in ("tokens", "labels")]
    ctx = torch.as_tensor(batch["ctx"]) if "ctx" in batch else None

    def pack(t):
        if saved is not None:
            saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = lm.loss_fn(params, cfg, *args, ctx)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads)), leaves


@pytest.fixture(scope="module")
def runs():
    """Each case with and without the checkpoints; the tensors saved
    outside them in the first."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch in CASES:
            rcfg, cfg, params, batch = _setup(arch)
            saved = []
            loss, grads, leaves = _run(cfg, params, batch, saved)
            with _no_remat():
                plain = _run(cfg, params, batch)
            out[arch] = dict(rcfg=rcfg, cfg=cfg, params=params, batch=batch,
                             loss=loss, grads=grads, leaves=leaves,
                             saved=saved, plain_loss=plain[0],
                             plain_grads=plain[1])
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("arch", list(CASES))
def test_loss_and_gradients_bitwise_without_remat(runs, arch):
    r = runs[arch]
    assert torch.isfinite(r["loss"])
    assert torch.equal(r["loss"], r["plain_loss"])
    assert set(r["grads"]) == set(r["plain_grads"])
    for name, g in r["grads"].items():
        assert torch.equal(g, r["plain_grads"][name]), name


def test_mixtral_groups_rematerialise_as_the_reference(runs):
    r = runs["mixtral-8x7b"]
    B, S = CASES["mixtral-8x7b"]
    assert S // max(1, min(S, 8192 // B)) == 2          # two token groups
    rcfg, b = r["rcfg"], r["batch"]
    loss, grads = jax.jit(jax.value_and_grad(lambda p: ref_lm.loss_fn(
        p, rcfg, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))))(
        r["params"])
    assert abs(float(r["loss"]) - float(loss)) <= 1e-4 * abs(float(loss))
    want = dict(_leaves_with_names(convert.lm_params(
        jax.tree_util.tree_map(np.asarray, grads))))
    assert set(want) == set(r["grads"])
    for name, g in r["grads"].items():
        w = want[name]
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), \
            name


def _activations(r):
    """Saved tensors outside the checkpoints whose storage is no
    parameter's, one each per storage: {data_ptr: (shape, bytes)}."""
    params = {t.untyped_storage().data_ptr() for t in r["leaves"]}
    out = {}
    for t in r["saved"]:
        s = t.untyped_storage()
        if s.data_ptr() not in params:
            out.setdefault(s.data_ptr(), (tuple(t.shape), s.nbytes()))
    return out


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x7b"])
def test_saved_outside_the_checkpoints(runs, arch):
    """Outside the checkpoints autograd keeps the embedding's token ids,
    the n_periods period inputs and the last period's output, the final
    norm's and the head's inputs: at most (n_periods + 4) [B, S, d]
    float32 blocks and the ids, plus the logits of an unchunked head
    (S <= 512: [B, S, V] float32, their log-normaliser and label mask).
    No group's [tg, E, cap] dispatch tensor is among them."""
    r = runs[arch]
    cfg = r["cfg"]
    B, S = CASES[arch]
    _, n_periods, _ = lm._layout(cfg)
    acts = _activations(r)
    bound = (n_periods + 4) * B * S * cfg.d_model * 4 + B * S * 8
    if S <= 512:
        bound += B * S * cfg.vocab * 5 + B * S * 4
    assert sum(n for _, n in acts.values()) <= bound
    if cfg.moe is not None:
        tg = B * min(S, 8192 // B)
        cap = int(MOE_CAPACITY * cfg.moe.top_k * tg / cfg.moe.n_experts)
        assert S * B // tg >= 2
        assert all(shape != (tg, cfg.moe.n_experts, cap)
                   for shape, _ in acts.values())
        assert all(t.numel() < tg * cap for t in r["saved"])


def test_no_checkpoint_without_grad(runs):
    r = runs["smollm-135m"]
    params = convert.lm_params(jax.tree_util.tree_map(np.asarray,
                                                      r["params"]))
    tokens = torch.as_tensor(r["batch"]["tokens"]).long()

    def refuse(*a, **k):
        raise AssertionError("checkpoint called without grad mode")
    with mock.patch.object(L, "checkpoint", refuse), torch.no_grad():
        logits, caches = lm.prefill(params, r["cfg"], tokens)
        lm.loss_fn(params, r["cfg"], tokens, tokens)
    assert torch.isfinite(logits).all() and caches


def test_dryrun_peak_falls_with_remat(monkeypatch, tmp_path):
    """A reduced Mixtral train cell (one period, two MoE groups of 16,384
    tokens) on a fake 2x2 mesh: the peak a device with remat below
    the peak without; the recomputed forward adds flops.  The gradient
    that reaches the groups' concatenated output comes in that output's
    own layout, so that the concatenation's backward hands each group a
    view (a gradient split along the sequence would be gathered whole
    for every group's slice)."""
    monkeypatch.setattr(shapes, "SHAPES", dict(shapes.SHAPES, train_g2=dict(
        seq_len=64, global_batch=256, kind="train")))
    cfg = dataclasses.replace(get_reduced("mixtral-8x7b"),
                              **DEPTH["mixtral-8x7b"])
    layouts = []
    cat = torch.cat

    def watched_cat(tensors, dim=0, **kw):
        out = cat(tensors, dim=dim, **kw)
        if isinstance(out, DTensor) and out.requires_grad and \
                len(tensors) == 2 and dim == 1:      # the groups' outputs
            out.register_hook(lambda g: layouts.append(
                (out.placements, g.placements)))
        return out

    def cell(out):
        rec = dryrun.run_cell("mixtral-8x7b", "train_g2", False,
                              str(tmp_path / out), device="cpu", cfg=cfg,
                              mesh_shape=(2, 2))
        assert rec["status"] == "OK", rec.get("traceback")
        return rec
    with mock.patch.object(torch, "cat", watched_cat):
        remat = cell("remat")
    assert layouts and all(o == g for o, g in layouts), layouts
    with _no_remat():
        plain = cell("plain")
    assert remat["memory"]["argument_bytes"] == \
        plain["memory"]["argument_bytes"]
    assert remat["memory"]["peak_bytes"] < plain["memory"]["peak_bytes"]
    assert remat["cost"]["flops_per_device"] > \
        plain["cost"]["flops_per_device"]


def test_real_calls_after_a_dryrun_stay_real(monkeypatch, tmp_path):
    """A dry-run traced on the CPU (fake CPU tensors), then a real forward
    in the same process: no fake tensor made by the trace (the rotary
    frequencies' cache) reaches the real call."""
    monkeypatch.setattr(shapes, "SHAPES", dict(shapes.SHAPES, train_mini=dict(
        seq_len=16, global_batch=4, kind="train")))
    L._rope_freqs_on.cache_clear()
    cfg = get_reduced("smollm-135m")
    rec = dryrun.run_cell("smollm-135m", "train_mini", False, str(tmp_path),
                          device="cpu", cfg=cfg, mesh_shape=(2, 2))
    assert rec["status"] == "OK", rec.get("traceback")
    logits = lm.forward(lm.init_params(cfg, 0, "cpu"), cfg,
                        torch.zeros(1, 8, dtype=torch.long))
    assert not isinstance(logits, FakeTensor)
    assert torch.isfinite(logits).all()
