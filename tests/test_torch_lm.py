"""The port's LM (``repro_torch.models.lm`` and ``launch.serve.generate``)
against the JAX reference's (``repro.models.lm`` driven as
``repro.launch.serve`` drives it) on converted reference weights, for the
reduced Llama 3.1 8B, Jamba v0.1 and SmolVLM (with its prefix context).

* float32 copies of the configs: logits within 1e-4 of max |logit| and
  identical greedy tokens over 72 generated tokens (one ``flush_tails``);
* the configs' own dtypes (bf16): within 5e-2 of max |logit|, the bound of
  the reference's own decode-vs-forward test, on the prefill and on 70
  decode steps fed the same tokens.  Greedy tokens are not compared there:
  a router near-tie may flip an expert pick under bf16 rounding (the
  reference's bf16 run differs from its own float32 run that way)."""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_reduced
from repro.models import lm as ref_lm
from repro.models.blocks import KV_TAIL as REF_KV_TAIL
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.launch.serve import generate
from repro_torch.models import blocks as blk
from repro_torch.models import lm

ARCHS = ["llama3.1-8b", "jamba-v0.1-52b", "smolvlm", "smollm-135m",
         "qwen1.5-110b", "qwen2-72b", "mixtral-8x7b",
         "llama4-maverick-400b-a17b"]
B, S, GEN = 2, 12, 72
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _setup(arch, dtype=None, seed=1, **kw):
    rcfg, tcfg = ref_reduced(arch), get_reduced(arch)
    if dtype:
        kw["param_dtype"] = dtype
    rcfg, tcfg = (dataclasses.replace(c, **kw) for c in (rcfg, tcfg))
    params = ref_lm.init_params(jax.random.PRNGKey(seed), rcfg)
    tparams = convert.lm_params(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    ctx = None
    if rcfg.n_context_tokens:
        ctx = (rng.normal(0, 1, (B, rcfg.n_context_tokens, rcfg.d_model))
               * 0.1).astype(np.float32)
    return rcfg, tcfg, params, tparams, prompts, ctx


def _gen(cfg):
    """Tokens generated for ``cfg``: GEN (one tail flush), or KV_TAIL (no
    flush) where a sliding window is shorter than the ring tail, since the
    reference's ``flush_tails`` cannot write a 64-row tail into a shorter
    window's prefix (the reduced Mixtral's window is 32).  The window still
    wraps: the prompt and the tokens overrun it."""
    if 0 < cfg.sliding_window < REF_KV_TAIL:
        return REF_KV_TAIL
    return GEN


def _ctx(ctx, cfg, pkg):
    if ctx is None:
        return None
    if pkg == "ref":
        return jnp.asarray(ctx, JD[cfg.param_dtype])
    return torch.as_tensor(ctx).to(TD[cfg.param_dtype])


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ref_generate(params, cfg, prompts, gen, ctx, forced=None):
    """The reference serve loop (``repro.launch.serve.serve``), greedy or
    fed the tokens ``forced`` [B, gen]; returns (prefill logits, per-step
    logits, tokens)."""
    logits, caches = jax.jit(lambda p, t, c: ref_lm.prefill(p, cfg, t, c))(
        params, jnp.asarray(prompts), ctx)
    caches = ref_lm.extend_caches(caches, cfg, prompts.shape[1] + gen)
    step = jax.jit(lambda p, tok, c, pos: ref_lm.decode_step(p, cfg, tok, c,
                                                             pos))
    flush = jax.jit(lambda c: ref_lm.flush_tails(c, cfg))
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    toks, steps = [tok], []
    for i in range(gen - 1):
        if forced is not None:
            tok = jnp.asarray(forced[:, i:i + 1])
        lg, caches = step(params, tok, caches,
                          jnp.asarray(prompts.shape[1] + i))
        if (i + 1) % REF_KV_TAIL == 0:
            caches = flush(caches)
        steps.append(np.asarray(lg[:, -1], np.float32))
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
        toks.append(tok)
    return (np.asarray(logits, np.float32), steps,
            np.concatenate([np.asarray(t) for t in toks], axis=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_caches_match_reference(arch):
    rcfg, tcfg, params, tparams, prompts, ctx = _setup(arch, "float32")
    want, rcaches = ref_lm.forward(params, rcfg, jnp.asarray(prompts),
                                   _ctx(ctx, rcfg, "ref"),
                                   collect_caches=True)
    got, tcaches = lm.forward(tparams, tcfg, torch.as_tensor(prompts).long(),
                              _ctx(ctx, tcfg, "port"), collect_caches=True)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) < 1e-4
    assert set(tcaches) == set(rcaches)
    for pj in tcaches:
        assert set(tcaches[pj]) == set(rcaches[pj])
        for name, t in tcaches[pj].items():
            assert tuple(t.shape) == rcaches[pj][name].shape
            assert _rel(t, rcaches[pj][name]) < 1e-4
    ext_r = ref_lm.extend_caches(rcaches, rcfg, S + GEN)
    ext_t = lm.extend_caches(tcaches, tcfg, S + GEN)
    for pj in ext_t:
        assert set(ext_t[pj]) == set(ext_r[pj])
        for name, t in ext_t[pj].items():
            assert tuple(t.shape) == ext_r[pj][name].shape, (pj, name)
    last, _ = lm.prefill(tparams, tcfg, torch.as_tensor(prompts).long(),
                         _ctx(ctx, tcfg, "port"))
    assert torch.equal(last, got[:, -1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_in_float32(arch):
    rcfg, tcfg, params, tparams, prompts, ctx = _setup(arch, "float32")
    gen = _gen(rcfg)
    r_logits, _, r_tokens = _ref_generate(params, rcfg, prompts, gen,
                                          _ctx(ctx, rcfg, "ref"))
    g = generate(tparams, tcfg, torch.as_tensor(prompts).long(), gen,
                 _ctx(ctx, tcfg, "port"))
    assert _rel(g.prefill_logits, r_logits) < 1e-4
    assert g.tokens.shape == (B, gen) and g.tokens.dtype == np.int32
    np.testing.assert_array_equal(g.tokens, r_tokens)
    assert np.isfinite(g.tok_s) and g.tok_s > 0


def _port_forced(tparams, tcfg, prompts, forced, ctx):
    """The port's decode steps fed the tokens ``forced`` (as
    :func:`_ref_generate`), tails flushed every KV_TAIL steps."""
    prompts = torch.as_tensor(prompts).long()
    logits, caches = lm.prefill(tparams, tcfg, prompts, ctx)
    caches = lm.extend_caches(caches, tcfg, S + forced.shape[1])
    steps = []
    with torch.no_grad():
        for i in range(forced.shape[1] - 1):
            lg, caches = lm.decode_step(
                tparams, tcfg, torch.as_tensor(forced[:, i:i + 1]).long(),
                caches, S + i)
            if (i + 1) % blk.KV_TAIL == 0:
                caches = lm.flush_tails(caches, tcfg)
            steps.append(lg[:, -1])
    return logits, steps


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_in_own_dtype_matches_reference(arch):
    rcfg, tcfg, params, tparams, prompts, ctx = _setup(arch)
    assert rcfg.param_dtype == "bfloat16"
    gen = _gen(rcfg)
    forced = np.random.default_rng(5).integers(0, rcfg.vocab, (B, gen)) \
        .astype(np.int32)
    r_logits, r_steps, _ = _ref_generate(params, rcfg, prompts, gen,
                                         _ctx(ctx, rcfg, "ref"), forced)
    t_logits, t_steps = _port_forced(tparams, tcfg, prompts, forced,
                                     _ctx(ctx, tcfg, "port"))
    assert t_logits.dtype == torch.bfloat16
    assert _rel(t_logits, r_logits) < 5e-2
    assert len(t_steps) == len(r_steps) == gen - 1
    for i, (t, r) in enumerate(zip(t_steps, r_steps)):
        assert _rel(t, r) < 5e-2, i


@pytest.mark.parametrize("kw", [
    dict(sliding_window=5), dict(tie_embeddings=True, qkv_bias=True),
    dict(mlp_gated=False)], ids=["window", "tied-bias", "gelu"])
def test_config_variants_match_reference(kw):
    """Options the reference's LM takes and the ported configs leave off,
    on the reduced Llama in float32 (16 tokens: a sliding-window prefix is
    shorter than the ring tail, which a flush needs)."""
    rcfg, tcfg, params, tparams, prompts, ctx = _setup(
        "llama3.1-8b", "float32", **kw)
    r_logits, _, r_tokens = _ref_generate(params, rcfg, prompts, 16, None)
    g = generate(tparams, tcfg, torch.as_tensor(prompts).long(), 16)
    assert _rel(g.prefill_logits, r_logits) < 1e-4
    np.testing.assert_array_equal(g.tokens, r_tokens)


def test_prompt_longer_than_the_window_matches_reference():
    """Mixtral's serving run on the card prefills a prompt longer than its
    window; here the reduced Mixtral (window 32) in float32 takes a
    40-token prompt, so the prefill masks its oldest keys and the decode
    ring starts full."""
    rcfg, tcfg, params, tparams, _, _ = _setup("mixtral-8x7b", "float32")
    prompts = np.random.default_rng(3).integers(
        0, rcfg.vocab, (B, 40)).astype(np.int32)
    r_logits, _, r_tokens = _ref_generate(params, rcfg, prompts, 24, None)
    g = generate(tparams, tcfg, torch.as_tensor(prompts).long(), 24)
    assert _rel(g.prefill_logits, r_logits) < 1e-4
    np.testing.assert_array_equal(g.tokens, r_tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    rcfg, tcfg = ref_reduced(arch), get_reduced(arch)
    want = jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)),
        jax.eval_shape(lambda: ref_lm.init_params(jax.random.PRNGKey(0),
                                                  rcfg)))
    got = lm.init_params(tcfg, seed=0, device="cpu")

    def layout(t):
        if isinstance(t, dict):
            return {k: layout(v) for k, v in t.items()}
        return (tuple(t.shape), str(t.dtype).split(".")[-1])
    assert layout(got) == want
    n = sum(int(np.prod(s)) for s, _ in jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, tuple)))
    assert abs(n - tcfg.param_counts()["total"]) / n < 0.08
    again = lm.init_params(tcfg, seed=0, device="cpu")
    assert torch.equal(again["embed"]["w"], got["embed"]["w"])


@pytest.mark.parametrize("kw", [
    lambda base: dict(mla=base.MLAConfig()),
    lambda base: dict(cross_attn_every=2, family="vlm", n_context_tokens=8),
    lambda base: dict(family="ssm", xlstm=base.XLSTMConfig(slstm_every=2)),
    lambda base: dict(enc_layers=2, n_audio_frames=8),
], ids=["mla", "xattn", "xlstm", "encdec"])
def test_unported_parts_are_refused_by_name(kw):
    """The parts this test once found refused by name (MLA,
    cross-attention, xLSTM, the Whisper encoder) are ported: each case now
    holds the part, switched on in the reduced Llama (2 layers, float32),
    against the reference: forward logits and one decode step within
    1e-4."""
    from repro.configs import base as ref_base
    from repro_torch.configs import base as port_base
    rcfg = dataclasses.replace(ref_reduced("llama3.1-8b"), n_layers=2,
                               param_dtype="float32", **kw(ref_base))
    tcfg = dataclasses.replace(get_reduced("llama3.1-8b"), n_layers=2,
                               param_dtype="float32", **kw(port_base))
    params = ref_lm.init_params(jax.random.PRNGKey(2), rcfg)
    params = jax.tree_util.tree_map_with_path(
        lambda kp, a: jnp.full_like(a, 0.5)
        if getattr(kp[-1], "key", None) == "x_gate" else a, params)
    tparams = convert.lm_params(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    ctx = None
    n_ctx = rcfg.n_audio_frames if rcfg.is_encdec else rcfg.n_context_tokens
    if n_ctx:
        ctx = (rng.normal(0, 1, (B, n_ctx, rcfg.d_model)) * 0.1).astype(
            np.float32)
    jctx = None if ctx is None else jnp.asarray(ctx)
    tctx = None if ctx is None else torch.as_tensor(ctx)
    want, rc = ref_lm.prefill(params, rcfg, jnp.asarray(prompts), jctx)
    got, tc = lm.prefill(tparams, tcfg, torch.as_tensor(prompts).long(),
                         tctx)
    assert _rel(got, want) < 1e-4
    rc = ref_lm.extend_caches(rc, rcfg, S + 4)
    tc = lm.extend_caches(tc, tcfg, S + 4)
    tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    rl, _ = ref_lm.decode_step(params, rcfg, jnp.asarray(tok), rc,
                               jnp.asarray(S))
    with torch.no_grad():
        tl, _ = lm.decode_step(tparams, tcfg, torch.as_tensor(tok).long(), tc,
                               S)
    assert _rel(tl, rl) < 1e-4


def test_flush_tails_writes_the_tail_at_plen_and_advances_it():
    tcfg = get_reduced("llama3.1-8b")
    caches = lm.init_caches(tcfg, 1, 128, device="cpu")
    caches = {pj: dict(c, k_tail=torch.ones_like(c["k_tail"]),
                       plen=torch.full_like(c["plen"], 32))
              for pj, c in caches.items()}
    out = lm.flush_tails(caches, tcfg)["p0"]
    assert out["k"][:, :, 32:32 + blk.KV_TAIL].eq(1).all()
    assert not out["k"][:, :, :32].any() and not out["v"].any()
    assert out["plen"].tolist() == [32 + blk.KV_TAIL] * tcfg.n_layers
    assert not caches["p0"]["k"].any()          # the input is not modified


def test_a_window_shorter_than_the_tail_is_refused():
    """A sliding window shorter than ``KV_TAIL`` cannot take a tail flush;
    the reference's ``flush_tails`` fails there in its update slice.  The
    port refuses with a ``ValueError`` naming the window and the tail:
    ``generate`` before its prefill when a flush would come, and
    ``flush_tails`` itself.  A run that stops short of the first flush
    still serves (``_gen``, the tests above)."""
    rcfg, tcfg, params, tparams, prompts, _ = _setup("mixtral-8x7b",
                                                     "float32")
    assert 0 < tcfg.sliding_window < blk.KV_TAIL
    msg = (f"sliding window of {tcfg.sliding_window} .*KV_TAIL = "
           f"{blk.KV_TAIL}")
    with mock.patch.object(lm, "prefill", side_effect=AssertionError), \
            pytest.raises(ValueError, match=msg):
        generate(tparams, tcfg, torch.as_tensor(prompts).long(),
                 blk.KV_TAIL + 1)
    with torch.no_grad():
        _, caches = lm.prefill(tparams, tcfg, torch.as_tensor(prompts).long())
    with pytest.raises(ValueError, match=msg):
        lm.flush_tails(lm.extend_caches(caches, tcfg, S + GEN), tcfg)
    _, rc = ref_lm.prefill(params, rcfg, jnp.asarray(prompts))
    with pytest.raises(Exception):
        ref_lm.flush_tails(ref_lm.extend_caches(rc, rcfg, S + GEN), rcfg)
