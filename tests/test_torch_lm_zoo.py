"""The rest of the LM zoo in the port against the JAX reference, on the
CPU, on the reference's weights (``convert.lm_params``) in float32 copies
of the reduced configs: MiniCPM3-4B (MLA, its absorbed-projection decode),
Llama 3.2 Vision (cross-attention onto image embeddings, ``xk``/``xv``
cached at prefill), Whisper medium (the encoder, cross-attention in every
decoder layer) and xLSTM (mLSTM and sLSTM).

Each: the forward's logits and the prefill caches, the decode caches after
``extend_caches``, 8 decode steps fed the same tokens, greedy ``generate``
(72 tokens, one tail flush) with identical tokens, and the port's own
decode matching its forward (``tests/test_arch_smoke.py``).  Logits within
1e-4 of max |logit|, as ``tests/test_torch_lm.py`` holds the rest of the
zoo.  The cross-attention gates start at 0 in both packages (tanh(0)
shuts the cross path); they are set to 0.5 here so that it counts."""
import dataclasses

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
from repro_torch.models import lm

ARCHS = ["minicpm3-4b", "llama-3.2-vision-90b", "whisper-medium",
         "xlstm-1.3b"]
B, S, GEN = 2, 12, 72


def _setup(arch, seed=1):
    rcfg = dataclasses.replace(ref_reduced(arch), param_dtype="float32")
    tcfg = dataclasses.replace(get_reduced(arch), param_dtype="float32")
    params = ref_lm.init_params(jax.random.PRNGKey(seed), rcfg)
    params = jax.tree_util.tree_map_with_path(
        lambda kp, a: jnp.full_like(a, 0.5)
        if getattr(kp[-1], "key", None) == "x_gate" else a, params)
    tparams = convert.lm_params(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    ctx = None
    if rcfg.n_context_tokens or rcfg.is_encdec:
        n = rcfg.n_audio_frames if rcfg.is_encdec else rcfg.n_context_tokens
        ctx = (rng.normal(0, 1, (B, n, rcfg.d_model)) * 0.1).astype(
            np.float32)
    return rcfg, tcfg, params, tparams, prompts, ctx


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(x):
    return None if x is None else torch.as_tensor(x)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_caches_match_reference(arch):
    rcfg, tcfg, params, tparams, prompts, ctx = _setup(arch)
    want, rcaches = ref_lm.forward(params, rcfg, jnp.asarray(prompts),
                                   None if ctx is None else jnp.asarray(ctx),
                                   collect_caches=True)
    got, tcaches = lm.forward(tparams, tcfg, torch.as_tensor(prompts).long(),
                              _t(ctx), collect_caches=True)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-4
    assert set(tcaches) == set(rcaches)
    for pj in tcaches:
        assert set(tcaches[pj]) == set(rcaches[pj]), pj
        for name, t in tcaches[pj].items():
            assert tuple(t.shape) == rcaches[pj][name].shape, (pj, name)
            assert str(t.dtype).split(".")[-1] == str(rcaches[pj][name].dtype)
            assert _rel(t, rcaches[pj][name]) < 1e-4, (pj, name)
    ext_r = ref_lm.extend_caches(rcaches, rcfg, S + GEN)
    ext_t = lm.extend_caches(tcaches, tcfg, S + GEN)
    for pj in ext_t:
        assert set(ext_t[pj]) == set(ext_r[pj]), pj
        for name, t in ext_t[pj].items():
            assert tuple(t.shape) == ext_r[pj][name].shape, (pj, name)
            assert _rel(t, ext_r[pj][name]) < 1e-4 or not np.abs(
                np.asarray(ext_r[pj][name], np.float32)).max(), (pj, name)
    init_r = ref_lm.init_caches(rcfg, B, S + GEN)
    init_t = lm.init_caches(tcfg, B, S + GEN, device="cpu")
    for pj in init_t:
        assert {k: tuple(v.shape) for k, v in init_t[pj].items()} == \
            {k: v.shape for k, v in init_r[pj].items()}, pj


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    rcfg, tcfg, params, tparams, prompts, ctx = _setup(arch)
    forced = np.random.default_rng(5).integers(0, rcfg.vocab, (B, 8)) \
        .astype(np.int32)
    jctx = None if ctx is None else jnp.asarray(ctx)
    _, rc = ref_lm.prefill(params, rcfg, jnp.asarray(prompts), jctx)
    rc = ref_lm.extend_caches(rc, rcfg, S + 8)
    _, tc = lm.prefill(tparams, tcfg, torch.as_tensor(prompts).long(),
                       _t(ctx))
    tc = lm.extend_caches(tc, tcfg, S + 8)
    step = jax.jit(lambda p, tok, c, pos: ref_lm.decode_step(p, rcfg, tok, c,
                                                             pos))
    with torch.no_grad():
        for i in range(8):
            rl, rc = step(params, jnp.asarray(forced[:, i:i + 1]), rc,
                          jnp.asarray(S + i))
            tl, tc = lm.decode_step(tparams, tcfg,
                                    torch.as_tensor(forced[:, i:i + 1])
                                    .long(), tc, S + i)
            assert _rel(tl, rl) < 1e-4, i
    for pj in tc:
        for name, t in tc[pj].items():
            assert _rel(t, rc[pj][name]) < 1e-4 or not np.abs(
                np.asarray(rc[pj][name], np.float32)).max(), (pj, name)


def _ref_generate(params, cfg, prompts, gen, ctx):
    """The reference serve loop (``repro.launch.serve.serve``), greedy."""
    logits, caches = jax.jit(lambda p, t, c: ref_lm.prefill(p, cfg, t, c))(
        params, jnp.asarray(prompts), ctx)
    caches = ref_lm.extend_caches(caches, cfg, prompts.shape[1] + gen)
    step = jax.jit(lambda p, tok, c, pos: ref_lm.decode_step(p, cfg, tok, c,
                                                             pos))
    flush = jax.jit(lambda c: ref_lm.flush_tails(c, cfg))
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    toks = [tok]
    for i in range(gen - 1):
        lg, caches = step(params, tok, caches,
                          jnp.asarray(prompts.shape[1] + i))
        if (i + 1) % REF_KV_TAIL == 0:
            caches = flush(caches)
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
        toks.append(tok)
    return (np.asarray(logits, np.float32),
            np.concatenate([np.asarray(t) for t in toks], axis=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_in_float32(arch):
    rcfg, tcfg, params, tparams, prompts, ctx = _setup(arch)
    r_logits, r_tokens = _ref_generate(
        params, rcfg, prompts, GEN, None if ctx is None else jnp.asarray(ctx))
    g = generate(tparams, tcfg, torch.as_tensor(prompts).long(), GEN,
                 _t(ctx))
    assert _rel(g.prefill_logits, r_logits) < 1e-4
    assert g.tokens.shape == (B, GEN) and g.tokens.dtype == np.int32
    np.testing.assert_array_equal(g.tokens, r_tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own prefill + one decode step against its full forward
    (the reference's ``test_decode_matches_forward``, its 5e-2 bound, in
    the config's own bf16)."""
    cfg = get_reduced(arch)
    params = lm.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S))).long()
    ctx = None
    if cfg.n_context_tokens or cfg.is_encdec:
        n = cfg.n_audio_frames if cfg.is_encdec else cfg.n_context_tokens
        ctx = (torch.as_tensor(rng.normal(0, 1, (B, n, cfg.d_model)))
               * 0.1).to(torch.bfloat16)
    with torch.no_grad():
        full = lm.forward(params, cfg, tokens, ctx)
        _, caches = lm.prefill(params, cfg, tokens[:, :S - 1], ctx)
        caches = lm.extend_caches(caches, cfg, S + 4)
        lg, _ = lm.decode_step(params, cfg, tokens[:, S - 1:S], caches,
                               S - 1)
    assert _rel(lg[:, -1], full[:, -1].float()) < 5e-2


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
    # convert carries every new leaf (enc/*, x_*, MLA, xLSTM) across by
    # the reference's name, shape and type
    params = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    conv = convert.lm_params(jax.tree_util.tree_map(np.asarray, params))
    assert layout(conv) == want
