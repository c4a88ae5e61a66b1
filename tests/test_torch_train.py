"""The port's training path against the JAX reference's, on the CPU: the
data pipeline (bitwise), the loss (``layers.cross_entropy``, ``lm.loss_fn``
unchunked and chunked), the schedule, AdamW (weight decay, bf16 kept),
one ``make_train_step`` per architecture family on the same weights
(``convert.lm_params``, float32 copies of the reduced configs): loss,
grad norm, every gradient leaf and the parameters after the step; the
gradients of the kernels' plain versions against ``jax.grad`` of the
reference's oracles; checkpoints read across the two packages; and the
port's ``train`` driver (kill/resume bitwise, every reduced config, the
CLI).

Tolerances are those of ``tests/test_torch_lm.py``: float32 results within
1e-4 of the largest magnitude of what they are compared with."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_ckpt
from repro.configs import get_reduced as ref_reduced
from repro.data import pipeline as ref_pipe
from repro.kernels import ref as ref_kernels
from repro.models import layers as ref_L
from repro.models import lm as ref_lm
from repro.optim import adam as ref_adam
from repro.optim import trainer as ref_trainer
from repro_torch import convert
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ARCH_IDS
from repro_torch.data import pipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as ss
from repro_torch.launch import train as train_mod
from repro_torch.models import attention
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim import adam, trainer


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k],
                                                           f"{prefix}/{k}")]
    return [(prefix, tree)]


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("seed,step,n_shards,shard,kind", [
    (0, 0, 1, 0, "lcg"), (3, 17, 1, 0, "lcg"), (1, 5, 4, 2, "lcg"),
    (0, 9, 1, 0, "uniform"), (7, 100, 2, 1, "uniform")])
def test_batch_at_is_bitwise_the_reference(seed, step, n_shards, shard, kind):
    kw = dict(vocab=301, seq_len=33, global_batch=8, seed=seed, kind=kind,
              n_shards=n_shards, shard=shard)
    got = pipeline.batch_at(pipeline.DataConfig(**kw), step)
    want = ref_pipe.batch_at(ref_pipe.DataConfig(**kw), step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# -------------------------------------------------------------------- loss
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.normal(0, 3, (2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    want = ref_L.cross_entropy(jnp.asarray(logits).astype(dtype),
                               jnp.asarray(labels))
    got = L.cross_entropy(torch.as_tensor(logits).to(L.dtype_of(dtype)),
                          torch.as_tensor(labels).long())
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def _setup(arch, seed=0, **kw):
    kw.setdefault("param_dtype", "float32")
    rcfg = dataclasses.replace(ref_reduced(arch), **kw)
    tcfg = dataclasses.replace(get_reduced(arch), **kw)
    params = ref_lm.init_params(jax.random.PRNGKey(seed), rcfg)
    # a nonzero cross-attention gate, so that the cross path counts
    params = jax.tree_util.tree_map_with_path(
        lambda kp, a: jnp.full_like(a, 0.5)
        if getattr(kp[-1], "key", None) == "x_gate" else a, params)
    tparams = convert.lm_params(jax.tree_util.tree_map(np.asarray, params))
    return rcfg, tcfg, params, tparams


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    b = dict(tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             labels=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    if cfg.n_context_tokens or cfg.is_encdec:
        n = cfg.n_audio_frames if cfg.is_encdec else cfg.n_context_tokens
        b["ctx"] = (rng.normal(0, 1, (B, n, cfg.d_model)) * 0.1).astype(
            np.float32)
    return b


def _ref_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_batch(b):
    return {k: torch.as_tensor(v).long() if k != "ctx" else torch.as_tensor(v)
            for k, v in b.items()}


@pytest.mark.parametrize("S", [16, 1024], ids=["unchunked", "chunked"])
def test_loss_fn_matches_reference(S):
    rcfg, tcfg, params, tparams = _setup("smollm-135m")
    b = _batch(rcfg, B=2, S=S)
    want = jax.jit(lambda p, t, l: ref_lm.loss_fn(p, rcfg, t, l))(
        params, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
    got = lm.loss_fn(tparams, tcfg, torch.as_tensor(b["tokens"]).long(),
                     torch.as_tensor(b["labels"]).long())
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    # the chunked sum equals the one-block mean of the same logits
    whole = L.cross_entropy(lm.forward(tparams, tcfg, torch.as_tensor(
        b["tokens"]).long()), torch.as_tensor(b["labels"]).long())
    assert abs(float(got) - float(whole)) <= 1e-5 * abs(float(whole))


def test_forward_return_hidden_is_the_normed_state():
    _, tcfg, _, tparams = _setup("llama3.1-8b")
    toks = torch.as_tensor(_batch(tcfg)["tokens"]).long()
    x = lm.forward(tparams, tcfg, toks, return_hidden=True)
    logits = lm.forward(tparams, tcfg, toks)
    assert x.shape == (2, 16, tcfg.d_model)
    torch.testing.assert_close(L.linear(tparams["lm_head"], x), logits)


# ------------------------------------------------------ schedule and Adam
def test_lr_schedule_matches_reference():
    tc = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    rtc, ttc = ref_trainer.TrainConfig(**tc), trainer.TrainConfig(**tc)
    for step in range(0, 101):
        want = ref_trainer.lr_schedule(rtc, jnp.asarray(step, jnp.int32))
        got = trainer.lr_schedule(ttc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-6 * float(want), step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adam_update_matches_reference(dtype, clip):
    rng = np.random.default_rng(1)
    p = {"a": rng.normal(0, 1, (5, 7)).astype(np.float32),
         "b": {"c": rng.normal(0, 1, (11,)).astype(np.float32)}}
    g = jax.tree_util.tree_map(lambda x: rng.normal(0, 3, x.shape)
                               .astype(np.float32), p)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), p)
    jg = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), g)
    rstate = ref_trainer.create_state(jp).opt
    tp = convert.lm_params(jax.tree_util.tree_map(np.asarray, jp))
    tg = convert.lm_params(jax.tree_util.tree_map(np.asarray, jg))
    tstate = trainer.create_state(tp).opt
    kw = dict(weight_decay=0.01, grad_clip=clip)
    for i in range(3):
        jp, rstate = ref_adam.adam_update(jp, jg, rstate,
                                          lr=jnp.float32(1e-2), **kw)
        tp, tstate = adam.adam_update(tp, tg, tstate,
                                      lr=torch.tensor(1e-2), **kw)
    for (name, got), (_, want) in zip(_leaves(tp), _leaves(jp)):
        assert got.dtype == L.dtype_of(dtype), name     # bf16 stays bf16
        tol = 1e-6 if dtype == "float32" else 1e-2
        assert _rel(got, want) < tol, name
    for (_, got), (_, want) in zip(_leaves(tstate.m), _leaves(rstate.m)):
        assert got.dtype == torch.float32
        assert _rel(got, want) < 1e-6


def test_adam_inplace_update_is_the_pure_one_bitwise():
    rng = np.random.default_rng(2)
    p = {"w": torch.as_tensor(rng.normal(0, 1, (9, 4)).astype(np.float32))
         .to(torch.bfloat16)}
    g = {"w": torch.as_tensor(rng.normal(0, 1, (9, 4)).astype(np.float32))
         .to(torch.bfloat16)}
    st = trainer.create_state(p).opt
    pure, pst = adam.adam_update(p, g, st, lr=torch.tensor(1e-2),
                                 weight_decay=0.01, grad_clip=1.0)
    p2 = {"w": p["w"].clone()}
    st2 = trainer.create_state(p2).opt
    new, nst = adam.adam_update(p2, g, st2, lr=torch.tensor(1e-2),
                                weight_decay=0.01, grad_clip=1.0,
                                inplace=True)
    assert new["w"] is p2["w"] and nst.m["w"] is st2.m["w"]
    assert torch.equal(new["w"], pure["w"]) and torch.equal(nst.v["w"],
                                                            pst.v["w"])
    assert not torch.equal(p["w"], pure["w"])        # the pure one is pure


# ------------------------------------------------------- one train step
TRAIN_ARCHS = ["smollm-135m", "mixtral-8x7b", "jamba-v0.1-52b",
               "minicpm3-4b", "llama-3.2-vision-90b", "whisper-medium",
               "xlstm-1.3b"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_reference(arch):
    rcfg, tcfg, params, tparams = _setup(arch)
    b = _batch(rcfg)
    tc = dict(lr=1e-3, warmup_steps=1, total_steps=10)

    def ref_step(params, batch):     # the gradients and the step, one jit
        grads = jax.value_and_grad(lambda p: ref_lm.loss_fn(
            p, rcfg, batch["tokens"], batch["labels"], batch.get("ctx")))(
            params)
        return grads, ref_trainer.make_train_step(
            rcfg, ref_trainer.TrainConfig(**tc))(
            ref_trainer.create_state(params), batch)
    (r_loss, r_grads), (rstate, rmet) = jax.jit(ref_step)(params,
                                                          _ref_batch(b))
    step_fn = trainer.make_train_step(tcfg, trainer.TrainConfig(**tc))
    t_loss, t_grads = trainer._value_and_grad(
        lambda p, bb: lm.loss_fn(p, tcfg, bb["tokens"], bb["labels"],
                                 bb.get("ctx")), tparams, _port_batch(b))
    assert abs(float(t_loss) - float(r_loss)) <= 1e-4 * abs(float(r_loss))
    rl, tl = dict(_leaves(r_grads)), dict(_leaves(t_grads))
    assert set(rl) == set(tl)
    for name in rl:
        assert _rel(tl[name], rl[name]) < 1e-4, name
    tstate, tmet = step_fn(trainer.create_state(tparams), _port_batch(b))
    for key in ("loss", "lr", "grad_norm"):
        assert abs(float(tmet[key]) - float(rmet[key])) \
            <= 1e-4 * abs(float(rmet[key])), key
    assert int(tstate.step) == int(rstate.step) == 1
    _hold_params(tstate.params, rstate.params, tc["lr"])


def _hold_params(got, want, lr):
    """Parameters after Adam steps: within 1e-4 of each leaf's largest
    magnitude, counted as at least 10 lr.  Adam moves an element by about
    lr whatever its gradient's size, except near its eps, where a gradient
    that differs in its float32 rounding moves it by another share of lr;
    a zero-initialised leaf holds nothing but such steps."""
    for (name, a_), (_, b_) in zip(_leaves(got), _leaves(want)):
        scale = max(float(np.abs(_np(b_)).max()), 10 * lr)
        assert float(np.abs(_np(a_) - _np(b_)).max()) <= 1e-4 * scale, name


def test_microbatches_two_match_one():
    _, tcfg, _, tparams = _setup("smollm-135m")
    b = _port_batch(_batch(tcfg, B=4))
    out = {}
    for n in (1, 2):
        tc = trainer.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                                 microbatches=n)
        p = adam.tree_map(lambda t: t.clone(), tparams)   # updated in place
        out[n] = trainer.make_train_step(tcfg, tc)(trainer.create_state(p), b)
    (s1, m1), (s2, m2) = out[1], out[2]
    for key in ("loss", "grad_norm"):
        assert abs(float(m2[key]) - float(m1[key])) <= 1e-5 * float(m1[key])
    _hold_params(s2.params, s1.params, 1e-3)


# ----------------------------------- the kernels' plain versions' gradients
@pytest.mark.parametrize("B,H,Hk,Sq,Sk,hd,vd,causal,window", [
    (2, 4, 2, 24, 24, 16, 16, True, 0),        # causal, GQA
    (1, 4, 4, 20, 33, 16, 16, False, 0),       # non-causal, Sq != Sk
    (1, 4, 2, 30, 30, 8, 8, True, 7),          # window
    (1, 2, 1, 30, 12, 8, 8, True, 5),          # rows that see no key
    (1, 4, 4, 18, 18, 24, 16, True, 0)],       # MLA: v padded to q's width
    ids=["causal-gqa", "noncausal", "window", "all-masked", "padded-v"])
def test_attention_plain_gradients_match_jax(B, H, Hk, Sq, Sk, hd, vd,
                                             causal, window):
    rng = np.random.default_rng(Sq + Sk)
    q = rng.normal(0, 1, (B, H, Sq, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, Hk, Sk, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, Hk, Sk, vd)).astype(np.float32)
    do = rng.normal(0, 1, (B, H, Sq, vd)).astype(np.float32)
    f = lambda q_, k_, v_: jnp.sum(ref_kernels.attention_reference(
        q_, k_, v_, causal=causal, window=window) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.as_tensor(t).requires_grad_(True) for t in (q, k, v))
    if vd == hd:
        got = fa.flash_attention_backward_plain(
            tq, tk, tv, torch.as_tensor(do), causal=causal, window=window)
    else:   # the model's path: [B,S,H,hd] views, v padded for the kernel
        o = attention.chunked_attention(tq.transpose(1, 2),
                                        tk.transpose(1, 2),
                                        tv.transpose(1, 2), causal=causal,
                                        window=window)
        got = torch.autograd.grad(o, (tq, tk, tv),
                                  torch.as_tensor(do).transpose(1, 2))
    for name, g_, w_ in zip("qkv", got, want):
        assert g_.shape == w_.shape
        assert _rel(g_, w_) < 1e-5, name


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_plain_gradients_match_jax(with_h0):
    rng = np.random.default_rng(4)
    B, S, D, N = 2, 21, 12, 5
    ins = [rng.uniform(1e-3, 0.1, (B, S, D)), rng.normal(0, 1, (B, S, N)),
           rng.normal(0, 1, (B, S, N)), rng.normal(0, 1, (B, S, D)),
           -np.exp(0.5 * rng.normal(0, 1, (D, N)))]
    ins = [a.astype(np.float32) for a in ins]
    h0 = rng.normal(0, 1, (B, D, N)).astype(np.float32) if with_h0 else None
    dy = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    dh = rng.normal(0, 1, (B, D, N)).astype(np.float32)

    def f(*args):
        y, h = ref_kernels.ssm_scan_reference(*args[:5], args[5] if with_h0
                                              else None)
        return jnp.sum(y * dy) + jnp.sum(h * dh)
    n_args = 6 if with_h0 else 5
    want = jax.grad(f, argnums=tuple(range(n_args)))(
        *ins, *([h0] if with_h0 else [None]))
    got = ss.ssm_scan_backward_plain(
        *(torch.as_tensor(a) for a in ins),
        None if h0 is None else torch.as_tensor(h0), torch.as_tensor(dy),
        torch.as_tensor(dh))
    assert (got[5] is None) == (not with_h0)
    for i, w_ in enumerate(want):
        assert _rel(got[i], w_) < 1e-5, i


# ------------------------------------------------------------- checkpoints
def test_restore_round_trip_keeps_bf16(tmp_path):
    _, tcfg, _, _ = _setup("jamba-v0.1-52b", param_dtype="bfloat16")
    params = lm.init_params(tcfg, seed=1, device="cpu")
    state = trainer.create_state(params)
    ckpt.save(state, str(tmp_path), 3)
    got = ckpt.restore(state, str(tmp_path))
    assert isinstance(got, trainer.TrainState)
    for (name, a_), (_, b_) in zip(ckpt._leaves_with_names(got),
                                   ckpt._leaves_with_names(state)):
        assert a_.dtype == b_.dtype and torch.equal(a_, b_), name
    assert got.params["embed"]["w"].dtype == torch.bfloat16
    man = ckpt.manifest_of(str(tmp_path))
    assert man["dtypes"][".params/embed/w"] == "bfloat16"
    # a reference-saved bf16 state comes back bf16, bit for bit
    rcfg, _, rparams, _ = _setup("jamba-v0.1-52b", param_dtype="bfloat16")
    ref_ckpt.save(ref_trainer.create_state(rparams), str(tmp_path / "ref"),
                  1)
    got = ckpt.restore(trainer.create_state(lm.init_params(tcfg,
                                                           device="cpu")),
                       str(tmp_path / "ref"))
    for (name, a_), (_, b_) in zip(_leaves(got.params), _leaves(rparams)):
        assert str(a_.dtype).split(".")[-1] == str(b_.dtype), name
        np.testing.assert_array_equal(a_.float().numpy(),
                                      np.asarray(b_, np.float32))
    # the reference reads the port's bf16 leaves as bf16
    flat, _ = ref_ckpt.restore_flat(str(tmp_path))
    assert flat[".params/embed/w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(flat[".params/embed/w"], np.float32),
        params["embed"]["w"].float().numpy())


def _ref_train(rcfg, params, tc, batches, state=None):
    step = jax.jit(ref_trainer.make_train_step(rcfg, tc))
    state = state or ref_trainer.create_state(params)
    losses = []
    for b in batches:
        state, met = step(state, _ref_batch(b))
        losses.append(float(met["loss"]))
    return state, losses


def _port_train(tcfg, tc, batches, state):
    step = trainer.make_train_step(tcfg, tc)
    losses = []
    for b in batches:
        state, met = step(state, _port_batch(b))
        losses.append(float(met["loss"]))
    return state, losses


@pytest.mark.parametrize("first", ["reference", "port"])
def test_checkpoints_resume_across_packages(first, tmp_path):
    """2 steps in one package, saved; restored by the other, 2 more steps:
    the losses and parameters of the reference's straight 4 steps (float32;
    the bf16 leaves' round trip is held bitwise above)."""
    rcfg, tcfg, params, tparams = _setup("smollm-135m")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    rtc, ttc = ref_trainer.TrainConfig(**kw), trainer.TrainConfig(**kw)
    batches = [_batch(rcfg, seed=i) for i in range(4)]
    straight, want = _ref_train(rcfg, params, rtc, batches)
    if first == "reference":
        st, l1 = _ref_train(rcfg, params, rtc, batches[:2])
        ref_ckpt.save(st, str(tmp_path), 2)
        template = trainer.create_state(lm.init_params(tcfg, device="cpu"))
        st = ckpt.restore(template, str(tmp_path))
        st, l2 = _port_train(tcfg, ttc, batches[2:], st)
        got_params = st.params
    else:
        st, l1 = _port_train(tcfg, ttc, batches[:2],
                             trainer.create_state(tparams))
        ckpt.save(st, str(tmp_path), 2)
        st = ref_ckpt.restore(ref_trainer.create_state(params),
                              str(tmp_path))
        st, l2 = _ref_train(rcfg, None, rtc, batches[2:], st)
        got_params = st.params
    assert int(st.step) == 4
    np.testing.assert_allclose(l1 + l2, want, rtol=1e-4)
    _hold_params(got_params, straight.params, kw["lr"])


# ----------------------------------------------------------- the driver
def test_train_kill_resume_is_bitwise_on_the_cpu(tmp_path, capsys):
    kw = dict(steps=6, global_batch=2, seq_len=16, device="cpu",
              ckpt_every=100)
    full, l_full = train_mod.train("jamba-v0.1-52b",
                                   ckpt_dir=str(tmp_path / "a"), **kw)
    _, l_a = train_mod.train("jamba-v0.1-52b", ckpt_dir=str(tmp_path / "b"),
                             stop_after=3, **kw)
    assert "simulated preemption after 3 steps" in capsys.readouterr().out
    resumed, l_b = train_mod.train("jamba-v0.1-52b",
                                   ckpt_dir=str(tmp_path / "b"),
                                   resume="auto", **kw)
    assert "resumed from step 3" in capsys.readouterr().out
    assert l_a + l_b == l_full
    for (name, a_), (_, b_) in zip(ckpt._leaves_with_names(resumed),
                                   ckpt._leaves_with_names(full)):
        assert torch.equal(a_, b_), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_cli_trains_every_reduced_config_on_the_cpu(arch, capsys):
    train_mod.main(["--arch", arch, "--reduced", "--steps", "2", "--batch",
                    "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    steps = [line for line in out if line.startswith("[train] step")]
    assert len(steps) == 2
    assert all(np.isfinite(float(s.split()[4])) for s in steps)


def test_train_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mod.main(["--arch", "smollm-135m", "--reduced", "--steps", "1",
                        "--device", "cuda"])
