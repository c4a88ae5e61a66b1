"""Published Jamba in the port (``repro_torch.configs.ai21_jamba2_mini``:
AI21-Jamba2-Mini's block, that of Jamba v0.1) against the benchmark's
plain float32 reference (``perfbench/reference/jamba.py``) on the CPU, at
the config's ``reduced()`` size: two whole 8-layer periods, attention at
slot 4 with no positions, 4 experts on the odd slots with the top-2
probabilities as gates, Mamba with dt rank 8 and the RMSNorms on dt, B
and C.  The weights are the benchmark's, drawn from a seed into the
reference's ``leaf_specs`` tree.  Then the options' defaults, which keep
the zoo's models (and their parity with the JAX reference) as they were;
the harness's rebinding of the MoE block's functions on a Jamba request;
and the Mamba mixer's serving spans and token counter."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

BENCH = Path(__file__).resolve().parents[1] / "perfbench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from benchlib import model, tracing  # noqa: E402
from reference import jamba as ref  # noqa: E402

from repro_torch.configs import ARCH_IDS, ai21_jamba2_mini  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import blocks, lm  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 17
# Float32 port against the float32 reference: they differ only where the
# two associate sums differently (the sequential scan against the
# reference's doubling scan, the MoE's dense-masked and grouped sums
# against its per-expert ones, attention's blocks), ~1e-5 of a row's
# spread (measured up to 1.0e-5); in bf16 the rows move by 0.1-1.
TOL = 1e-4


def as_run(dtype: str) -> dict:
    """The ``as_run`` section a benchmark configuration of the reduced
    published Jamba would hold."""
    cfg = ai21_jamba2_mini.reduced()
    c = dataclasses.asdict(cfg)
    c["param_dtype"] = dtype
    _, _, slots = lm._layout(cfg)
    c["period"] = [dict(kind=k, moe=m) for k, m in slots]
    c["moe_dispatch"] = dict(dropless_max_tokens=512, group_tokens=8192,
                             capacity_factor=blocks.MOE_CAPACITY)
    return c


def weights(dtype: str):
    c = as_run(dtype)
    return c, model.arch_config(c), model.make_weights(ref.leaf_specs(c),
                                                       SEED, CPU)


def prompts(cfg, B: int, S: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(S)
    return torch.randint(0, cfg.vocab, (B, S), generator=gen)


def _flat(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + (k,))
        else:
            yield pre + (k,), (tuple(v.shape), v.dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_leaf_specs_lay_out_the_tree_of_init_params(dtype):
    c = as_run(dtype)
    cfg = model.arch_config(c)
    theirs = dict(_flat(lm.init_params(cfg, seed=0, device=CPU)))
    ours = dict(_flat(model.make_weights(ref.leaf_specs(c), SEED, CPU)))
    assert ours == theirs
    mamba = theirs[("blocks", "p0", "x_proj", "w")][0]
    assert mamba == (2, 128, 8 + 2 * 8)          # dt rank 8, B, C
    assert ("blocks", "p4", "wq", "w") in theirs   # attention at slot 4
    assert ("blocks", "p0", "dt_norm", "scale") in theirs


@torch.no_grad()
def _prefill_errors(dtype: str, B: int, S: int) -> torch.Tensor:
    c, cfg, w = weights(dtype)
    tokens = prompts(cfg, B, S)
    got = lm.forward(w, cfg, tokens)
    want = ref.logits_at(w, c, tokens, list(range(S)), S)
    return ref.rel_err(got, want)


# (2, 40): the MoE's dropless dense path; (2, 320): 640 prompt tokens,
# the grouped capacity dispatch with tokens dropped
@pytest.mark.parametrize("B,S", [(2, 40), (2, 320)])
def test_prefill_logits_match_the_reference(B, S):
    err = _prefill_errors("float32", B, S)
    assert err.shape == (B, S)
    assert float(err.max()) < TOL


def test_bf16_fails_the_float32_tolerance():
    """The comparison sees the precision the program computes in: the same
    weights served in bf16 miss the tolerance by orders of magnitude."""
    err = _prefill_errors("bfloat16", 2, 40)
    assert float(err.max()) > 100 * TOL
    assert float(err.median()) > 10 * TOL


@torch.no_grad()
def test_prefill_then_decode_through_the_caches_matches_the_full_forward(
        monkeypatch):
    """``serve.generate`` (prefill, the Mamba states and the two-tier KV
    cache side by side, a tail flush at step 64) against the reference's
    full forward over the prompt and the served tokens, at every
    generated position."""
    c, cfg, w = weights("float32")
    B, S, gen = 2, 24, 70
    tokens = prompts(cfg, B, S)
    steps = []
    step = lm.decode_step

    def recorded(*args, **kwargs):
        logits, caches = step(*args, **kwargs)
        steps.append(logits)
        return logits, caches
    monkeypatch.setattr(lm, "decode_step", recorded)
    g = serve.generate(w, cfg, tokens, gen)
    assert len(steps) == gen - 1 and gen - 1 > blocks.KV_TAIL
    got = torch.cat([g.prefill_logits] + steps, dim=1)      # [B, gen, V]
    seq = torch.cat([tokens, torch.as_tensor(g.tokens[:, :-1]).long()], 1)
    want = ref.logits_at(w, c, seq, list(range(S - 1, S + gen - 1)), S)
    assert float(ref.rel_err(got, want).max()) < TOL


def test_selective_scan_equals_the_step_loop():
    """The reference's chunked doubling scan against the recurrence step
    by step in float64, past several chunks and channel blocks."""
    torch.manual_seed(0)
    B, L, D, N = 2, 3 * ref.SCAN_CHUNK + 5, 6, 4
    dt = torch.rand(B, L, D) * 0.5
    b, cm, x = torch.randn(B, L, N), torch.randn(B, L, N), torch.randn(B, L, D)
    a = -torch.exp(torch.randn(D, N))
    old = ref.SCAN_ELEMS
    ref.SCAN_ELEMS = B * 4 * ref.SCAN_CHUNK * N * 2      # 2 channels a block
    try:
        y = ref.selective_scan(dt, b, cm, x, a)
    finally:
        ref.SCAN_ELEMS = old
    h = torch.zeros(B, D, N, dtype=torch.float64)
    want = []
    for t in range(L):
        h = torch.exp(dt[:, t, :, None].double() * a.double()) * h \
            + (dt[:, t] * x[:, t]).double()[..., None] * b[:, t, None].double()
        want.append((h * cm[:, t, None].double()).sum(-1))
    np.testing.assert_allclose(y.numpy(), torch.stack(want, 1).numpy(),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- defaults
def test_options_default_to_the_reference_model():
    assert ARCH_IDS == (
        "minicpm3-4b", "smollm-135m", "qwen1.5-110b", "qwen2-72b",
        "llama-3.2-vision-90b", "llama4-maverick-400b-a17b", "mixtral-8x7b",
        "jamba-v0.1-52b", "whisper-medium", "xlstm-1.3b", "llama3.1-8b",
        "smolvlm")
    assert "ai21-jamba2-mini" not in ARCH_IDS
    assert get_config("ai21-jamba2-mini") is ai21_jamba2_mini.CONFIG
    for cfg in (get_config("jamba-v0.1-52b"), get_reduced("jamba-v0.1-52b")):
        assert cfg.rope and cfg.attn_offset == 0
        assert cfg.mamba.dt_rank == 1 and not cfg.mamba.inner_norms
        assert cfg.moe.renormalize
        assert cfg.layer_kinds()[0] == "attn"
    cfg = get_reduced("jamba-v0.1-52b")
    tree = dict(_flat(lm.init_params(cfg, seed=0, device=CPU)))
    di, N = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    assert tree[("blocks", "p1", "x_proj", "w")][0] == (1, di, 2 * N + 1)
    assert tree[("blocks", "p1", "dt_w", "w")][0] == (1, 1, di)
    assert not any("norm" in k[2] and k[2] not in ("norm1", "norm2")
                   for k in tree if k[0] == "blocks")
    pub = ai21_jamba2_mini.CONFIG
    assert pub.param_counts()["total"] == pytest.approx(51.57e9, rel=1e-3)


def _parent_route(p, ht, top_k):
    """The MoE router as it was: softmax, top-k, gates renormalised."""
    probs = blocks._router_probs(p, ht)
    idx = torch.topk(probs, top_k, dim=-1).indices
    gv = probs.gather(-1, idx)
    return gv / torch.clamp_min(gv.sum(-1, keepdim=True), 1e-9), idx


# S = 1: the decode gather; 2 x 40: dense-masked; 2 x 320: grouped
@pytest.mark.parametrize("B,S", [(3, 1), (2, 40), (2, 320)])
@torch.no_grad()
def test_mixtral_gates_and_moe_are_bitwise_the_parents(B, S, monkeypatch):
    cfg = get_reduced("mixtral-8x7b")
    params, _, _ = serve.inputs(cfg, 1, 8, 0, CPU)
    p = lm._period(params["blocks"]["p0"], 0)
    h = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(S)).to(torch.bfloat16)
    ht = h.reshape(B * S, -1)
    gv, idx = blocks._route_gates(p, ht, cfg.moe)
    want_gv, want_idx = _parent_route(p, ht, cfg.moe.top_k)
    assert torch.equal(idx, want_idx) and torch.equal(gv, want_gv)
    out = blocks._moe(p, cfg, h)
    # the parent's gates handed to _moe as they are
    monkeypatch.setattr(blocks, "_route", _parent_route)
    plain = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, renormalize=False))
    assert torch.equal(out, blocks._moe(p, plain, h))


@torch.no_grad()
def test_harness_rebinding_traces_a_jamba_request():
    """``benchlib.tracing.Spans`` rebinds ``_moe``, ``_route`` and
    ``_attn_apply`` and calls them positionally: a published-Jamba
    request under it serves the same tokens, opens its ranges and keeps
    the decode steps' expert picks, one a MoE layer a step."""
    c, cfg, w = weights("bfloat16")
    tokens = prompts(cfg, 2, 24)
    gen = 5
    plain = serve.generate(w, cfg, tokens, gen)
    spans = tracing.Spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof, spans:
        traced = serve.generate(w, cfg, tokens, gen)
    np.testing.assert_array_equal(plain.tokens, traced.tokens)
    n_moe = sum(m for _, m in lm._layout(cfg)[2]) * (
        cfg.n_layers // lm.period_of(cfg))
    assert len(spans.routes) == n_moe * (gen - 1)
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert {"pb.moe.prefill", "pb.moe.decode", "pb.attn.prefill",
            "pb.prefill", "pb.decode_step"} <= names
    assert blocks._moe.__name__ == "_moe" and blocks._route.__name__ == \
        "_route"                                       # restored


# --------------------------------------------------------- serving spans
def test_mamba_spans_and_token_counter(tmp_path):
    c, cfg, w = weights("bfloat16")
    B, S, gen = 2, 24, 6
    tokens = prompts(cfg, B, S)
    reg = obs_metrics.global_registry()
    reg.clear()
    path = str(tmp_path / "trace.jsonl")
    tracer = obs_trace.Tracer(path, proc="test")
    prev = obs_trace.install_tracer(tracer)
    try:
        serve.generate(w, cfg, tokens, gen)
    finally:
        obs_trace.install_tracer(prev)
        tracer.close()
    n_mamba = cfg.layer_kinds().count("mamba")
    assert n_mamba == 14
    recs = [r for r in obs_trace.read_trace(path) if r["ph"] == "X"]
    parents = {}
    for r in recs:
        parents.setdefault(r["name"], set()).add(r["args"]["parent"])
    assert parents["mamba.scan"] == {"mamba"}
    assert parents["mamba"] == {"serve.prefill", "serve.decode_step"}
    snap = reg.snapshot()
    value = lambda *a: obs_metrics.snapshot_value(snap, "counters", *a)  # noqa
    assert value("lm_span_calls_total", {"span": "mamba"}) == n_mamba * gen
    assert value("lm_span_calls_total", {"span": "mamba.scan"}) \
        == n_mamba * gen
    assert value("lm_mamba_tokens_total", {"phase": "prefill"}) \
        == n_mamba * B * S
    assert value("lm_mamba_tokens_total", {"phase": "decode"}) \
        == n_mamba * B * (gen - 1)
    reg.clear()


def test_mamba_counts_nothing_outside_a_served_request():
    c, cfg, w = weights("bfloat16")
    reg = obs_metrics.global_registry()
    reg.clear()
    with torch.no_grad():
        lm.prefill(w, cfg, prompts(cfg, 1, 16))
    assert reg.snapshot()["counters"] == []
