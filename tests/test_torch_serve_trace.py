"""The serving spans and MoE counters of ``repro_torch.launch.serve.generate``
(``repro_torch.obs.trace``) on the CPU, with a reduced Mixtral whose
prefill takes the grouped capacity dispatch (2 x 320 tokens) and which
then decodes: the switch (a tracer or a recording profiler, vetoed by
``REPRO_TRACE=0``), what the switched-off path launches, bitwise-equal
results, the span tree on the profiler's epoch clock, the dropped count
against a recount from the routing, and the module functions that
callers rebind."""
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_reduced
from repro_torch.launch import serve
from repro_torch.models import blocks, lm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, GEN = 2, 320, 6
SPANS = {"serve.request", "serve.prefill", "serve.extend_caches",
         "serve.decode_step", "serve.to_host", "lm.head", "attn", "moe",
         "moe.route", "moe.gather", "moe.experts", "moe.dispatch",
         "moe.combine"}


@pytest.fixture(scope="module")
def model():
    cfg = get_reduced("mixtral-8x7b")
    params, prompts, _ = serve.inputs(cfg, B, S, 0, "cpu")
    assert B * S > 512 and cfg.moe is not None
    return cfg, params, prompts


@pytest.fixture
def registry():
    reg = obs_metrics.global_registry()
    reg.clear()
    return reg


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


class _Ops(TorchDispatchMode):
    """The aten operations run, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@torch.no_grad()
def _plain_generate(params, cfg, prompts, gen_tokens):
    """The program calls of ``generate`` with nothing around them."""
    logits, caches = lm.prefill(params, cfg, prompts)
    caches = lm.extend_caches(caches, cfg, prompts.shape[1] + gen_tokens)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [tok]
    for i in range(gen_tokens - 1):
        step_logits, caches = lm.decode_step(params, cfg, tok, caches,
                                             prompts.shape[1] + i)
        tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


def _switch(mode, monkeypatch, tmp_path):
    """A context under which ``mode`` holds, and the tracer's file."""
    path = str(tmp_path / "trace.jsonl")
    if mode == "veto":
        monkeypatch.setenv(obs_trace.TRACE_ENV, "0")
        return _profiler(), path
    if mode == "profiler":
        return _profiler(), path
    if mode == "tracer":
        tracer = obs_trace.Tracer(path, proc="test")
        prev = obs_trace.install_tracer(tracer)

        @contextlib.contextmanager
        def installed():
            try:
                yield
            finally:
                obs_trace.install_tracer(prev)
                tracer.close()
        return installed(), path
    return contextlib.nullcontext(), path


@pytest.mark.parametrize("mode", ["off", "veto"])
def test_switched_off_records_and_launches_nothing(model, registry, mode,
                                                   monkeypatch, tmp_path):
    cfg, params, prompts = model
    seen = []
    route = blocks._route

    def watched(p, ht, top_k):
        seen.append(obs_trace._serving)
        return route(p, ht, top_k)
    next_id = next(obs_trace._REQUEST_IDS)
    before = registry.snapshot()
    ctx, path = _switch(mode, monkeypatch, tmp_path)
    _plain_generate(params, cfg, prompts, GEN)      # first-call caches
    with ctx:
        with _Ops() as ops:
            g = serve.generate(params, cfg, prompts, GEN)
        with _Ops() as plain:
            tokens = _plain_generate(params, cfg, prompts, GEN)
        monkeypatch.setattr(blocks, "_route", watched)
        serve.generate(params, cfg, prompts, GEN)
    np.testing.assert_array_equal(g.tokens, tokens)
    assert ops.ops == plain.ops           # nothing launched beside the model
    assert seen and all(r is None for r in seen)
    assert next(obs_trace._REQUEST_IDS) == next_id + 1   # no request opened
    assert registry.snapshot() == before
    assert not os.path.exists(path)


@pytest.mark.parametrize("mode", ["profiler", "tracer"])
def test_traced_generate_is_bitwise_the_untraced_one(model, registry, mode,
                                                     monkeypatch, tmp_path):
    cfg, params, prompts = model
    plain = serve.generate(params, cfg, prompts, GEN)
    assert registry.snapshot()["counters"] == []
    ctx, _ = _switch(mode, monkeypatch, tmp_path)
    with ctx:
        traced = serve.generate(params, cfg, prompts, GEN)
    np.testing.assert_array_equal(plain.tokens, traced.tokens)
    assert torch.equal(plain.prefill_logits, traced.prefill_logits)
    calls = {r["labels"]["span"]: r["value"]
             for r in registry.snapshot()["counters"]
             if r["name"] == "lm_span_calls_total"}
    assert set(calls) == SPANS
    assert calls["serve.decode_step"] == GEN - 1
    assert calls["moe"] == cfg.n_layers * GEN
    snap = registry.snapshot()
    assert obs_metrics.snapshot_value(snap, "counters",
                                      "lm_requests_total") == 1
    assert obs_metrics.snapshot_value(snap, "counters",
                                      "lm_decode_steps_total") == GEN - 1


def test_profiled_request_opens_no_profiler_range(model, registry):
    cfg, params, prompts = model
    with _profiler() as prof:
        serve.generate(params, cfg, prompts, GEN)
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert not names & SPANS
    assert obs_metrics.snapshot_value(registry.snapshot(), "counters",
                                      "lm_requests_total") == 1


def test_span_tree_on_the_epoch_clock(model, registry, tmp_path):
    cfg, params, prompts = model
    path = str(tmp_path / "trace.jsonl")
    tracer = obs_trace.Tracer(path, proc="test")
    prev = obs_trace.install_tracer(tracer)
    try:
        with _profiler() as prof:
            with record_function("test.warm"):   # a process's first range
                pass                             # starts late by ~1 ms
            with record_function("test.before_request"):
                serve.generate(params, cfg, prompts, GEN)
        serve.generate(params, cfg, prompts, GEN)
    finally:
        obs_trace.install_tracer(prev)
        tracer.close()
    recs = [r for r in obs_trace.read_trace(path) if r["ph"] == "X"]
    by_request = {}
    for r in recs:
        by_request.setdefault(r["args"]["request"], []).append(r)
    assert len(by_request) == 2
    first = by_request[min(by_request)]
    roots = [r for r in first if r["name"] == "serve.request"]
    assert len(roots) == 1 and roots[0]["args"]["parent"] is None
    eps = 1e-4
    for r in first:
        if r is roots[0]:
            continue
        parents = [p for p in first if p["name"] == r["args"]["parent"]
                   and p["ts"] - eps <= r["ts"]
                   and r["ts"] + r["dur"] <= p["ts"] + p["dur"] + eps]
        assert parents, r
        assert r["args"]["device_s"] == r["dur"]    # the CPU's device time
    mark = [ev for ev in prof.profiler.kineto_results.events()
            if ev.name() == "test.before_request"]
    assert len(mark) == 1
    assert abs(roots[0]["ts"] - mark[0].start_ns() * 1e-9) < 1e-3


def test_dropped_count_equals_a_recount_from_the_routing(model, registry,
                                                         monkeypatch):
    cfg, params, prompts = model
    m = cfg.moe
    picks = []
    route = blocks._route

    def recorded(p, ht, top_k):
        gates, idx = route(p, ht, top_k)
        picks.append(idx.clone())
        return gates, idx
    moe_calls = []
    moe = blocks._moe

    def counted(p, c, h):
        moe_calls.append(tuple(h.shape))
        return moe(p, c, h)
    monkeypatch.setattr(blocks, "_route", recorded)
    monkeypatch.setattr(blocks, "_moe", counted)
    with _profiler():
        serve.generate(params, cfg, prompts, GEN)
    # the rebound functions saw every call: one route a block, as the spans
    assert len(moe_calls) == len(picks) == cfg.n_layers * GEN
    snap = registry.snapshot()
    assert obs_metrics.snapshot_value(
        snap, "counters", "lm_span_calls_total", {"span": "moe"}) \
        == len(moe_calls)
    dropped = 0
    for idx in picks[:cfg.n_layers]:          # the prefill's blocks
        tg = idx.shape[0]
        cap = max(1, int(blocks.MOE_CAPACITY * m.top_k * tg / m.n_experts))
        load = np.bincount(idx.numpy().ravel(), minlength=m.n_experts)
        dropped += int(np.maximum(load - cap, 0).sum())
    assert dropped > 0
    value = lambda name, phase: obs_metrics.snapshot_value(  # noqa: E731
        snap, "counters", name, {"phase": phase})
    assert value("lm_moe_dropped_total", "prefill") == dropped
    assert value("lm_moe_assignments_total", "prefill") \
        == cfg.n_layers * B * S * m.top_k
    assert value("lm_moe_dropped_total", "decode") == 0
    assert value("lm_moe_assignments_total", "decode") \
        == cfg.n_layers * B * (GEN - 1) * m.top_k


def test_moe_counters_match_the_onehot_formulation(model, registry,
                                                   monkeypatch):
    """The grouped prefill by row index and by the one-hot einsums that
    DTensors keep: the same assignments and drops counted, and the same
    ``moe.dispatch`` calls, one a block (a group of 640 tokens)."""
    cfg, params, prompts = model

    def counted():
        registry.clear()
        with _profiler():
            serve.generate(params, cfg, prompts, GEN)
        snap = registry.snapshot()
        value = lambda name, labels: obs_metrics.snapshot_value(  # noqa
            snap, "counters", name, labels)
        return (value("lm_moe_assignments_total", {"phase": "prefill"}),
                value("lm_moe_dropped_total", {"phase": "prefill"}),
                value("lm_span_calls_total", {"span": "moe.dispatch"}))
    index = counted()
    monkeypatch.setattr(blocks, "_index_dispatch", blocks._onehot_dispatch)
    monkeypatch.setattr(blocks, "_index_combine", blocks._onehot_combine)
    assert counted() == index
    assert index[0] == cfg.n_layers * B * S * cfg.moe.top_k
    assert index[1] > 0 and index[2] == cfg.n_layers


def test_a_failed_request_adds_nothing(model, registry, monkeypatch):
    cfg, params, prompts = model
    step = lm.decode_step
    n = []

    def failing(*args, **kwargs):
        n.append(1)
        if len(n) == 3:
            raise RuntimeError("out of memory")
        return step(*args, **kwargs)
    monkeypatch.setattr(lm, "decode_step", failing)
    with _profiler():
        with pytest.raises(RuntimeError, match="out of memory"):
            serve.generate(params, cfg, prompts, GEN)
    assert obs_trace._serving is None
    assert registry.snapshot()["counters"] == []


def test_emit_many_writes_one_batch_and_tolerates_a_torn_tail(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = obs_trace.Tracer(path, proc="t")
    tr.emit_many([dict(ph="X", name=f"s{i}", ts=float(i), dur=0.5)
                  for i in range(3)])
    tr.close()
    with open(path, "a") as f:
        f.write('{"ph": "X", "na')
    assert [r.get("name") for r in obs_trace.read_trace(path)] == [
        "process_name", "s0", "s1", "s2"]
    obs_trace.Tracer(path, proc="t2").close()    # heals the torn tail
    assert obs_trace.read_trace(path)[-1]["args"]["name"] == "t2"


def test_serve_cli_trace_flag_writes_spans_that_export(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop(obs_trace.TRACE_ENV, None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mixtral-8x7b", "--reduced", "--batch", "2", "--prompt-len", "6",
         "--gen", "4", "--device", "cpu", "--trace", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    recs = obs_trace.read_trace(str(tmp_path / obs_trace.TRACE_NAME))
    names = {r["name"] for r in recs if r["ph"] == "X"}
    assert {"serve.request", "serve.decode_step", "moe.gather",
            "moe.dense"} <= names
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.export", "--root",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    doc = json.loads((tmp_path / "report" / "trace.json").read_text())
    assert sum(ev["name"] == "serve.decode_step"
               for ev in doc["traceEvents"]) == 3
