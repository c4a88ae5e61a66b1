"""Serving (port of ``repro.launch.serve``): LM decoding and the design
recommendation server.

LM serving: a batched prefill, then greedy decoding over a batch of
synthetic prompts, reporting the prefill time and decode tokens/s.

    python -m repro_torch.launch.serve --arch llama3.1-8b --reduced \
        --batch 4 --prompt-len 32 --gen 32 --device cuda|cpu [--trace DIR]

``--trace DIR`` writes the request's serving spans (``generate`` down to
the Mamba mixer's scan and the MoE block's route, gather, dispatch and
combine) to
``DIR/trace.jsonl``; ``python -m repro_torch.obs.export --root DIR``
renders them for chrome://tracing or Perfetto.

Every config of the zoo serves: the attention-only ones (``llama3.1-8b``,
``smolvlm``, ``smollm-135m``, ``qwen1.5-110b``, ``qwen2-72b``,
``mixtral-8x7b``, ``llama4-maverick-400b-a17b``), ``minicpm3-4b`` (MLA),
``llama-3.2-vision-90b`` (cross-attention onto stub image embeddings),
``whisper-medium`` (its encoder over stub frame embeddings),
``jamba-v0.1-52b`` with its Mamba layers and ``xlstm-1.3b``; beside the
zoo, ``ai21-jamba2-mini`` (the published Jamba block).

Recommendation server (:func:`recommend_server`): design queries over
finished campaign run directories, answered by
``repro_torch.launch.recommend.Recommender`` on ``--device``.

    python -m repro_torch.launch.serve --recommend ROOT [--recommend ROOT2] \
        [--host 127.0.0.1] [--port 8177] --device cuda|cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.blocks import KV_TAIL
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import serving_span as span


@dataclasses.dataclass
class Generation:
    tokens: np.ndarray          # [B, gen_tokens] int32, greedy
    prefill_logits: torch.Tensor   # [B, 1, V]: the prompt's last position
    t_prefill: float            # seconds, from inputs on the device ...
    t_decode: float             # ... to the result on the device

    @property
    def tok_s(self) -> float:
        B, n = self.tokens.shape
        return B * (n - 1) / max(self.t_decode, 1e-9)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def generate(params, cfg: ArchConfig, prompts: torch.Tensor,
             gen_tokens: int, ctx: Optional[torch.Tensor] = None
             ) -> Generation:
    """Prefill ``prompts`` [B, S], then ``gen_tokens - 1`` greedy decode
    steps over a cache of S + gen_tokens positions, merging the ring tails
    every ``KV_TAIL`` steps (a window shorter than the tail is refused
    before the prefill when a merge would come).  The clocks are read only
    after the device finished the work they time.  Under a tracer or a
    recording profiler the request records its serving spans
    (``repro_torch.obs.trace``): ``serve.request`` around the prefill, the
    cache extension, each decode step (with its tail merge) and the copy
    of the tokens to the host."""
    if gen_tokens - 1 >= KV_TAIL:
        lm.check_flushable(cfg)
    dev = prompts.device
    B, prompt_len = prompts.shape
    _sync(dev)
    with obs_trace.serving_request(dev), span("serve.request"):
        t0 = time.perf_counter()
        with span("serve.prefill"):
            logits, caches = lm.prefill(params, cfg, prompts, ctx)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        with span("serve.extend_caches"):
            caches = lm.extend_caches(caches, cfg, prompt_len + gen_tokens)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out = [tok]
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(gen_tokens - 1):
            with span("serve.decode_step"):
                step_logits, caches = lm.decode_step(params, cfg, tok,
                                                     caches, prompt_len + i)
                if (i + 1) % KV_TAIL == 0:     # amortised prefix merge
                    with span("serve.flush_tails"):
                        caches = lm.flush_tails(caches, cfg)
                tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None]
            out.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
        with span("serve.to_host"):
            tokens = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
    return Generation(tokens, logits, t_prefill, t_decode)


def inputs(cfg: ArchConfig, batch: int, prompt_len: int, seed: int,
           device) -> tuple:
    """Parameters, prompts and context embeddings (a VLM's images, or an
    encoder-decoder's ``n_audio_frames`` frames) from three separate
    streams of ``seed``, so that no draw repeats another."""
    dev = device_mod.resolve(device)
    params = lm.init_params(cfg, seed=3 * seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3 * seed + 1)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                            device=dev)
    ctx = None
    if cfg.n_context_tokens or cfg.is_encdec:
        n = cfg.n_audio_frames if cfg.is_encdec else cfg.n_context_tokens
        gen = torch.Generator(device=dev).manual_seed(3 * seed + 2)
        ctx = (torch.randn((batch, n, cfg.d_model), generator=gen,
                           device=dev)
               * 0.1).to(L.dtype_of(cfg.param_dtype))
    return params, prompts, ctx


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen_tokens: int = 32, seed: int = 0,
          device="cuda"):
    """Greedy generation with random weights; returns (tokens, tok/s)."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    params, prompts, ctx = inputs(cfg, batch, prompt_len, seed, device)
    g = generate(params, cfg, prompts, gen_tokens, ctx)
    print(f"[serve] {arch}: prefill {prompt_len} tok x{batch} in "
          f"{g.t_prefill * 1e3:.0f} ms; decode {gen_tokens - 1} steps at "
          f"{g.tok_s:.1f} tok/s (batch={batch}, {device})")
    return g.tokens, g.tok_s


def recommend_server(roots, *, host: str = "127.0.0.1", port: int = 8177,
                     recommender=None, poll: bool = False, on_ready=None,
                     device="cuda"):
    """Always-on Pareto-as-a-service endpoint over campaign archives.

    GET ``/healthz`` reports index size + uptime; GET ``/metrics`` serves
    the process metrics registry in Prometheus text format (request counts
    per route, exact-vs-surrogate answer counters, fused dispatch count,
    per-request latency histogram, bad-request count); POST ``/recommend``
    takes ``{"queries": [{...}, ...]}`` (see
    ``repro_torch.launch.recommend.Query``) and answers the whole batch
    with all surrogate fallbacks in one ``score_query_batch`` call,
    returning ``{"answers": [...], "dispatches": k}``.  A malformed body
    (invalid JSON, a non-object, a non-list ``queries``) is a structured
    400.  ``ThreadingHTTPServer`` answers from several threads, so each
    query batch runs under one lock.  The recommender is built from
    ``roots`` on ``device`` unless one is passed.  ``poll=True`` serves a
    single request then returns; ``on_ready(srv)`` fires once the socket
    is bound (``port=0`` picks a free port, ``srv.server_port``)."""
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from repro_torch.launch.recommend import Query, Recommender
    from repro_torch.obs import metrics as obs_metrics

    rec = recommender or Recommender.build(list(roots), device=device)
    lock = threading.Lock()
    t_started = time.time()
    reg = obs_metrics.global_registry()
    m_requests = {p: reg.counter("serve_requests_total",
                                 labels={"route": p})
                  for p in ("/healthz", "/metrics", "/recommend", "other")}
    m_bad = reg.counter("serve_bad_requests_total")
    m_exact = reg.counter("serve_answers_total",
                          labels={"source": "archive"})
    m_surrogate = reg.counter("serve_answers_total",
                              labels={"source": "surrogate"})
    m_dispatch = reg.counter("serve_fused_dispatches_total")
    m_latency = reg.histogram("serve_request_seconds")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet: stderr stays for errors
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, code: int, text: str) -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _count(self) -> None:
            m_requests.get(self.path, m_requests["other"]).inc()

        def do_GET(self):
            t0 = time.time()
            self._count()
            try:
                if self.path == "/healthz":
                    self._reply(200, {
                        "status": "ok",
                        "uptime_s": round(time.time() - t_started, 3),
                        "cells": len(rec.index.cells),
                        "candidates": len(rec.index.candidates),
                        "dispatches": rec.n_dispatches,
                        "index": {
                            "seq_len": rec.index.seq_len,
                            "batch": rec.index.batch,
                            "answered_exact": rec.n_exact,
                            "answered_surrogate": rec.n_surrogate,
                        },
                    })
                elif self.path == "/metrics":
                    self._reply_text(
                        200, obs_metrics.render_prometheus(reg.snapshot()))
                else:
                    self._reply(404, {"error": f"no route {self.path}"})
            finally:
                m_latency.observe(time.time() - t0)

        def do_POST(self):
            t0 = time.time()
            self._count()
            try:
                if self.path != "/recommend":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(req, dict):
                        raise ValueError(
                            "request body must be a JSON object, got "
                            f"{type(req).__name__}")
                    qd = req.get("queries", [])
                    if not isinstance(qd, list):
                        raise ValueError(
                            "'queries' must be a list of objects, got "
                            f"{type(qd).__name__}")
                    queries = []
                    for i, d in enumerate(qd):
                        if not isinstance(d, dict):
                            raise ValueError(
                                f"queries[{i}] must be a JSON object, "
                                f"got {type(d).__name__}")
                        queries.append(Query.from_dict(d))
                    if not queries:
                        raise ValueError("request carries no queries")
                    with lock:
                        before = rec.n_dispatches
                        answers = rec.recommend_batch(queries)
                        used = rec.n_dispatches - before
                    n_ex = sum(1 for a in answers if a.source == "archive")
                    m_exact.inc(n_ex)
                    m_surrogate.inc(len(answers) - n_ex)
                    m_dispatch.inc(used)
                    self._reply(200, {
                        "answers": [a.to_dict() for a in answers],
                        "dispatches": used,
                    })
                except (ValueError, TypeError, KeyError) as e:
                    # malformed input is the client's 400 (a JSON decode
                    # error is a ValueError), with a payload that says what
                    # was wrong
                    m_bad.inc()
                    self._reply(400, {"error": {
                        "type": type(e).__name__, "message": str(e)}})
            finally:
                m_latency.observe(time.time() - t0)

    srv = ThreadingHTTPServer((host, port), Handler)
    print(f"[serve] recommendation server on http://{host}:{srv.server_port}"
          f" ({len(rec.index.cells)} cells, "
          f"{len(rec.index.candidates)} candidates)", flush=True)
    if on_ready is not None:
        on_ready(srv)
    try:
        if poll:
            srv.handle_request()
        else:
            srv.serve_forever()
    finally:
        srv.server_close()
    return srv


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--recommend", action="append", default=[],
                    metavar="ROOT",
                    help="campaign run dir; start the recommendation "
                         "server instead of the decode loop (repeatable)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8177)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write the decode loop's serving spans to "
                         "DIR/trace.jsonl (render: python -m "
                         "repro_torch.obs.export --root DIR)")
    a = ap.parse_args(argv)
    if a.recommend:
        from repro_torch.launch.recommend import Recommender
        try:
            rec = Recommender.build(a.recommend, device=a.device)
        except (OSError, ValueError) as e:
            ap.error(f"--recommend: {e}")
        recommend_server(a.recommend, host=a.host, port=a.port,
                         recommender=rec)
        return
    if not a.arch:
        ap.error("--arch is required (or pass --recommend ROOT)")
    tracer = (obs_trace.Tracer(os.path.join(a.trace, obs_trace.TRACE_NAME),
                               proc="serve") if a.trace else None)
    prev = obs_trace.install_tracer(tracer)
    try:
        serve(a.arch, reduced=a.reduced, batch=a.batch,
              prompt_len=a.prompt_len, gen_tokens=a.gen, device=a.device)
    finally:
        obs_trace.install_tracer(prev)
        if tracer is not None:
            tracer.close()


if __name__ == "__main__":
    main()
