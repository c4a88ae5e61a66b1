"""Structured tracing: crash-safe JSONL span logs per process (port of
``repro.obs.trace``; same records, same file name).

A :class:`Tracer` appends one JSON record per finished span (or instant /
counter event) to a ``trace.jsonl``, newline-guarded against torn tails
exactly like the campaign store's cell JSONL (``repro_torch.core.fsutil``):
a SIGKILL mid-write leaves one skippable partial line, never a corrupt
file.  Records carry wall-clock epoch seconds so traces from different
processes (fleet parent + workers) merge onto one timeline —
``python -m repro_torch.obs.export`` renders a whole campaign as a
Chrome/Perfetto ``trace_event`` JSON.

Usage::

    tracer = Tracer(os.path.join(run_dir, "trace.jsonl"), proc="worker-0")
    install_tracer(tracer)                # process-global
    ...
    with span("execute_batch", cat="campaign", batch=bid) as sp:
        ...
        sp.set(cells=3)                   # attach result args
    instant("evict", cat="fleet", worker=2)
    counter("env_steps_s", value=1.5e5)

With no tracer installed (or ``REPRO_TRACE=0``) every hook is a shared
no-op object — the disabled path costs one global read.  Tracing never
touches RNG streams or checkpoint contents: a traced search is bitwise
identical to an untraced one (test-enforced).

Serving spans.  ``repro_torch.launch.serve.generate`` opens one
:class:`RequestTrace` a request (:func:`serving_request`) when a tracer is
installed or a ``torch.profiler`` is recording, and ``REPRO_TRACE=0`` is
not set; the decision holds for that request only.  The serving loop, the
LM and its blocks then open :func:`serving_span` at each layer boundary:

    serve.request > serve.prefill | serve.extend_caches |
        serve.decode_step (> serve.flush_tails) | serve.to_host
    > attn | lm.head | mamba > mamba.scan | moe > moe.route, then
      moe.gather + moe.experts (one token a row), moe.dense (up to 512
      tokens) or moe.dispatch + moe.experts + moe.combine (the grouped
      capacity dispatch)

the MoE block counts its token-expert assignments and those dropped
past capacity (:func:`moe_assignments`), and the Mamba mixer the tokens
it takes (:func:`mamba_tokens`).  A span keeps its name, its
parent's name, its start on the Unix epoch clock (the clock the
profiler's events carry, so the spans can be laid on a device timeline),
its host seconds and, on a CUDA device, a pair of timing events on the
request's stream: no span waits for the device, and none opens a
profiler range.  The events and the dropped count are read once, after
the request's tokens reached the host.  A request that completes adds
its totals to the global registry (``lm_span_host_seconds_total``,
``lm_span_device_seconds_total``, ``lm_span_calls_total`` by ``span``;
``lm_requests_total``, ``lm_decode_steps_total``;
``lm_moe_assignments_total``, ``lm_moe_dropped_total``,
``lm_mamba_tokens_total`` by ``phase``) and,
under a tracer, its spans to ``trace.jsonl`` in one write
(:meth:`Tracer.emit_many`).  With the switch off, each span site returns
the shared no-op span and launches, synchronises and allocates nothing.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

from repro_torch.core import fsutil
from repro_torch.obs import metrics

TRACE_NAME = "trace.jsonl"
TRACE_ENV = "REPRO_TRACE"

# trace_event phases we emit: complete span / instant / counter
PH_SPAN, PH_INSTANT, PH_COUNTER = "X", "i", "C"


def tracing_disabled() -> bool:
    """True when the environment vetoes tracing (``REPRO_TRACE=0``)."""
    return os.environ.get(TRACE_ENV, "").strip().lower() in (
        "0", "off", "false", "no")


class Span:
    """One in-flight span; emitted as a single JSONL record on exit.

    ``set(**args)`` attaches result arguments any time before exit; an
    exception propagating through the span is recorded under
    ``args["error"]`` (and re-raised untouched)."""

    __slots__ = ("_tracer", "name", "cat", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0

    def set(self, **args) -> "Span":
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        self.t0 = time.time()
        return self

    def __exit__(self, et, ev, tb) -> None:
        if et is not None:
            self.args.setdefault("error", repr(ev))
        t1 = time.time()
        self._tracer.emit(dict(
            ph=PH_SPAN, name=self.name, cat=self.cat, ts=self.t0,
            dur=t1 - self.t0, tid=self._tracer._tid(),
            **({"args": self.args} if self.args else {})))


class _NullSpan:
    """Shared no-op span: the whole disabled tracing path."""

    __slots__ = ()

    def set(self, **args) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, et, ev, tb) -> None:
        return None


NULL_SPAN = _NullSpan()


class Tracer:
    """Appends span/instant/counter records to one JSONL trace file.

    Writes are ``write + flush`` per record under a lock: cheap relative
    to a jit dispatch, and a SIGKILLed writer loses nothing the OS had
    accepted (only power loss can tear the tail — readers skip torn
    lines).  ``proc`` labels this process on the exported timeline."""

    def __init__(self, path: str, *, proc: str = "main"):
        self.path = path
        self.proc = proc
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        lead = "\n" if fsutil.torn_tail(path) else ""
        self._f = open(path, "a")
        if lead:                       # heal a previous writer's torn tail
            self._f.write(lead)
        self.emit(dict(ph="M", name="process_name", ts=time.time(),
                       args=dict(name=proc, pid=os.getpid())))

    def _tid(self) -> int:
        """Stable small thread id (0 = first thread seen, usually main)."""
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    # ------------------------------------------------------------------ api
    def span(self, name: str, cat: str = "app", **args) -> Span:
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "app", **args) -> None:
        self.emit(dict(ph=PH_INSTANT, name=name, cat=cat, ts=time.time(),
                       tid=self._tid(),
                       **({"args": args} if args else {})))

    def counter(self, name: str, **series) -> None:
        """Counter-track sample (e.g. env_steps_s over time)."""
        self.emit(dict(ph=PH_COUNTER, name=name, ts=time.time(),
                       args={k: float(v) for k, v in series.items()}))

    def complete(self, name: str, ts: float, dur: float,
                 cat: str = "app", **args) -> None:
        """Emit an already-timed span (the caller measured ts/dur) —
        for hot loops that time themselves anyway and shouldn't pay a
        context manager per iteration."""
        self.emit(dict(ph=PH_SPAN, name=name, cat=cat, ts=ts,
                       dur=max(0.0, dur), tid=self._tid(),
                       **({"args": args} if args else {})))

    def emit(self, record: Dict) -> None:
        self.emit_many([record])

    def emit_many(self, records: List[Dict]) -> None:
        """Append ``records`` in one write and one flush; a writer killed
        mid-write leaves at most one torn line, the last, which readers
        skip."""
        text = "".join(json.dumps(r, allow_nan=False, separators=(",", ":"))
                       + "\n" for r in records)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(text)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                try:
                    os.fsync(self._f.fileno())
                except OSError:
                    pass
                self._f.close()

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *a) -> None:
        self.close()


def read_trace(path: str) -> List[Dict]:
    """Decode a trace.jsonl, skipping torn/partial lines (the same
    tolerance the campaign store applies to cell JSONL)."""
    out: List[Dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


# -------------------------------------------------------- process-global
_current: Optional[Tracer] = None


def install_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install the process-global tracer (None uninstalls); returns the
    previous one so callers can restore it.  Honors ``REPRO_TRACE=0``."""
    global _current
    prev = _current
    _current = None if (tracer is not None and tracing_disabled()) \
        else tracer
    return prev


def current_tracer() -> Optional[Tracer]:
    return _current


def span(name: str, cat: str = "app", **args):
    """Span against the installed tracer (shared no-op when none)."""
    t = _current
    if t is None:
        return NULL_SPAN
    return t.span(name, cat, **args)


def instant(name: str, cat: str = "app", **args) -> None:
    t = _current
    if t is not None:
        t.instant(name, cat, **args)


def counter(name: str, **series) -> None:
    t = _current
    if t is not None:
        t.counter(name, **series)


def complete(name: str, ts: float, dur: float, cat: str = "app",
             **args) -> None:
    t = _current
    if t is not None:
        t.complete(name, ts, dur, cat, **args)


# ------------------------------------------------------------ serving spans
_REQUEST_IDS = itertools.count(1)
_EVENT_POOLS: Dict[int, List] = {}    # CUDA device index -> free events
_serving: Optional["RequestTrace"] = None
# the serving phases an MoE block's assignments and a Mamba mixer's tokens
# count under, and the span of generate that opens each
MOE_PHASES = ("prefill", "decode")
_PHASE_OF = {"serve.prefill": 0, "serve.decode_step": 1}


def serving_on() -> bool:
    """Whether a request served now records its spans: a tracer is
    installed or a ``torch.profiler`` is recording, and ``REPRO_TRACE=0``
    does not veto it."""
    if tracing_disabled():
        return False
    if _current is not None:
        return True
    import torch
    return torch._C._autograd._profiler_enabled()


class _ServingSpan:
    """One open serving span (see :class:`RequestTrace`)."""

    __slots__ = ("_rec", "name", "_ts", "_t0", "_ev")

    def __init__(self, rec: "RequestTrace", name: str):
        self._rec = rec
        self.name = name

    def __enter__(self) -> "_ServingSpan":
        rec = self._rec
        self._ts = time.time()
        self._t0 = time.perf_counter()
        self._ev = rec._mark()
        rec._open.append(self.name)
        return self

    def __exit__(self, et, ev, tb) -> None:
        rec = self._rec
        end = rec._mark()
        host_s = time.perf_counter() - self._t0
        rec._open.pop()
        rec.spans.append((self.name, rec._open[-1] if rec._open else None,
                          self._ts, host_s, self._ev, end))


class RequestTrace:
    """The spans, MoE counts and Mamba tokens of one served request.

    ``spans`` holds one tuple per finished span: (name, parent's name, start
    in Unix epoch seconds, host seconds, start event, end event); the
    events are CUDA timing events on the request's stream, drawn from a
    pool reused across requests, or None on the CPU, where a span's device
    time is its host time.  :meth:`finish` reads them once, when the
    request's last event has been reached."""

    def __init__(self, device):
        import torch
        self._torch = torch
        self.id = next(_REQUEST_IDS)
        self._stream = (torch.cuda.current_stream(device)
                        if device.type == "cuda" else None)
        self._pool = (_EVENT_POOLS.setdefault(self._stream.device_index, [])
                      if self._stream is not None else None)
        self._device = device
        self._open: List[str] = []
        self.spans: List[tuple] = []
        self.assignments = [0] * len(MOE_PHASES)
        self.mamba_tokens = [0] * len(MOE_PHASES)
        self._dropped = None        # [len(MOE_PHASES)] int64 on the device

    def _mark(self):
        if self._stream is None:
            return None
        ev = self._pool.pop() if self._pool else \
            self._torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def _phase(self) -> Optional[int]:
        return next((_PHASE_OF[s] for s in self._open if s in _PHASE_OF),
                    None)

    def count_mamba(self, n: int) -> None:
        i = self._phase()
        if i is not None:
            self.mamba_tokens[i] += n

    def count_moe(self, n: int, keep) -> None:
        i = self._phase()
        if i is None:
            return
        self.assignments[i] += n
        if keep is None:
            return
        if self._dropped is None:
            self._dropped = self._torch.zeros(
                len(MOE_PHASES), dtype=self._torch.int64, device=self._device)
        self._dropped[i].add_((keep == 0).sum())

    def finish(self) -> None:
        """Resolve the spans' device times and add the request to the
        global registry, and to the installed tracer's file."""
        if self.spans and self.spans[-1][5] is not None:
            self.spans[-1][5].synchronize()
        dropped = (self._dropped.tolist() if self._dropped is not None
                   else [0] * len(MOE_PHASES))
        host: Dict[str, float] = defaultdict(float)
        device: Dict[str, float] = defaultdict(float)
        calls: Dict[str, int] = defaultdict(int)
        tracer = _current
        records = []
        for name, parent, ts, host_s, ev0, ev1 in self.spans:
            if ev0 is None:
                dev_s = host_s
            else:
                dev_s = ev0.elapsed_time(ev1) * 1e-3
                self._pool += (ev0, ev1)
            host[name] += host_s
            device[name] += dev_s
            calls[name] += 1
            if tracer is not None:
                records.append(dict(
                    ph=PH_SPAN, name=name, cat="serve", ts=ts, dur=host_s,
                    tid=tracer._tid(), args=dict(
                        request=self.id, parent=parent, device_s=dev_s)))
        self.spans = []
        reg = metrics.global_registry()
        for name in host:
            lb = {"span": name}
            reg.counter("lm_span_host_seconds_total", lb).inc(host[name])
            reg.counter("lm_span_device_seconds_total", lb).inc(device[name])
            reg.counter("lm_span_calls_total", lb).inc(calls[name])
        reg.counter("lm_requests_total").inc()
        reg.counter("lm_decode_steps_total").inc(calls["serve.decode_step"])
        for phase, n, n_drop in zip(MOE_PHASES, self.assignments, dropped):
            if n:
                lb = {"phase": phase}
                reg.counter("lm_moe_assignments_total", lb).inc(n)
                reg.counter("lm_moe_dropped_total", lb).inc(n_drop)
        for phase, n in zip(MOE_PHASES, self.mamba_tokens):
            if n:
                reg.counter("lm_mamba_tokens_total", {"phase": phase}).inc(n)
        if records:
            tracer.emit_many(records)


@contextlib.contextmanager
def serving_request(device):
    """Serve one request on ``device`` with its spans on when
    :func:`serving_on` holds at entry; yields its :class:`RequestTrace`
    or None.  The switch is restored on the way out, and only a request
    that returns adds to the registry and the trace."""
    global _serving
    rec = RequestTrace(device) if serving_on() else None
    prev, _serving = _serving, rec
    try:
        yield rec
    finally:
        _serving = prev
    if rec is not None:
        rec.finish()


def serving_span(name: str):
    """A span of the request being served (the shared no-op when its
    spans are off)."""
    r = _serving
    if r is None:
        return NULL_SPAN
    return _ServingSpan(r, name)


def moe_assignments(n: int, keep=None) -> None:
    """Count ``n`` token-expert assignments of an MoE block in the served
    request's phase and, where ``keep`` (a tensor over them, 0 where the
    assignment was dropped past capacity) is given, those dropped."""
    r = _serving
    if r is not None:
        r.count_moe(n, keep)


def mamba_tokens(n: int) -> None:
    """Count ``n`` tokens (batch rows x positions) through a Mamba mixer in
    the served request's phase."""
    r = _serving
    if r is not None:
        r.count_mamba(n)
