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
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from repro_torch.core import fsutil

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
        line = json.dumps(record, allow_nan=False,
                          separators=(",", ":")) + "\n"
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line)
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
