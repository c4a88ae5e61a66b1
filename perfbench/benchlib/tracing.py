"""The traced run's spans and device timeline.

The harness's own code puts ``torch.profiler.record_function`` ranges
around the program's entries and blocks by rebinding module functions for
the traced run and restoring them after (no file of the program changes):
``lm.prefill``, ``lm.extend_caches``, ``lm.decode_step`` and, in
``models/blocks.py``, ``_attn_apply`` and ``_moe`` (a prefill's
``pb.moe.prefill``, a decode step's ``pb.moe.decode``).  In a decode
step it also keeps the router's expert picks, to count the distinct
experts whose weights the step reads.

Reading the trace: device operations (kernels, copies, sets) with their
device intervals; each is charged to the spans that were open on the host
when the operation that launched it started (the profiler links them by
correlation id).
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchlib import stats

SPAN = "pb."


class Spans:
    """Context manager that wraps the program's functions in ranges."""

    def __init__(self):
        self.routes: List[torch.Tensor] = []   # decode steps' expert picks
        self._undo = []
        self._decode_moe = False

    def _wrap(self, mod, name, label_of):
        orig = getattr(mod, name)

        def wrapped(*args, **kwargs):
            with record_function(label_of(args)):
                return orig(*args, **kwargs)
        setattr(mod, name, wrapped)
        self._undo.append((mod, name, orig))

    def __enter__(self):
        from repro_torch.models import blocks, lm
        self._wrap(lm, "prefill", lambda a: SPAN + "prefill")
        self._wrap(lm, "extend_caches", lambda a: SPAN + "extend_caches")
        self._wrap(lm, "decode_step", lambda a: SPAN + "decode_step")
        self._wrap(blocks, "_attn_apply", lambda a: SPAN + "attn.prefill")
        moe, route = blocks._moe, blocks._route
        spans = self

        def moe_wrapped(p, cfg, h):
            decode = h.shape[1] == 1
            with record_function(SPAN + ("moe.decode" if decode
                                         else "moe.prefill")):
                spans._decode_moe = decode
                try:
                    return moe(p, cfg, h)
                finally:
                    spans._decode_moe = False

        def route_wrapped(p, ht, top_k):
            gates, idx = route(p, ht, top_k)
            if spans._decode_moe:
                spans.routes.append(idx)
            return gates, idx
        blocks._moe, blocks._route = moe_wrapped, route_wrapped
        self._undo += [(blocks, "_moe", moe), (blocks, "_route", route)]
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo.clear()
        return False

    def experts_routed(self) -> List[int]:
        """Distinct experts picked in each decode MoE call, in call order."""
        return [int(torch.unique(ix).numel()) for ix in self.routes]


def profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False,
                   profile_memory=False)


def _is_device(ev) -> bool:
    """A device operation: not a host event, and not the device-side copy
    of a range (which carries the range's name)."""
    return ev.device_type() != torch.autograd.DeviceType.CPU \
        and not ev.name().startswith(SPAN)


def read(prof, window_span: str = SPAN + "window") -> Dict:
    """Device time by span, the busy union over the window, the ten
    longest-running device operations and the idle gaps by host span.
    Times in seconds."""
    events = list(prof.profiler.kineto_results.events())
    launch_at: Dict[int, int] = {}
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    device: List[Tuple[int, int, str, int]] = []
    for ev in events:
        if _is_device(ev):
            device.append((ev.start_ns(), ev.end_ns(), ev.name(),
                           ev.linked_correlation_id()))
        elif ev.device_type() == torch.autograd.DeviceType.CPU:
            if ev.name().startswith(SPAN):
                spans[ev.name()].append((ev.start_ns(), ev.end_ns()))
            elif ev.linked_correlation_id() == 0:
                launch_at[ev.correlation_id()] = ev.start_ns()
    if not spans.get(window_span):
        raise RuntimeError("the trace holds no window span")
    w_lo = min(s for s, _ in spans[window_span])
    w_hi = max(e for _, e in spans[window_span])
    starts = {k: sorted(v) for k, v in spans.items()}

    def inside(name: str, t: Optional[int]) -> bool:
        if t is None:
            return False
        iv = starts[name]
        i = bisect.bisect_right(iv, (t, 1 << 62)) - 1
        return i >= 0 and iv[i][0] <= t < iv[i][1]

    span_time: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    intervals = []
    n_linked = 0
    for s, e, name, linked in device:
        if e <= w_lo or s >= w_hi:
            continue
        intervals.append((s, e))
        dur = (e - s) * 1e-9
        by_name[name] += dur
        t = launch_at.get(linked)
        n_linked += t is not None
        for span in starts:
            if inside(span, t):
                span_time[span] += dur
    busy = stats.union_length(intervals, w_lo, w_hi) * 1e-9
    # idle gaps, charged to the innermost span open on the host at the
    # gap's middle (spans of one name never overlap; a shorter open span
    # is an inner one)
    gap_by: Dict[str, float] = defaultdict(float)
    for g0, g1 in stats.gaps(intervals, w_lo, w_hi):
        mid = (g0 + g1) // 2
        open_ = [(iv[1] - iv[0], n) for n, ivs in starts.items()
                 for iv in [_covering(ivs, mid)] if iv]
        gap_by[min(open_)[1] if open_ else "outside"] += (g1 - g0) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(
        window_s=(w_hi - w_lo) * 1e-9, busy_s=busy,
        span_device_s=dict(span_time), op_device_s=dict(by_name),
        n_device_ops=len(intervals), n_linked=n_linked,
        device_ops=[[n[:160], t] for n, t in top[:10]],
        idle_gaps=[[n, t] for n, t in sorted(gap_by.items(),
                                             key=lambda kv: -kv[1])[:10]])


def _covering(ivs: List[Tuple[int, int]], t: int):
    i = bisect.bisect_right(ivs, (t, 1 << 62)) - 1
    if i >= 0 and ivs[i][0] <= t < ivs[i][1]:
        return ivs[i]
    return None


@contextlib.contextmanager
def window_span():
    with record_function(SPAN + "window"):
        yield
