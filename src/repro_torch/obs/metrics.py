"""Metrics: counters, gauges, fixed-bucket histograms, Prometheus text
(port of ``repro.obs.metrics``; same snapshot format).

A :class:`MetricsRegistry` is a cheap in-process store the hot paths feed
(dict update per dispatch — no locks on read-modify of plain floats
beyond one registry lock, no allocation after first touch):

* **counters** — monotone totals (requests served, candidates screened);
* **gauges**   — last-value instruments (env-steps/s, gate open frac);
* **histograms** — FIXED bucket edges chosen at creation, so merging
  snapshots from many workers is deterministic (bucket counts add
  elementwise; there is no re-bucketing and therefore no float-order
  sensitivity).

``snapshot()`` returns a JSON-safe dict — small enough to piggyback on
the fleet lease heartbeat (``repro_torch.campaign.store.write_lease``), which
is how the supervisor renders a live fleet view from the shared run
directory alone.  ``render_prometheus`` serializes a snapshot in the
Prometheus text exposition format for the serve ``GET /metrics``.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# default latency bucket edges (seconds): 0.5 ms .. 10 s, roughly 1-2.5-5
# per decade.  Fixed here so every process buckets identically and fleet
# aggregation is deterministic.
LATENCY_EDGES_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Optional[Dict[str, str]]) -> _Key:
    return (name, tuple(sorted((str(k), str(v))
                               for k, v in (labels or {}).items())))


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-edge histogram: ``counts[i]`` counts observations
    ``<= edges[i]``; the final slot is the +Inf overflow bucket."""

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float]) -> None:
        e = [float(x) for x in edges]
        if not e or sorted(e) != e or len(set(e)) != len(e):
            raise ValueError(f"histogram edges must be strictly "
                             f"increasing and non-empty (got {edges})")
        self.edges = tuple(e)
        self.counts = [0] * (len(e) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            return                      # non-finite never skews a bucket
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1


class MetricsRegistry:
    """Named instruments, lazily created, snapshot-able.

    Instrument handles are cached by (name, labels) so the hot loop pays
    one dict lookup; creation takes the registry lock (instruments are
    few, observations are many)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[_Key, Counter] = {}
        self._gauges: Dict[_Key, Gauge] = {}
        self._hists: Dict[_Key, Histogram] = {}

    # ------------------------------------------------------------ factories
    def counter(self, name: str,
                labels: Optional[Dict[str, str]] = None) -> Counter:
        k = _key(name, labels)
        c = self._counters.get(k)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(k, Counter())
        return c

    def gauge(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        k = _key(name, labels)
        g = self._gauges.get(k)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(k, Gauge())
        return g

    def histogram(self, name: str, edges: Sequence[float] = LATENCY_EDGES_S,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        k = _key(name, labels)
        h = self._hists.get(k)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(k, Histogram(edges))
        return h

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict:
        """JSON-safe view: lists of {name, labels, ...} rows per kind
        (stable sort order, so two identical registries snapshot
        identically)."""
        with self._lock:
            return dict(
                counters=[dict(name=n, labels=dict(lb), value=c.value)
                          for (n, lb), c in sorted(self._counters.items())],
                gauges=[dict(name=n, labels=dict(lb), value=g.value)
                        for (n, lb), g in sorted(self._gauges.items())],
                histograms=[dict(name=n, labels=dict(lb),
                                 edges=list(h.edges), counts=list(h.counts),
                                 sum=h.sum, count=h.count)
                            for (n, lb), h in sorted(self._hists.items())])

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


def merge_snapshots(snaps: Sequence[Dict]) -> Dict:
    """Aggregate snapshots from many workers deterministically.

    Counters and histogram buckets ADD (same fixed edges required —
    mismatched edges raise); gauges AVERAGE over the sources that carry
    them (a gauge is a level, not a total — callers wanting totals sum
    per-worker rows themselves, as the fleet status table does)."""
    counters: Dict[_Key, float] = {}
    gauges: Dict[_Key, List[float]] = {}
    hists: Dict[_Key, Dict] = {}
    for snap in snaps:
        for row in (snap or {}).get("counters", []):
            k = _key(row["name"], row.get("labels"))
            counters[k] = counters.get(k, 0.0) + float(row["value"])
        for row in (snap or {}).get("gauges", []):
            k = _key(row["name"], row.get("labels"))
            gauges.setdefault(k, []).append(float(row["value"]))
        for row in (snap or {}).get("histograms", []):
            k = _key(row["name"], row.get("labels"))
            h = hists.get(k)
            if h is None:
                hists[k] = dict(edges=list(row["edges"]),
                                counts=list(row["counts"]),
                                sum=float(row["sum"]),
                                count=int(row["count"]))
            else:
                if h["edges"] != list(row["edges"]):
                    raise ValueError(
                        f"histogram {k[0]!r} edges differ across "
                        "snapshots; aggregation would be ambiguous")
                h["counts"] = [a + b for a, b
                               in zip(h["counts"], row["counts"])]
                h["sum"] += float(row["sum"])
                h["count"] += int(row["count"])
    return dict(
        counters=[dict(name=n, labels=dict(lb), value=v)
                  for (n, lb), v in sorted(counters.items())],
        gauges=[dict(name=n, labels=dict(lb),
                     value=sum(vs) / len(vs))
                for (n, lb), vs in sorted(gauges.items())],
        histograms=[dict(name=n, labels=dict(lb), **h)
                    for (n, lb), h in sorted(hists.items())])


def snapshot_value(snap: Optional[Dict], kind: str, name: str,
                   labels: Optional[Dict[str, str]] = None,
                   default=None):
    """Pull one instrument out of a snapshot dict: the ``value`` for
    counters/gauges, the full row for histograms.  ``default`` when the
    snapshot is missing or doesn't carry the instrument (e.g. a lease
    written by a worker that hasn't reached the search loop yet)."""
    want = _key(name, labels)
    for row in (snap or {}).get(kind, []):
        if _key(row["name"], row.get("labels")) == want:
            return row if kind == "histograms" else row["value"]
    return default


def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_val(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def render_prometheus(snapshot: Dict, prefix: str = "repro_") -> str:
    """Prometheus text exposition (v0.0.4) of a snapshot: one ``# TYPE``
    per metric family, cumulative ``_bucket{le=...}`` histogram series
    ending in ``+Inf``, plus ``_sum`` / ``_count``."""
    lines: List[str] = []
    typed = set()

    def _type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for row in snapshot.get("counters", []):
        name = prefix + row["name"]
        _type(name, "counter")
        lines.append(f"{name}{_fmt_labels(row.get('labels') or {})} "
                     f"{_fmt_val(row['value'])}")
    for row in snapshot.get("gauges", []):
        name = prefix + row["name"]
        _type(name, "gauge")
        lines.append(f"{name}{_fmt_labels(row.get('labels') or {})} "
                     f"{_fmt_val(row['value'])}")
    for row in snapshot.get("histograms", []):
        name = prefix + row["name"]
        _type(name, "histogram")
        labels = row.get("labels") or {}
        cum = 0
        for edge, n in zip(list(row["edges"]) + [math.inf],
                           row["counts"]):
            cum += int(n)
            le = _fmt_labels(labels, f'le="{_fmt_val(edge)}"')
            lines.append(f"{name}_bucket{le} {cum}")
        lines.append(f"{name}_sum{_fmt_labels(labels)} "
                     f"{repr(float(row['sum']))}")
        lines.append(f"{name}_count{_fmt_labels(labels)} "
                     f"{int(row['count'])}")
    return "\n".join(lines) + "\n"


# -------------------------------------------------------- process-global
_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    """The process-global registry: the search engine feeds it, the fleet
    Heartbeat snapshots it onto the lease, benches/tests may clear it."""
    return _GLOBAL
