"""Unified telemetry (port of ``repro.obs``): structured tracing, metrics,
structured logging.

Three zero-dependency pillars shared by every layer of the stack
(search engine, campaign runner, fleet workers/supervisor, recommend
server, LM serving):

* :mod:`repro_torch.obs.trace`   — ``Span``/``trace()`` crash-safe JSONL span
  logs (one ``trace.jsonl`` per process, Chrome/Perfetto-exportable via
  ``python -m repro_torch.obs.export``), and the serving spans of
  ``repro_torch.launch.serve.generate``: one request's steps down to the
  MoE block's route, gather, dispatch and combine, with host and device
  seconds and the MoE's dropped assignments, on while a tracer is
  installed or a ``torch.profiler`` records;
* :mod:`repro_torch.obs.metrics` — ``MetricsRegistry`` counters / gauges /
  fixed-bucket histograms with deterministic aggregation and a
  Prometheus text rendering (the serve ``/metrics`` surface and the
  lease-piggybacked live fleet view);
* :mod:`repro_torch.obs.log`     — JSONL structured logger carrying
  ``(worker, batch_id, cell_id)`` context, with a plain-text mirror.

Everything here READS clocks and counters but never touches an RNG
stream or checkpoint content: searches with telemetry on are bitwise
identical to telemetry off (``tests/test_torch_obs.py``), and so are
served tokens and logits (``tests/test_torch_serve_trace.py``).  Records keep
the reference's file names and formats, so either package reads the
other's run directories.
"""
from repro_torch.obs.metrics import (MetricsRegistry, global_registry,
                                     merge_snapshots, render_prometheus,
                                     snapshot_value)
from repro_torch.obs.trace import (Tracer, current_tracer, install_tracer,
                                   span, tracing_disabled)

__all__ = [
    "MetricsRegistry", "global_registry", "merge_snapshots",
    "render_prometheus", "snapshot_value", "Tracer", "current_tracer",
    "install_tracer", "span", "tracing_disabled",
]
