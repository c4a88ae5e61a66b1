"""moe_dispatch_ms.prefill: the device time of the MoE block's grouped
capacity dispatch and combine, per request, in ms: the program's own
spans ``moe.dispatch`` (the one-hot, the capacity slots and the
``td,tec->ecd`` einsum) and ``moe.combine`` (the ``ecd,tec->td`` einsum),
read from the process registry (``repro_torch.obs.metrics``:
``lm_span_device_seconds_total`` of the two over ``lm_requests_total``)
after the traced window.  None where the program records no such spans."""
from repro_torch.obs import metrics


def read(run):
    snap = metrics.global_registry().snapshot()
    n = metrics.snapshot_value(snap, "counters", "lm_requests_total")
    t = [metrics.snapshot_value(snap, "counters",
                                "lm_span_device_seconds_total", {"span": s})
         for s in ("moe.dispatch", "moe.combine")]
    if not n or None in t:
        return None
    return dict(value=1e3 * sum(t) / n, samples=int(n))
