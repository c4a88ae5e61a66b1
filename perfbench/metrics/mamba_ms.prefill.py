"""mamba_ms.prefill: the device time of the Mamba mixers, per request, in
ms: the program's own span ``mamba`` (``blocks._mamba_apply``: the input
norm, in_proj, the conv, x_proj and the inner norms, dt_proj, the
``ssm_scan`` kernel, the gate and out_proj), read from the process
registry (``repro_torch.obs.metrics``: ``lm_span_device_seconds_total``
of ``mamba`` over ``lm_requests_total``) after the traced window.  The
span totals carry no phase, so the reading holds only where no token went
through a mixer in decode (``lm_mamba_tokens_total{phase="decode"}``
absent or 0).  None where the program records no such span, or where the
mixers also ran in decode."""
from repro_torch.obs import metrics


def read(run):
    snap = metrics.global_registry().snapshot()
    n = metrics.snapshot_value(snap, "counters", "lm_requests_total")
    t = metrics.snapshot_value(snap, "counters",
                               "lm_span_device_seconds_total",
                               {"span": "mamba"})
    decoded = metrics.snapshot_value(snap, "counters",
                                     "lm_mamba_tokens_total",
                                     {"phase": "decode"}, default=0)
    if not n or t is None or decoded:
        return None
    return dict(value=1e3 * t / n, samples=int(n))
