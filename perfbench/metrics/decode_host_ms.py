"""decode_host_ms: the host's time to issue one decode step, in ms: the
host seconds of the program's own span ``serve.decode_step`` (no
synchronise inside it) over ``lm_decode_steps_total`` in the process
registry (``repro_torch.obs.metrics``) after the traced window.  Near
``decode_step_ms`` the host, not the device, sets the pace.  None where
the program records no such span."""
from repro_torch.obs import metrics


def read(run):
    snap = metrics.global_registry().snapshot()
    steps = metrics.snapshot_value(snap, "counters", "lm_decode_steps_total")
    t = metrics.snapshot_value(snap, "counters",
                               "lm_span_host_seconds_total",
                               {"span": "serve.decode_step"})
    if not steps or t is None:
        return None
    return dict(value=1e3 * t / steps, samples=int(steps))
