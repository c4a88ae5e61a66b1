"""moe_gather_ms.decode: the device time of the decode MoE's per-token
gather of the chosen experts' weights (``p["e_up"][idx]`` and its
siblings: the program's own span ``moe.gather``), per decode step, in ms:
``lm_span_device_seconds_total{span="moe.gather"}`` over
``lm_decode_steps_total`` in the process registry
(``repro_torch.obs.metrics``) after the traced window.  None where the
program records no such span."""
from repro_torch.obs import metrics


def read(run):
    snap = metrics.global_registry().snapshot()
    steps = metrics.snapshot_value(snap, "counters", "lm_decode_steps_total")
    t = metrics.snapshot_value(snap, "counters",
                               "lm_span_device_seconds_total",
                               {"span": "moe.gather"})
    if not steps or t is None:
        return None
    return dict(value=1e3 * t / steps, samples=int(steps))
