"""moe_dropped_share.prefill: the share of the prefills' token-expert
assignments that the MoE block's grouped dispatch dropped past capacity,
in percent: the program's counters ``lm_moe_dropped_total`` over
``lm_moe_assignments_total`` (``phase="prefill"``) in the process
registry (``repro_torch.obs.metrics``) after the traced window.  None
where the program counts no assignments."""
from repro_torch.obs import metrics


def read(run):
    snap = metrics.global_registry().snapshot()
    lb = {"phase": "prefill"}
    n = metrics.snapshot_value(snap, "counters", "lm_moe_assignments_total",
                               lb)
    dropped = metrics.snapshot_value(snap, "counters", "lm_moe_dropped_total",
                                     lb)
    if not n or dropped is None:
        return None
    return dict(value=100.0 * dropped / n, samples=int(n))
