"""moe_ms.prefill: device time under the MoE block's range in prefills
(``blocks._moe`` on a prompt), per request."""


def read(run):
    t = (run.trace or {}).get("span_device_s", {}).get("pb.moe.prefill")
    return 1e3 * t / len(run.requests) if t and run.requests else None
