"""moe_ms.decode: device time under the MoE block's range in decode steps
(``blocks._moe`` on one token a row), per decode step."""


def read(run):
    t = (run.trace or {}).get("span_device_s", {}).get("pb.moe.decode")
    steps = sum(r.shape.gen_tokens - 1 for r in run.requests)
    return 1e3 * t / steps if t and steps else None
