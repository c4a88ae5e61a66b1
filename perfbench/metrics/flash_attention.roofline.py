"""flash_attention.roofline: the least time the prefills' attention calls
could take on the device (the larger of their flops over the bf16 peak and
their bytes over the HBM bandwidth, call by call) over the device time of
the ``flash_attention`` forward kernel, in percent."""
from benchlib import peaks, work

KERNEL = "flash_attention_kernel"


def read(run):
    tr, pk, c = run.trace, run.peaks, run.c
    if not tr or not pk or not run.requests:
        return None
    t = sum(s for n, s in tr["op_device_s"].items() if KERNEL in n)
    if t <= 0:
        return None
    H, Hk = c["n_heads"], c["n_kv_heads"]
    hd = c["d_model"] // H
    least = 0.0
    for r in run.requests:
        w = work.flash_attention_call(r.shape.batch, H, Hk,
                                      r.shape.prompt_len, hd,
                                      c.get("sliding_window", 0), 2)
        least += run.counts.n_attn_layers(c) * peaks.min_time(
            w["flops"], w["bytes"], pk, "bf16_flops")[0]
    return 100.0 * least / t
