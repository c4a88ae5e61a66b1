"""ssm_scan.roofline: the least time the prefills' selective scans could
take on the device (for each request, every Mamba layer's scan of its
[B, S] tokens over the configuration's channels and states: the largest
of its flops over the float32 peak, its exponentials over the SFU rate
and its bytes over the HBM bandwidth, ``counts.ssm_scan_call``) over the
device time of the ``ssm_scan`` forward kernel, in percent.  None where
the configuration has no Mamba layers or the trace no such kernel."""
from benchlib import peaks

KERNEL = "ssm_scan_kernel"
# An H100 SM issues 16 SFU exponentials a clock against 128 float32 FMAs
# (256 flops), so the exponential rate is the float32 peak over 16.
SFU_PER_FP32_FLOP = 1.0 / 16


def read(run):
    tr, pk, c = run.trace, run.peaks, run.c
    counts = run.counts
    if not tr or not pk or not run.requests \
            or not hasattr(counts, "ssm_scan_call"):
        return None
    t = sum(s for n, s in tr["op_device_s"].items() if KERNEL in n)
    if t <= 0:
        return None
    m = c["mamba"]
    D, N = m["expand"] * c["d_model"], m["d_state"]
    sfu = SFU_PER_FP32_FLOP * pk["fp32_flops"]
    least = 0.0
    for r in run.requests:
        w = counts.ssm_scan_call(r.shape.batch, r.shape.prompt_len, D, N)
        least += counts.n_mamba_layers(c) * max(
            w["exps"] / sfu,
            peaks.min_time(w["flops"], w["bytes"], pk, "fp32_flops")[0])
    return 100.0 * least / t
