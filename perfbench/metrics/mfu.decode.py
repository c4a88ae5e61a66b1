"""mfu.decode: the decode steps' share of the device's roofline: for each
step the larger of its model flops over the bf16 peak and the bytes it
must move over the HBM bandwidth (weights once, the routed experts only,
the KV cache's valid positions), summed, over the decode loops' time
(``Generation.t_decode``), in percent; the counts are the configuration's
(``run.counts``)."""


def read(run):
    pk, c = run.peaks, run.c
    reqs = [r for r in run.requests if r.shape.gen_tokens > 1]
    if not pk or not reqs:
        return None
    n_moe = sum(1 for s in c["period"] if s["moe"]) * (
        c["n_layers"] // len(c["period"]))
    routed = run.experts_routed
    steps = sum(r.shape.gen_tokens - 1 for r in reqs)
    if routed is not None and len(routed) != steps * n_moe:
        routed = None       # the picks do not line up with the steps
    least, k = 0.0, 0
    for r in reqs:
        B, S = r.shape.batch, r.shape.prompt_len
        for i in range(r.shape.gen_tokens - 1):
            picks = routed[k:k + n_moe] if routed is not None else None
            k += n_moe
            f = run.counts.decode_step_flops(c, B, S + i + 1)
            b = run.counts.decode_step_bytes(c, B, S + i + 1, picks)
            least += max(f / pk["bf16_flops"], b / pk["hbm_bytes"])
    t = sum(r.t_decode for r in reqs)
    return 100.0 * least / t if t > 0 else None
