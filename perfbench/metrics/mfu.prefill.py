"""mfu.prefill: the model flops the window's prefills need (active experts
only, causal pairs, the head at the served position) over their time
(``Generation.t_prefill``, the program's clock after a synchronise) and
the bf16 peak, in percent; the counts are the configuration's
(``run.counts``)."""


def read(run):
    pk, c = run.peaks, run.c
    if not pk or not run.requests:
        return None
    flops = sum(run.counts.prefill_flops(c, r.shape.batch,
                                         r.shape.prompt_len)
                for r in run.requests)
    t = sum(r.t_prefill for r in run.requests)
    return 100.0 * flops / (t * pk["bf16_flops"]) if t > 0 else None
