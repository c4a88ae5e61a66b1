"""ttft_ms.p90: the 90th percentile, over every request of the window, of
the time from when the loop takes the request to when its first token is
on the host.  A request that generates one token has it on the host when
``generate`` returns; requests that generate more return every token at
once, so the metric reads nothing there."""
from benchlib import stats


def read(run):
    if not run.requests or any(r.shape.gen_tokens != 1
                               for r in run.requests):
        return None
    ms = [1e3 * (r.t_done - r.t_take) for r in run.requests]
    return dict(value=stats.percentile(ms, 90), samples=len(ms))
