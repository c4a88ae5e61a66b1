"""output_tok_s: every generated token of the completed requests (batch x
gen_tokens each, the first token included) over the time from the
window's start to the last completion; the prefills are inside that
time."""
from benchlib import stats


def read(run):
    return stats.rate((r.shape.output_tokens for r in run.requests),
                      run.t_start, run.t_end)
