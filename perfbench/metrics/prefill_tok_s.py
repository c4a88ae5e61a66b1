"""prefill_tok_s: every prompt token of the completed requests over the
time from the window's start to the last completion."""
from benchlib import stats


def read(run):
    return stats.rate((r.shape.prompt_tokens for r in run.requests),
                      run.t_start, run.t_end)
