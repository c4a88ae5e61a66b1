"""decode_step_ms: the median over requests of the decode loop's time a
step, ``Generation.t_decode / (gen_tokens - 1)`` (the program's own clock,
read after a synchronise)."""
import statistics


def read(run):
    ms = [1e3 * r.t_decode / (r.shape.gen_tokens - 1)
          for r in run.requests if r.shape.gen_tokens > 1]
    return dict(value=statistics.median(ms), samples=len(ms)) if ms else None
