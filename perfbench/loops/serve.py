"""The loop of served traffic: one client in a closed loop over
``repro_torch.launch.serve.generate``.  It takes the next request when the
last has returned, stops taking requests once ``seconds`` have passed, and
lets every request it took complete and count.  A traffic file names it
as ``"loop": "serve"``."""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List

import torch

from benchlib import cells, check, traffic


@dataclasses.dataclass
class Request:
    shape: traffic.Shape
    t_take: float
    t_done: float
    t_prefill: float
    t_decode: float


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _PromptRows:
    """Keeps rows of the full prompt logits that ``lm.prefill`` computes
    (through ``lm.forward`` with ``collect_caches``) and returns only the
    last of: while ``want`` holds positions, the next prefill's rows at
    them are kept in ``rows``.  Rebinds ``lm.forward`` and restores it."""

    def __init__(self):
        self.want, self.rows = None, None

    def __enter__(self):
        from repro_torch.models import lm
        self._lm, orig = lm, lm.forward

        def forward(*args, **kwargs):
            out = orig(*args, **kwargs)
            if self.want is not None and kwargs.get("collect_caches"):
                self.rows = out[0][:, self.want].clone()
                self.want = None
            return out
        self._orig, lm.forward = orig, forward
        return self

    def __exit__(self, *exc):
        self._lm.forward = self._orig
        return False


def warm_up(params, cfg, tr: Dict, seed: int, dev) -> None:
    """One request of every shape the mix serves, through the program's
    entries: a prefill-only request through ``generate``; for a request
    that decodes, the prefill, the decode caches at the request's length
    and two decode steps, which is every shape its decode steps use."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    for k, shape in enumerate(traffic.shapes(tr)):
        prompts = traffic.prompts(shape, cfg.vocab,
                                  cells.sub_seed(seed, "warm"), k, dev)
        if shape.gen_tokens == 1:
            serve.generate(params, cfg, prompts, 1)
            continue
        with torch.no_grad():
            logits, caches = lm.prefill(params, cfg, prompts)
            caches = lm.extend_caches(caches, cfg,
                                      shape.prompt_len + shape.gen_tokens)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            for i in range(2):
                logits, caches = lm.decode_step(params, cfg, tok, caches,
                                                shape.prompt_len + i)
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        del logits, caches
    _sync(dev)


def window(params, cfg, tr: Dict, seed: int, seconds: float, dev):
    """The closed loop; returns (requests, served, failed, t_start,
    t_end)."""
    from repro_torch.launch import serve
    sched = traffic.schedule(tr, seed)
    requests: List[Request] = []
    served: List[check.Served] = []
    failed = 0
    keep = _PromptRows()
    t_start = time.perf_counter()
    with keep:
        while time.perf_counter() - t_start < seconds:
            shape = next(sched)
            index = len(requests) + failed
            prompts = traffic.prompts(shape, cfg.vocab, seed, index, dev)
            pos = check.positions(shape.prompt_len,
                                  tr["check"]["positions"], seed, index)
            keep.want = pos[:-1]
            t_take = time.perf_counter()
            try:
                g = serve.generate(params, cfg, prompts, shape.gen_tokens)
                rows = torch.cat([keep.rows, g.prefill_logits[:, -1:]],
                                 dim=1)
            except (RuntimeError, ValueError) as e:     # OOM: RuntimeError
                failed += 1
                print(f"request {index} {shape} failed: {e!r}"[:400],
                      file=sys.stderr)
                continue
            t_done = time.perf_counter()
            requests.append(Request(shape, t_take, t_done, g.t_prefill,
                                    g.t_decode))
            served.append(check.Served(prompts, g.tokens, pos, rows))
            del g, rows
    t_end = requests[-1].t_done if requests else time.perf_counter()
    return requests, served, failed, t_start, t_end


def compare(ref, params, c: Dict, served: List[check.Served], seed: int,
            tr: Dict, control: bool = False) -> Dict:
    """The numbers that decide ``correct`` (``check.numbers``) over the
    sample of the served requests that the mix's ``check`` section sizes."""
    picked = check.sample(served, seed, tr["check"]["max_requests"],
                          tr["check"]["ref_tokens"])
    return check.numbers(ref, params, c, served, picked, control)
