"""The one generator of request streams, driven by a traffic file.

A traffic file gives the prompt lengths (``prompt_len``: a ``loguniform``
distribution cut into ``levels`` quantile midpoints, or ``grid``: every
multiple of ``multiple`` from ``min`` to ``max``; either rounded down to a
multiple of ``multiple``), the batch of a request (``batch``: a fixed
number of prompts, or ``tokens_per_request // S``), the tokens generated a
request (``gen_tokens``).  Every seed serves the same multiset of
lengths, cycle after cycle, in an order drawn from the seed: a cycle is a
shuffle of pairs (the i-th shortest length with the i-th longest, in
either order; the middle one alone), so that consecutive pairs of
requests carry the same mix whatever the seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List

import numpy as np
import torch

from benchlib.cells import sub_seed


@dataclasses.dataclass(frozen=True)
class Shape:
    batch: int
    prompt_len: int
    gen_tokens: int

    @property
    def prompt_tokens(self) -> int:
        return self.batch * self.prompt_len

    @property
    def output_tokens(self) -> int:
        return self.batch * self.gen_tokens


def prompt_lengths(tr: Dict) -> List[int]:
    """The cycle's multiset of prompt lengths, ascending."""
    p = tr["prompt_len"]
    lo, hi, mult = p["min"], p["max"], p["multiple"]
    if p["dist"] == "grid":
        return list(range(lo, hi + 1, mult))
    if p["dist"] == "loguniform":
        n = p["levels"]
        out = []
        for i in range(n):
            q = (i + 0.5) / n
            s = math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
            out.append(max(lo, int(s) // mult * mult))
        return sorted(out)
    raise ValueError(f"prompt_len dist {p['dist']!r}")


def shape_of(tr: Dict, S: int) -> Shape:
    b = tr["batch"]
    B = b["prompts"] if "prompts" in b else \
        max(1, b["tokens_per_request"] // S)
    return Shape(B, S, tr["gen_tokens"])


def shapes(tr: Dict) -> List[Shape]:
    """Every distinct request shape of the mix (what set-up warms up)."""
    return sorted({shape_of(tr, S) for S in prompt_lengths(tr)},
                  key=lambda s: (s.prompt_len, s.batch))


def schedule(tr: Dict, seed: int) -> Iterator[Shape]:
    """The endless stream of request shapes of one run."""
    lens = prompt_lengths(tr)
    n = len(lens)
    blocks = [[lens[i], lens[n - 1 - i]] for i in range(n // 2)]
    if n % 2:
        blocks.append([lens[n // 2]])
    cycle = 0
    while True:
        rng = np.random.default_rng(sub_seed(seed, "order", cycle))
        for k in rng.permutation(len(blocks)):
            blk = blocks[k]
            if len(blk) == 2 and rng.integers(2):
                blk = blk[::-1]
            for S in blk:
                yield shape_of(tr, S)
        cycle += 1


def prompts(shape: Shape, vocab: int, seed: int, index: int, device
            ) -> torch.Tensor:
    """Request ``index``'s prompts [B, S], token ids uniform over the
    vocabulary, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "prompt", index))
    return torch.randint(0, vocab, (shape.batch, shape.prompt_len),
                         generator=gen, device=device)
