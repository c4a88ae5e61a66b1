"""The comparison that decides ``correct``.

After the window, a sample of the completed requests drawn from the seed,
the one with the longest prompts always in it, is run through the plain
float32 reference once per request: each prompt with its served tokens
fed back.  Two things are compared:

- the served tokens: a token's gap is how far its reference logit lies
  below the reference's best at its position, in units of that
  position's logit standard deviation;
- the prefill's logits at the prompt's last position and at
  ``positions - 1`` more positions of each prompt drawn from the seed
  (the window keeps those rows of what ``generate`` returned): a row's
  distance from the reference's, ||program - reference|| / ||reference -
  its mean||.  Rows inside the prompt see every layer of the prefill at
  that position and are less exposed than the last one, which comes last
  in the MoE's capacity order, to a router near-tie that moves a drop.

Numbers, each against its limit in ``limits/<cell>.json`` where that file
gives one (a cell compares those that separate its program from the
control): ``gap_mean``, ``gap_max`` over the served tokens;
``logit_err_p50``, ``logit_err_p90``, ``logit_err_mean``,
``logit_err_max`` over the rows.  A high percentile sees a fault that
only some prompts show (one batch slot, the longest prompts).

The control is the reference computed in float8 e4m3 put in the
program's place: at the same positions of the same sequences, the gap of
the token it puts first, and its logits' distance.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from benchlib.cells import sub_seed

NUMBERS = ("gap_mean", "gap_max", "logit_err_p50", "logit_err_p90",
           "logit_err_mean", "logit_err_max")


@dataclasses.dataclass
class Served:
    """One completed request, as the window kept it."""
    prompts: torch.Tensor          # [B, S] on the device
    tokens: np.ndarray             # [B, gen] served tokens
    positions: List[int]           # prompt positions kept, ascending, S-1 last
    logits: torch.Tensor           # [B, len(positions), V]: the prefill's

    @property
    def ref_tokens(self) -> int:
        B, S = self.prompts.shape
        return B * (S + self.tokens.shape[1] - 1)


def positions(S: int, n: int, seed: int, index: int) -> List[int]:
    """The prompt positions whose prefill logits request ``index`` keeps:
    ``n - 1`` drawn from the seed below S - 1, then the last, S - 1."""
    rng = np.random.default_rng(sub_seed(seed, "positions", index))
    k = min(n - 1, S - 1)
    drawn = rng.choice(S - 1, size=k, replace=False) if k > 0 else []
    return sorted(int(p) for p in drawn) + [S - 1]


def sample(served: List[Served], seed: int, max_requests: int,
           ref_tokens: int) -> List[int]:
    """Indices of the requests to compare: the longest prompt first, then
    others drawn from the seed, each with a weight of its served tokens
    (so that every served token is as likely to be checked), while the
    reference's token budget lasts."""
    if not served:
        return []
    longest = max(range(len(served)),
                  key=lambda i: (served[i].prompts.shape[1], -i))
    rng = np.random.default_rng(sub_seed(seed, "check"))
    weight = np.array([r.tokens.size for r in served], dtype=np.float64)
    keys = rng.random(len(served)) ** (1.0 / weight)   # weighted, no repeats
    picked, used = [longest], served[longest].ref_tokens
    for i in np.argsort(-keys):
        i = int(i)
        if len(picked) >= max_requests:
            break
        if i == longest or used + served[i].ref_tokens > ref_tokens:
            continue
        picked.append(i)
        used += served[i].ref_tokens
    return picked


def _reference_logits(ref, weights, c, r: Served, precision: str):
    """The reference's logits at the kept prompt positions and at the
    served tokens' positions: ([B, len(positions), V], [B, gen, V])."""
    B, S = r.prompts.shape
    gen = r.tokens.shape[1]
    fed = torch.as_tensor(r.tokens[:, :-1], dtype=r.prompts.dtype,
                          device=r.prompts.device)
    seq = torch.cat([r.prompts, fed], dim=1)
    k = len(r.positions) - 1                  # positions before S - 1
    read = r.positions[:-1] + list(range(S - 1, S + gen - 1))
    out = ref.logits_at(weights, c, seq, read, S, precision=precision)
    return out[:, :k + 1], out[:, k:]


def numbers(ref, weights, c: Dict, served: List[Served], picked: List[int],
            control: bool = False) -> Dict[str, Dict[str, float]]:
    """The program's numbers over the picked requests, and with
    ``control`` the float8 control's at the same positions."""
    out = {"program": dict(gaps=[], errs=[])}
    if control:
        out["control"] = dict(gaps=[], errs=[])
    n_tokens = 0
    for i in picked:
        r = served[i]
        want_rows, want = _reference_logits(ref, weights, c, r, "fp32")
        toks = torch.as_tensor(r.tokens, device=want.device)
        n_tokens += toks.numel()
        out["program"]["gaps"].append(ref.gaps(want, toks).flatten().cpu())
        out["program"]["errs"].append(
            ref.rel_err(r.logits.to(want.device), want_rows).flatten().cpu())
        if control:
            low_rows, low = _reference_logits(ref, weights, c, r, "fp8")
            out["control"]["gaps"].append(
                ref.gaps(want, low.argmax(-1)).flatten().cpu())
            out["control"]["errs"].append(
                ref.rel_err(low_rows, want_rows).flatten().cpu())
        del want, want_rows
    result = {}
    for side, acc in out.items():
        g = torch.cat(acc["gaps"]) if acc["gaps"] else torch.zeros(0)
        e = torch.cat(acc["errs"]) if acc["errs"] else torch.zeros(0)
        result[side] = dict(
            gap_max=float(g.max()) if g.numel() else float("inf"),
            gap_mean=float(g.mean()) if g.numel() else float("inf"),
            logit_err_p50=float(torch.quantile(e.double(), 0.5))
            if e.numel() else float("inf"),
            logit_err_p90=float(torch.quantile(e.double(), 0.9))
            if e.numel() else float("inf"),
            logit_err_mean=float(e.mean()) if e.numel() else float("inf"),
            logit_err_max=float(e.max()) if e.numel() else float("inf"),
            tokens=n_tokens, requests=len(picked))
    return result


def verdict(nums: Dict[str, float], limits: Dict) -> Dict:
    """{name: {value, limit}} for each number (limit None where the cell
    does not compare it, and for the tokens compared),
    and whether every compared number is within its limit over at least
    one token."""
    shown, ok = {}, True
    for name in NUMBERS:
        if name not in limits:
            shown[name] = dict(value=nums[name], limit=None)
            continue
        v, lim = nums[name], limits[name]["limit"]
        shown[name] = dict(value=v, limit=lim)
        ok = ok and v <= lim
    shown["tokens"] = dict(value=nums["tokens"], limit=None)
    return dict(ok=ok and nums["tokens"] > 0, shown=shown)
