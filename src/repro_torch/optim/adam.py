"""Functional Adam(W) on dicts of tensors (port of ``repro.optim.adam``).

Same update as the reference, op for op: optional global-norm gradient
clip ``min(1, clip / sqrt(sum g^2 + 1e-12))``, then the moment updates,
float32 bias corrections ``1 - b**t``, decoupled weight decay
``lr * wd * p`` added to the step, and each new parameter cast back to its
own type (a bf16 parameter stays bf16; the moments of a state made by
``repro_torch.optim.trainer.create_state`` are float32 whatever the
parameters' type).  (``torch.optim.Adam`` differs: it has no global clip
and folds the bias corrections into the step size.)
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of matching nested dicts (or one leaf)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


class AdamState(NamedTuple):
    m: Any
    v: Any
    t: torch.Tensor     # int32 step count


def adam_init(params: Any) -> AdamState:
    zeros = tree_map(torch.zeros_like, params)
    return AdamState(m=zeros, v=tree_map(torch.zeros_like, params),
                     t=torch.zeros((), dtype=torch.int32,
                                   device=tree_leaves(params)[0].device))


@torch.no_grad()
def adam_update(params: Any, grads: Any, state: AdamState, *, lr,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0, grad_clip: float = 0.0,
                inplace: bool = False):
    """One Adam(W) step; returns (new_params, new_state).  ``lr`` is a float
    or a float32 scalar tensor (a schedule's).  Pure unless ``inplace``:
    then each parameter and moment is overwritten with its new value, leaf
    by leaf (the same numbers; the LM trainer's way to hold one copy of a
    multi-GB state)."""
    scale = None
    if grad_clip and grad_clip > 0.0:
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                               for g in tree_leaves(grads)) + 1e-12)
        scale = torch.clamp_max(grad_clip / gnorm, 1.0)
    t = state.t + 1
    tf = t.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=tf.device), tf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=tf.device), tf)

    def upd(p, g, mu, nu):
        if scale is not None:
            # the scale is a float32 array in the reference, so a
            # half-precision gradient comes out of the product in float32
            g = (g if g.dtype == torch.float32 else g.float()) * scale
        # (1 - b) * g in g's type with (1 - b) rounded to it first, as JAX
        # takes a Python scalar (weakly typed) beside a bf16 array
        c1, c2 = (torch.tensor(1 - b, dtype=g.dtype, device=g.device)
                  for b in (b1, b2))
        if inplace:
            mu = mu.mul_(b1).add_(c1 * g)
            nu = nu.mul_(b2).add_(c2 * torch.square(g))
        else:
            mu = b1 * mu + c1 * g
            nu = b2 * nu + c2 * torch.square(g)
        step = lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        if weight_decay:
            step = step + lr * weight_decay * p.to(step.dtype)
        new = (p.to(step.dtype) - step).to(p.dtype)
        return (p.copy_(new) if inplace else new), mu, nu

    out = tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), AdamState(m=pick(1), v=pick(2), t=t)
