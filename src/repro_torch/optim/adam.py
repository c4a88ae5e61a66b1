"""Functional Adam on dicts of tensors (port of ``repro.optim.adam``).

Same update as the reference, op for op: optional global-norm gradient
clip ``min(1, clip / sqrt(sum g^2 + 1e-12))``, then the moment updates and
float32 bias corrections ``1 - b**t``.  (``torch.optim.Adam`` differs: it
has no global clip and folds the bias corrections into the step size.)
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
def adam_update(params: Any, grads: Any, state: AdamState, *, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                grad_clip: float = 0.0):
    """One Adam step; returns (new_params, new_state).  Pure: nothing is
    updated in place."""
    if grad_clip and grad_clip > 0.0:
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                               for g in tree_leaves(grads)) + 1e-12)
        scale = torch.clamp_max(grad_clip / gnorm, 1.0)
        grads = tree_map(lambda g: g * scale, grads)
    t = state.t + 1
    m = tree_map(lambda mu, g: b1 * mu + (1 - b1) * g, state.m, grads)
    v = tree_map(lambda nu, g: b2 * nu + (1 - b2) * torch.square(g),
                 state.v, grads)
    tf = t.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=tf.device), tf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=tf.device), tf)

    def upd(p, mu, nu):
        return p - lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)

    return tree_map(upd, params, m, v), AdamState(m=m, v=v, t=t)
