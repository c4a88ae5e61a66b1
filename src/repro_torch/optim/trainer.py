"""LM trainer (port of ``repro.optim.trainer``): AdamW with global-norm
clipping, a warmup + cosine schedule and microbatch accumulation.

A step updates the parameters and the moments in place (the reference's
numbers; one copy of the state, where a functional update would hold
two).  On a mesh the parameters are DTensors: the moments take each
parameter's placements (the reference shards them by the same rules, so
the Adam state is fully FSDP'd), the update runs on the local shards, the
global-norm clip sums over the whole sharded tree, and a ``Shard(0)``
batch is split into microbatches by global rows, as the reference's
reshape splits it.  Run it inside ``repro_torch.launch.mesh.mesh_context``
then (the step count and the schedule stay plain tensors, replicated).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.optim.adam import AdamState, adam_update, tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: AdamState
    step: torch.Tensor    # int32 scalar


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    microbatches: int = 1     # gradient accumulation splits


def lr_schedule(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to 10%, in float32 as the reference
    computes it."""
    step = step.to(torch.float32)
    warm = torch.clamp_max((step + 1.0) / max(1, tc.warmup_steps), 1.0)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(1, tc.total_steps - tc.warmup_steps), 0.0, 1.0)
    cos = 0.1 + 0.9 * 0.5 * (1.0 + torch.cos(
        torch.tensor(math.pi, dtype=torch.float32, device=step.device)
        * prog))
    return tc.lr * warm * cos


def create_state(params: Any) -> TrainState:
    """Zero float32 Adam moments, whatever the parameters' type, each with
    its parameter's placements when the parameters are DTensors."""
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32,
                                       memory_format=torch.contiguous_format)
    opt = AdamState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    t=torch.zeros((), dtype=torch.int32, device=dev))
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _value_and_grad(loss_fn, params, batch):
    leaves = tree_leaves(params)
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    it = iter(grads)
    assert len(grads) == len(leaves)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(cfg: ArchConfig, tc: TrainConfig,
                    loss_fn: Optional[Callable] = None):
    """Returns train_step(state, batch) -> (state, metrics).

    batch: dict(tokens [B,S], labels [B,S], ctx optional), on the
    parameters' device.  Microbatching splits the batch on axis 0 and
    accumulates the gradients in float32, in a loop where the reference
    scans.  metrics: loss, lr and grad_norm (float32 scalars).  The given
    state's tensors are updated in place and returned in the new state."""
    loss_fn = loss_fn or (lambda p, b: lm.loss_fn(
        p, cfg, b["tokens"], b["labels"], b.get("ctx")))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if tc.microbatches > 1:
            n = tc.microbatches
            parts = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
                     for k, v in batch.items()}
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            for i in range(n):
                mb = {k: v[i] for k, v in parts.items()}
                l_i, g_i = _value_and_grad(loss_fn, state.params, mb)
                grads = tree_map(lambda a, b_: a + b_.float(), grads, g_i)
                loss = loss + l_i.float()
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)
        else:
            loss, grads = _value_and_grad(loss_fn, state.params, batch)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in tree_leaves(grads)))
        lr = lr_schedule(tc, state.step)
        params, opt = adam_update(
            state.params, grads, state.opt, lr=lr,
            weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
            inplace=True)
        new_state = TrainState(params=params, opt=opt, step=state.step + 1)
        return new_state, dict(loss=loss, lr=lr, grad_norm=gnorm)

    return train_step
