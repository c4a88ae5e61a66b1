"""World model f_omega: residual next-state prediction (paper §3.16,
Eq. 69; port of ``repro.core.world_model``).

MLP [82 -> 128 -> 64 -> 52] trained online from replay transitions with
MSE on delta-s at half the critic learning rate.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core import networks as nets
from repro_torch.optim.adam import (AdamState, adam_init, adam_update,
                                    tree_leaves, tree_map)

WM_LR = 1.5e-4   # half the critic LR (paper §3.16)


class WMState(NamedTuple):
    params: Dict
    opt: AdamState
    n_updates: torch.Tensor
    ema_loss: torch.Tensor


def create(seed: int = 0, device="cpu") -> WMState:
    params = nets.world_model_init(torch.Generator().manual_seed(int(seed)),
                                   device)
    return WMState(params=params, opt=adam_init(params),
                   n_updates=torch.zeros((), dtype=torch.int32,
                                         device=device),
                   ema_loss=torch.tensor(float("inf"), device=device))


def train_step(state: WMState, s: torch.Tensor, a: torch.Tensor,
               s2: torch.Tensor) -> Tuple[WMState, torch.Tensor]:
    """MSE on residual delta-s (Eq. 69)."""
    params = tree_map(lambda t: t.detach().requires_grad_(True), state.params)
    with torch.enable_grad():
        loss = torch.mean((nets.world_model_forward(params, s, a) - s2) ** 2)
        it = iter(torch.autograd.grad(loss, tree_leaves(params)))
    grads = tree_map(lambda _: next(it), params)
    loss = loss.detach()
    new_params, opt = adam_update(state.params, grads, state.opt, lr=WM_LR,
                                  grad_clip=10.0)
    ema = torch.where(torch.isinf(state.ema_loss), loss,
                      0.95 * state.ema_loss + 0.05 * loss)
    return WMState(params=new_params, opt=opt,
                   n_updates=state.n_updates + 1, ema_loss=ema), loss


def trained(state: WMState, min_updates: int = 50, max_loss: float = 0.05
            ) -> bool:
    """Is the model good enough to drive MPC? (activation gate, §3.16)."""
    return (int(state.n_updates) >= min_updates
            and float(state.ema_loss) < max_loss)
