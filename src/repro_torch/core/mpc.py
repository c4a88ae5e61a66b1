"""Model-predictive planning over the learned world model (paper §3.16;
port of ``repro.core.mpc``), batched over B env states.

K = 64 candidate first actions (policy mean + N(0, 0.3^2) noise, clamped)
are rolled out H = 5 steps through f_omega with policy-mean actions for
k >= 1 and scored by the discounted surrogate PPA reward (Eq. 72).  The
reference vmaps its single-state ``plan`` over the batch; here the batch
axis is written out.  The rollouts go through the kernels, as the
reference's kernel docstrings intend: the actor through ``actor_moe``, the
world-model step and the surrogate reward through ``fused_mlp`` (their
plain versions for CPU tensors).  :func:`refine` blends a plan into the SAC
action on the TCC dims.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import networks as nets
from repro_torch.kernels import actor_moe
from repro_torch.ppa import surrogate as sur

K_CANDIDATES = 64
HORIZON = 5
NOISE_STD = 0.3
GAMMA = 0.99
BLEND_MPC = 0.7           # a_final = 0.7 a_MPC + 0.3 a_SAC (TCC dims)
TCC_ACTION_DIMS = 13


@torch.no_grad()
def plan(actor_params: Dict, wm_params: Dict, sur_params: Dict,
         s: torch.Tensor, *, noise: Optional[torch.Tensor] = None,
         gen: Optional[torch.Generator] = None, k: int = K_CANDIDATES,
         horizon: int = HORIZON) -> torch.Tensor:
    """Best first continuous action [B, 30] for states s [B, 52].

    ``noise``: standard normal [B, k, 30] (scaled by NOISE_STD here), or
    drawn from ``gen`` when None."""
    b = s.shape[0]
    _, mu0, _, _ = nets.actor_forward(actor_params, s,
                                      actor_moe.actor_forward)       # [B, 30]
    if noise is None:
        noise = torch.randn((b, k, mu0.shape[-1]), generator=gen,
                            device=s.device)
    a0 = torch.clamp(mu0[:, None, :] + noise * NOISE_STD, -1.0, 1.0)  # Eq. 70
    s_k = s[:, None, :].expand(b, k, s.shape[-1])
    a_k = a0
    disc = 1.0
    rews = []
    for _ in range(horizon):
        r = sur.surrogate_reward(sur.predict(
            sur_params, torch.cat([s_k, a_k], dim=-1)))               # Eq. 72
        s_k = nets.world_model_step(wm_params, s_k, a_k)              # Eq. 71
        _, mu_next, _, _ = nets.actor_forward(
            actor_params, s_k.reshape(b * k, -1), actor_moe.actor_forward)
        a_k = mu_next.reshape(b, k, -1)
        rews.append(disc * r)
        disc = disc * GAMMA
    g = torch.stack(rews).sum(dim=0)                                 # [B, k]
    best = torch.argmax(g, dim=1)
    return a0[torch.arange(b, device=s.device), best]


def refine(a_sac: torch.Tensor, a_mpc: torch.Tensor) -> torch.Tensor:
    """Blend MPC and SAC actions on the TCC dims (70/30, paper §3.16)."""
    blended = BLEND_MPC * a_mpc + (1.0 - BLEND_MPC) * a_sac
    out = a_sac.clone()
    out[..., :TCC_ACTION_DIMS] = blended[..., :TCC_ACTION_DIMS]
    return out
