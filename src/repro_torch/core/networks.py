"""Policy / critic / world-model networks (paper §3.4, §3.11, §3.15,
§3.16; port of ``repro.core.networks``).

Parameters are plain nested dicts of tensors with the reference pytree's
keys, shapes and layouts, so ``repro_torch.convert`` carries weights across
unchanged.  Initialisation draws from a CPU ``torch.Generator`` seeded by
the caller and moves the result to ``device``, so a seed gives the same
weights on every device (not the reference's ``jax.random`` numbers).

Sampling takes its noise explicitly (``PolicyNoise``): a standard normal
for the tanh-Gaussian and Gumbel noise for the categorical (the Gumbel-max
form of ``jax.random.categorical``), so tests can feed the reference's own
draws.  :func:`draw_policy_noise` makes them from a ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.actions import N_CONT, N_DISC, N_DISC_OPTIONS
from repro_torch.core.state import SAC_STATE_DIM
from repro_torch.kernels import policy_mlp
from repro_torch.kernels.actor_moe import actor_forward_plain

HIDDEN = 256
WM_HIDDEN = (128, 64)
N_EXPERTS = 4
LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
MOE_LB_COEF = 1e-2  # lambda_lb of Eq. 55


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def _dense(gen: torch.Generator, n_in: int, n_out: int, scale=None,
           lead=()) -> Dict:
    scale = scale if scale is not None else math.sqrt(2.0 / n_in)
    return dict(w=torch.randn((*lead, n_in, n_out), generator=gen) * scale,
                b=torch.zeros((*lead, n_out)))


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# ----------------------------------------------------------------- actor --
def actor_init(gen: torch.Generator, device="cpu",
               state_dim: int = SAC_STATE_DIM,
               n_experts: int = N_EXPERTS) -> Dict:
    e = (n_experts,)
    p = dict(
        l1=_dense(gen, state_dim, HIDDEN, lead=e),
        l2=_dense(gen, HIDDEN, HIDDEN, lead=e),
        disc=_dense(gen, HIDDEN, N_DISC * N_DISC_OPTIONS, 1e-2, lead=e),
        mu=_dense(gen, HIDDEN, N_CONT, 1e-2, lead=e),
        log_std=_dense(gen, HIDDEN, N_CONT, 1e-2, lead=e),
        gate=torch.randn((state_dim, n_experts), generator=gen) * 0.01,
    )
    return to_device(p, device)


def actor_forward(params: Dict, s: torch.Tensor,
                  forward=actor_forward_plain):
    """Actor: s [B, 52] -> (disc_logits [B,4,5], mu [B,30], log_std [B,30],
    gate probs [B,K]).  ``forward`` computes the flat heads: the plain
    (differentiable) version by default, ``kernels.actor_moe.actor_forward``
    to act through the kernel."""
    disc, mu, log_std, g = forward(params, s)
    return disc.reshape(s.shape[0], N_DISC, N_DISC_OPTIONS), mu, log_std, g


class PolicyNoise(NamedTuple):
    normal: torch.Tensor    # [B, 30]
    gumbel: torch.Tensor    # [B, 4, 5]


def draw_policy_noise(b: int, gen: torch.Generator,
                      device) -> PolicyNoise:
    normal = torch.randn((b, N_CONT), generator=gen, device=device)
    u = torch.rand((b, N_DISC, N_DISC_OPTIONS), generator=gen, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return PolicyNoise(normal, -torch.log(-torch.log(u)))


def sample_actions(params: Dict, s: torch.Tensor, noise: PolicyNoise):
    """Reparameterised tanh-Gaussian (cont) + Gumbel-max categorical (disc)
    through the plain actor (the learner's differentiable path).

    Returns (a_cont [B,30], a_disc [B,4] int64, logp_cont [B],
    logp_disc [B], gate [B,K], disc_logits [B,4,5])."""
    disc_logits, mu, log_std, gate = actor_forward(params, s)
    eps = noise.normal
    a = torch.tanh(mu + torch.exp(log_std) * eps)
    base_logp = (-0.5 * (eps ** 2) - log_std
                 - 0.5 * math.log(2 * math.pi)).sum(-1)
    logp_c = base_logp - torch.log(1 - a ** 2 + 1e-6).sum(-1)
    a_d = torch.argmax(disc_logits + noise.gumbel, dim=-1)           # Eq. 6-7
    logp_d = (F.log_softmax(disc_logits, -1)
              * F.one_hot(a_d, N_DISC_OPTIONS)).sum(-1).sum(-1)
    return a, a_d, logp_c, logp_d, gate, disc_logits


def moe_balance_loss(gate: torch.Tensor,
                     n_experts: int = N_EXPERTS) -> torch.Tensor:
    """Eq. 55: lambda_lb * K * sum_k mean_b(g_k)^2."""
    gbar = gate.mean(dim=0)
    return MOE_LB_COEF * n_experts * torch.sum(gbar ** 2)


# ---------------------------------------------------------------- critics --
def critic_init(gen: torch.Generator, device="cpu",
                state_dim: int = SAC_STATE_DIM) -> Dict:
    return to_device(dict(l1=_dense(gen, state_dim + N_CONT, HIDDEN),
                          l2=_dense(gen, HIDDEN, HIDDEN),
                          out=_dense(gen, HIDDEN, 1, 1e-2)), device)


def critic_forward(params: Dict, s: torch.Tensor,
                   a_cont: torch.Tensor) -> torch.Tensor:
    x = torch.cat([s, a_cont], dim=-1)
    h = gelu(x @ params["l1"]["w"] + params["l1"]["b"])
    h = gelu(h @ params["l2"]["w"] + params["l2"]["b"])
    return (h @ params["out"]["w"] + params["out"]["b"]).squeeze(-1)


# ------------------------------------------------------------ world model --
def world_model_init(gen: torch.Generator, device="cpu",
                     state_dim: int = SAC_STATE_DIM) -> Dict:
    return to_device(dict(l1=_dense(gen, state_dim + N_CONT, WM_HIDDEN[0]),
                          l2=_dense(gen, WM_HIDDEN[0], WM_HIDDEN[1]),
                          out=_dense(gen, WM_HIDDEN[1], state_dim, 1e-2)),
                     device)


def world_model_forward(params: Dict, s: torch.Tensor,
                        a: torch.Tensor) -> torch.Tensor:
    """Predict next state via residual delta (Eq. 69): s' = s + f([s;a])."""
    x = torch.cat([s, a], dim=-1)
    h = gelu(x @ params["l1"]["w"] + params["l1"]["b"])
    h = gelu(h @ params["l2"]["w"] + params["l2"]["b"])
    return s + (h @ params["out"]["w"] + params["out"]["b"])


def world_model_step(params: Dict, s: torch.Tensor,
                     a: torch.Tensor) -> torch.Tensor:
    """:func:`world_model_forward` for inference (the MPC rollouts):
    ``s + fused_mlp([s; a])`` through the ``fused_mlp`` kernel; no
    gradient."""
    return s + policy_mlp.mlp(params, torch.cat([s, a], dim=-1), "out")
