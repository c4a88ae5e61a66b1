"""Soft Actor-Critic with twin Q, entropy auto-tuning and PER weighting
(paper §3.11, Table 5/6; port of ``repro.core.sac``).

The critics see only the continuous action (82 = 52 + 30); the 4 discrete
mesh/SC heads are trained with a policy gradient on the TD advantage.
:func:`update` takes gradients with autograd through the plain actor, as
the reference differentiates its jnp actor.  Acting
(:func:`policy_act_batch`) runs the actor through ``kernels.actor_moe``: the
CUDA kernel on the card, the plain version on the CPU.

Device noise is an explicit argument (``noise``) or is drawn from the
``torch.Generator`` passed as ``gen``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import networks as nets
from repro_torch.core.actions import N_CONT, N_DISC, N_DISC_OPTIONS
from repro_torch.kernels import actor_moe
from repro_torch.optim.adam import (AdamState, adam_init, adam_update,
                                   tree_leaves, tree_map)

LR = 3e-4                 # actor / critic / alpha (Table 6)
GAMMA = 0.99
TAU = 0.005
TARGET_ENTROPY = -float(N_CONT)   # -30 (Table 6)
INIT_ALPHA = 0.2


class SACParams(NamedTuple):
    actor: Dict
    q1: Dict
    q2: Dict
    q1_targ: Dict
    q2_targ: Dict
    log_alpha: torch.Tensor


class SACOpt(NamedTuple):
    actor: AdamState
    q1: AdamState
    q2: AdamState
    alpha: AdamState


class SACState(NamedTuple):
    params: SACParams
    opt: SACOpt
    step: torch.Tensor


class Batch(NamedTuple):
    s: torch.Tensor        # [B, 52]
    a_cont: torch.Tensor   # [B, 30]
    a_disc: torch.Tensor   # [B, 4] int
    r: torch.Tensor        # [B]
    s2: torch.Tensor       # [B, 52]
    done: torch.Tensor     # [B]
    is_w: torch.Tensor     # [B] PER importance weights


class UpdateNoise(NamedTuple):
    """The two normal draws an update consumes: for the next-state target
    actions and for the actor loss (the Gumbel draws of the reference's
    samples there never reach a loss, so they are not needed)."""
    next_normal: torch.Tensor   # [B, 30]
    pi_normal: torch.Tensor     # [B, 30]


def create(seed: int = 0, device="cpu") -> SACState:
    gen = torch.Generator().manual_seed(int(seed))
    actor = nets.actor_init(gen, device)
    q1 = nets.critic_init(gen, device)
    q2 = nets.critic_init(gen, device)
    params = SACParams(
        actor=actor, q1=q1, q2=q2,
        q1_targ=tree_map(torch.clone, q1), q2_targ=tree_map(torch.clone, q2),
        log_alpha=torch.log(torch.tensor(INIT_ALPHA, dtype=torch.float32,
                                         device=device)))
    opt = SACOpt(actor=adam_init(actor), q1=adam_init(q1), q2=adam_init(q2),
                 alpha=adam_init(params.log_alpha))
    return SACState(params=params, opt=opt,
                    step=torch.zeros((), dtype=torch.int32, device=device))


def _requires_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _grads(loss, tree):
    it = iter(torch.autograd.grad(loss, tree_leaves(tree)))
    return tree_map(lambda _: next(it), tree)


def update(state: SACState, batch: Batch, *,
           noise: Optional[UpdateNoise] = None,
           gen: Optional[torch.Generator] = None,
           return_grads: bool = False):
    """One SAC step.  Returns (new_state, |td_error| for PER, metrics), and
    the gradients (q1, q2, actor, log_alpha) after them when
    ``return_grads``."""
    p = state.params
    b = batch.s.shape[0]
    dev = batch.s.device
    if noise is None:
        noise = UpdateNoise(
            torch.randn((b, N_CONT), generator=gen, device=dev),
            torch.randn((b, N_CONT), generator=gen, device=dev))
    zero_g = torch.zeros((b, N_DISC, N_DISC_OPTIONS), device=dev)
    alpha = torch.exp(p.log_alpha).detach()

    # ---- critic targets (Eq. 46/59): clipped double-Q with entropy term --
    with torch.no_grad():
        a2, _, logp2_c, _, _, _ = nets.sample_actions(
            p.actor, batch.s2, nets.PolicyNoise(noise.next_normal, zero_g))
        q_next = torch.minimum(nets.critic_forward(p.q1_targ, batch.s2, a2),
                               nets.critic_forward(p.q2_targ, batch.s2, a2))
        y = batch.r + GAMMA * (1.0 - batch.done) * (q_next - alpha * logp2_c)

    def critic_step(q_params, opt):
        qp = _requires_grad(q_params)
        with torch.enable_grad():
            q = nets.critic_forward(qp, batch.s, batch.a_cont)
            td = q - y
            loss = torch.mean(batch.is_w * td ** 2)
            g = _grads(loss, qp)
        new, new_opt = adam_update(q_params, g, opt, lr=LR, grad_clip=10.0)
        return new, new_opt, loss.detach(), td.detach(), g

    q1_new, opt_q1, l_q1, td1, g1 = critic_step(p.q1, state.opt.q1)
    q2_new, opt_q2, l_q2, td2, g2 = critic_step(p.q2, state.opt.q2)

    # ---- actor (Eq. 58) + discrete-head policy gradient + MoE balance ----
    ap = _requires_grad(p.actor)
    with torch.enable_grad():
        a, _, logp_c, _, gate, disc_logits = nets.sample_actions(
            ap, batch.s, nets.PolicyNoise(noise.pi_normal, zero_g))
        q_pi = torch.minimum(nets.critic_forward(q1_new, batch.s, a),
                             nets.critic_forward(q2_new, batch.s, a))
        loss_cont = torch.mean(alpha * logp_c - q_pi)
        # discrete: REINFORCE on stored actions with TD advantage (§3.15)
        log_pd = F.log_softmax(disc_logits, -1)
        onehot = F.one_hot(batch.a_disc.long(), N_DISC_OPTIONS).to(log_pd.dtype)
        logp_stored = (log_pd * onehot).sum(-1).sum(-1)
        v_s = (q_pi - alpha * logp_c).detach()
        adv = (batch.r + GAMMA * (1 - batch.done)
               * (q_next - alpha * logp2_c) - v_s).detach()
        loss_disc = -torch.mean(batch.is_w * logp_stored * adv)
        disc_entropy = -torch.mean(torch.sum(
            torch.softmax(disc_logits, -1) * log_pd, dim=(-2, -1)))
        lb = nets.moe_balance_loss(gate)
        l_actor = loss_cont + 0.5 * loss_disc - 1e-3 * disc_entropy + lb
        ga = _grads(l_actor, ap)
    logp_c = logp_c.detach()
    actor_new, opt_a = adam_update(p.actor, ga, state.opt.actor, lr=LR,
                                   grad_clip=10.0)

    # ---- entropy temperature (Eq. 45/60), log-alpha bounded [-10, 10] ----
    la = p.log_alpha.detach().requires_grad_(True)
    with torch.enable_grad():
        l_al = -torch.mean(torch.exp(la) * (logp_c + TARGET_ENTROPY))
        (g_al,) = torch.autograd.grad(l_al, [la])
    g_al = torch.clamp(g_al, -1.0, 1.0)
    log_alpha_new, opt_al = adam_update(p.log_alpha, g_al, state.opt.alpha,
                                        lr=LR)
    log_alpha_new = torch.clamp(log_alpha_new, -10.0, 10.0)

    # ---- polyak target update (tau = 0.005) -------------------------------
    polyak = lambda t, s: tree_map(lambda x, y: (1 - TAU) * x + TAU * y, t, s)
    with torch.no_grad():
        new_params = SACParams(actor=actor_new, q1=q1_new, q2=q2_new,
                               q1_targ=polyak(p.q1_targ, q1_new),
                               q2_targ=polyak(p.q2_targ, q2_new),
                               log_alpha=log_alpha_new)
    new_state = SACState(params=new_params,
                         opt=SACOpt(actor=opt_a, q1=opt_q1, q2=opt_q2,
                                    alpha=opt_al),
                         step=state.step + 1)
    td_abs = 0.5 * (torch.abs(td1) + torch.abs(td2))
    metrics = dict(loss_q1=l_q1, loss_q2=l_q2, loss_actor=l_actor.detach(),
                   loss_alpha=l_al.detach(), alpha=torch.exp(log_alpha_new),
                   entropy=-torch.mean(logp_c), moe_lb=lb.detach())
    if return_grads:
        return new_state, td_abs, metrics, dict(q1=g1, q2=g2, actor=ga,
                                                log_alpha=g_al)
    return new_state, td_abs, metrics


@torch.no_grad()
def policy_act_batch(actor_params: Dict, s: torch.Tensor, *,
                     noise: Optional[nets.PolicyNoise] = None,
                     gen: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample actions for a (B, 52) batch of env states — the act path of
    the vectorised engine.  The MoE forward runs through
    ``kernels.actor_moe`` (the CUDA kernel for a CUDA tensor)."""
    if noise is None:
        noise = nets.draw_policy_noise(s.shape[0], gen, s.device)
    disc_logits, mu, log_std, _ = nets.actor_forward(
        actor_params, s, actor_moe.actor_forward)
    a = torch.tanh(mu + torch.exp(log_std) * noise.normal)
    a_d = torch.argmax(disc_logits + noise.gumbel, dim=-1)
    return a, a_d
