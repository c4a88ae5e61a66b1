"""Reward function (paper §3.10, Eqs. 34-44; port of ``repro.core.reward``).

R(s,a) = alpha*P_norm - beta*P_power - gamma*A_norm + B_feasible
         - P_violation - P_memory - P_hazard

The adaptive normalisation ranges (Eqs. 35-37) are a (B, 6) state tensor
[perf_lo, perf_hi, power_lo, power_hi, area_lo, area_hi] threaded through
the batched step and seeded from the node budgets.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.ppa.analytic import M_IDX, NODE_IDX

S_MAG = 1.0          # score magnitude (Table 4: feasibility bonus in [0,2])
LAMBDA_MEM = 2e-3    # per-MB memory overuse penalty (Eq. 40)
LAMBDA_HAZARD = 0.1  # Eq. 41
RANGE_DIM = 6


def adaptive_weights(w_perf: float, w_power: float, w_area: float
                     ) -> Tuple[float, float, float]:
    """Eqs. 42-44."""
    tot = w_perf + w_power + w_area
    return w_perf / tot, w_power / tot, w_area / tot


def init_ranges(node: torch.Tensor) -> torch.Tensor:
    """Seed (B, 6) running ranges from node budgets (paper §3.10 note)."""
    z = torch.zeros(node.shape[0], dtype=torch.float32, device=node.device)
    return torch.stack([z, torch.ones_like(z),
                        z, node[:, NODE_IDX["power_budget_mw"]],
                        z, node[:, NODE_IDX["area_budget_mm2"]]], dim=-1)


def reward_step(metrics: torch.Tensor, ranges: torch.Tensor,
                node: torch.Tensor, weights: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
    """Eq. 34 over a batch: metrics (B, M_DIM), ranges (B, 6),
    node (B, NODE_DIM), weights (B, 3) normalized (alpha, beta, gamma).
    Returns (reward (B,), new_ranges (B, 6), parts dict of (B,) tensors)."""
    m = lambda n: metrics[:, M_IDX[n]]
    perf, power, area = m("perf_gops"), m("power_mw"), m("area_mm2")
    pb = node[:, NODE_IDX["power_budget_mw"]]

    perf_lo = torch.minimum(ranges[:, 0], perf)
    perf_hi = torch.maximum(ranges[:, 1], perf)
    power_lo = torch.minimum(ranges[:, 2], power)
    power_hi = torch.maximum(ranges[:, 3], power)
    area_lo = torch.minimum(ranges[:, 4], area)
    area_hi = torch.maximum(ranges[:, 5], area)
    new_ranges = torch.stack([perf_lo, perf_hi, power_lo, power_hi,
                              area_lo, area_hi], dim=-1)

    norm = lambda x, lo, hi: (x - lo) / torch.clamp_min(hi - lo, 1e-9)
    p_norm = norm(perf, perf_lo, perf_hi)                            # Eq. 35
    p_power = norm(power, power_lo, power_hi)                        # Eq. 36
    a_norm = norm(area, area_lo, area_hi)                            # Eq. 37

    feasible = m("feasible") > 0.5
    m_pwr = (pb - power) / pb
    b_feas = torch.where(feasible, S_MAG * (1.0 + torch.clamp_min(m_pwr, 0.0)),
                         torch.zeros_like(m_pwr))                    # Eq. 38
    v = torch.clamp_min((power - pb) / pb, 0.0)
    p_viol = S_MAG * (1.0 + v) * v ** 2                              # Eq. 39
    p_mem = LAMBDA_MEM * torch.clamp_min(m("mem_overuse_mb"), 0.0)  # Eq. 40
    p_haz = LAMBDA_HAZARD * m("hazard")                              # Eq. 41

    r = (weights[:, 0] * p_norm - weights[:, 1] * p_power
         - weights[:, 2] * a_norm + b_feas - p_viol - p_mem - p_haz)  # Eq. 34
    r = torch.clamp(r, -5.0, 3.0)
    parts = dict(p_norm=p_norm, p_power=p_power, a_norm=a_norm,
                 b_feas=b_feas, p_viol=p_viol, p_mem=p_mem, p_haz=p_haz,
                 reward=r)
    return r, new_ranges, parts
