"""Reward function (paper §3.10, Eqs. 34-44; port of ``repro.core.reward``).

R(s,a) = alpha*P_norm - beta*P_power - gamma*A_norm + B_feasible
         - P_violation - P_memory - P_hazard

Normalization ranges are ADAPTIVE (Eq. 35-37): running min/max over the
metrics observed this run, seeded from the node budgets.  The scalar
engine keeps them in a host :class:`RewardModel` (numpy, a copy of the
reference's); the batched engine threads them through its step as a (B, 6)
tensor [perf_lo, perf_hi, power_lo, power_hi, area_lo, area_hi].  The SLO
helpers of the scenario engine (:func:`resolve_slo`, :func:`ttft_ms`,
:func:`slo_objective`) are host code, copies of the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
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


@dataclasses.dataclass
class RunningRange:
    lo: float
    hi: float

    def update(self, x: float) -> None:
        self.lo = min(self.lo, x)
        self.hi = max(self.hi, x)

    def norm(self, x: float) -> float:
        return (x - self.lo) / max(self.hi - self.lo, 1e-9)


@dataclasses.dataclass
class RewardModel:
    """Stateful reward with adaptive normalisation ranges (the scalar
    engine's; host numpy)."""
    power_budget_mw: float
    area_budget_mm2: float
    w_perf: float = 0.4
    w_power: float = 0.4
    w_area: float = 0.2

    def __post_init__(self) -> None:
        self.alpha, self.beta, self.gamma = adaptive_weights(
            self.w_perf, self.w_power, self.w_area)
        # seed ranges from node budgets (paper §3.10 note)
        self.perf_rng = RunningRange(0.0, 1.0)
        self.power_rng = RunningRange(0.0, self.power_budget_mw)
        self.area_rng = RunningRange(0.0, self.area_budget_mm2)

    def __call__(self, metrics: np.ndarray) -> Tuple[float, Dict[str, float]]:
        m = lambda n: float(metrics[M_IDX[n]])
        perf, power, area = m("perf_gops"), m("power_mw"), m("area_mm2")
        self.perf_rng.update(perf)
        self.power_rng.update(power)
        self.area_rng.update(area)

        p_norm = self.perf_rng.norm(perf)                           # Eq. 35
        p_power = self.power_rng.norm(power)                        # Eq. 36
        a_norm = self.area_rng.norm(area)                           # Eq. 37

        feasible = m("feasible") > 0.5
        m_pwr = (self.power_budget_mw - power) / self.power_budget_mw
        b_feas = S_MAG * (1.0 + max(m_pwr, 0.0)) if feasible else 0.0  # Eq. 38

        v = max(0.0, (power - self.power_budget_mw) / self.power_budget_mw)
        p_viol = S_MAG * (1.0 + v) * v ** 2                          # Eq. 39
        p_mem = LAMBDA_MEM * max(0.0, m("mem_overuse_mb"))           # Eq. 40
        p_haz = LAMBDA_HAZARD * m("hazard")                          # Eq. 41

        r = (self.alpha * p_norm - self.beta * p_power - self.gamma * a_norm
             + b_feas - p_viol - p_mem - p_haz)                      # Eq. 34
        r = float(np.clip(r, -5.0, 3.0))   # Table 4 typical range
        return r, dict(p_norm=p_norm, p_power=p_power, a_norm=a_norm,
                       b_feas=b_feas, p_viol=p_viol, p_mem=p_mem,
                       p_haz=p_haz, reward=r)


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


# ---------------------------------------------------------------------------
# SLO-aware phase combination (scenario engine).
#
# A serving scenario pairs the decode-phase search workload with a prefill
# evaluation of the same design: TTFT comes from prefill throughput,
# steady-state tokens/s from decode.  Targets are per-mode; the combined
# objective prefers SLO-feasible candidates and hinge-penalises misses, so
# when no archive entry meets the SLO the least-violating design still wins.

DEFAULT_SLOS = {
    "high_perf": {"ttft_ms": 500.0, "tok_s": 30.0},
    "low_power": {"ttft_ms": 2000.0, "tok_s": 10.0},
}


def resolve_slo(slo_spec, mode: str) -> Dict[str, float]:
    """Normalise a campaign ``slo`` spec to ``{'ttft_ms', 'tok_s'}``.

    Accepts ``None``/``{}`` (per-mode defaults), a flat
    ``{"ttft_ms": ..., "tok_s": ...}`` applied to every mode, or a
    per-mode mapping ``{"high_perf": {...}, "low_power": {...}}``."""
    base = dict(DEFAULT_SLOS.get(mode, DEFAULT_SLOS["high_perf"]))
    if slo_spec:
        if any(k in DEFAULT_SLOS for k in slo_spec):
            base.update(slo_spec.get(mode) or {})
        else:
            base.update(slo_spec)
    return {k: float(v) for k, v in base.items()}


def ttft_ms(prefill_tok_s: float, seq_len: float, batch: float) -> float:
    """Time-to-first-token: the prompt's seq_len*batch tokens pushed
    through the design's prefill-phase throughput."""
    return 1e3 * seq_len * batch / max(float(prefill_tok_s), 1e-9)


def slo_objective(ppa_score: float, tok_s: float, ttft: float,
                  slo: Dict[str, float]) -> float:
    """Combined selection objective (lower = better): the decode-phase
    ppa_score plus hinge penalties for missing either SLO target."""
    miss = 0.0
    if slo.get("tok_s"):
        miss += max(0.0, 1.0 - tok_s / slo["tok_s"])
    if slo.get("ttft_ms"):
        miss += max(0.0, ttft / slo["ttft_ms"] - 1.0)
    return float(ppa_score) + miss
