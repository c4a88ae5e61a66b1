"""Learned PPA surrogate with the Eq. 66-67 uncertainty gate (paper §3.15;
port of ``repro.ppa.surrogate``).

An MLP [82 -> 128 -> 64 -> 3] maps (state, action) to log1p-space (power,
perf, area) estimates, trained online from evaluated transitions.
:func:`screen_batch` scores K candidate actions per env through
``kernels.screen_score`` (the CUDA kernel on the card) and picks the
surrogate-best where a cell's gate is open.  The serving-side
``fit_index_surrogate`` / ``score_query_batch`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.networks import gelu
from repro_torch.kernels import screen_score
from repro_torch.optim.adam import tree_leaves, tree_map
from repro_torch.ppa.analytic import M_IDX

SUR_HIDDEN = (128, 64)
N_TARGETS = 3  # power, perf, area  (Eq. 61)
TARGET_NAMES = ("power_mw", "perf_gops", "area_mm2")
TAU_SUR_DEFAULT = 0.05
SUR_LR = 1.5e-4


def init_params(gen: torch.Generator, in_dim: int, device="cpu",
                hidden: Tuple[int, int] = SUR_HIDDEN) -> Dict:
    h1, h2 = hidden

    def dense(n_in, n_out):
        return dict(w=torch.randn((n_in, n_out), generator=gen)
                    * float(np.sqrt(2.0 / n_in)),
                    b=torch.zeros((n_out,)))

    p = dict(l1=dense(in_dim, h1), l2=dense(h1, h2),
             head=dense(h2, N_TARGETS))
    return tree_map(lambda t: t.to(device), p)


def predict(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: [..., in_dim] -> [..., 3] log1p-space (power, perf, area)."""
    h = gelu(x @ params["l1"]["w"] + params["l1"]["b"])
    h = gelu(h @ params["l2"]["w"] + params["l2"]["b"])
    return h @ params["head"]["w"] + params["head"]["b"]


def targets_from_metrics(metrics: torch.Tensor) -> torch.Tensor:
    cols = torch.stack([metrics[..., M_IDX[n]] for n in TARGET_NAMES], dim=-1)
    return torch.log1p(torch.clamp_min(cols, 0.0))


def loss_fn(params: Dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sum((predict(params, x) - y) ** 2, dim=-1))


def init_opt(params: Dict) -> Dict:
    dev = tree_leaves(params)[0].device
    return dict(m=tree_map(torch.zeros_like, params),
                v=tree_map(torch.zeros_like, params),
                t=torch.zeros((), dtype=torch.float32, device=dev))


def train_step(params: Dict, opt_state: Dict, x: torch.Tensor,
               y: torch.Tensor, lr: float = SUR_LR
               ) -> Tuple[Dict, Dict, torch.Tensor]:
    """One Adam step on the surrogate loss (Eq. 65), the reference's own
    inline Adam (no clip, float32 step count)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(p, x, y)
        it = iter(torch.autograd.grad(loss, tree_leaves(p)))
    grads = tree_map(lambda _: next(it), p)
    with torch.no_grad():
        m = tree_map(lambda mu, g: 0.9 * mu + 0.1 * g, opt_state["m"], grads)
        v = tree_map(lambda nu, g: 0.999 * nu + 0.001 * g * g,
                     opt_state["v"], grads)
        t = opt_state["t"] + 1
        c1 = 1 - torch.pow(torch.tensor(0.9, device=t.device), t)
        c2 = 1 - torch.pow(torch.tensor(0.999, device=t.device), t)
        new = tree_map(lambda q, mu, nu: q - lr * (mu / c1)
                       / (torch.sqrt(nu / c2) + 1e-8), params, m, v)
    return new, dict(m=m, v=v, t=t), loss.detach()


@dataclasses.dataclass
class Surrogate:
    """Stateful wrapper with the Eq. 66-67 uncertainty gate."""
    params: Dict
    opt_state: Dict
    tau_sur: float = TAU_SUR_DEFAULT
    resid_var: float = float("inf")   # sigma_psi^2, running (Eq. 66)
    n_updates: int = 0

    @classmethod
    def create(cls, in_dim: int, seed: int = 0, device="cpu",
               tau_sur: float = TAU_SUR_DEFAULT,
               hidden: Tuple[int, int] = SUR_HIDDEN) -> "Surrogate":
        p = init_params(torch.Generator().manual_seed(int(seed)), in_dim,
                        device, hidden=hidden)
        return cls(params=p, opt_state=init_opt(p), tau_sur=tau_sur)

    @property
    def device(self) -> torch.device:
        return self.params["l1"]["w"].device

    def update(self, x: np.ndarray, metrics: np.ndarray) -> float:
        dev = self.device
        y = targets_from_metrics(torch.as_tensor(metrics, device=dev))
        self.params, self.opt_state, loss = train_step(
            self.params, self.opt_state, torch.as_tensor(x, device=dev), y)
        loss = float(loss)
        # running residual variance (Eq. 66); non-finite losses skipped
        var = loss / N_TARGETS
        if np.isfinite(var):
            self.resid_var = var if not np.isfinite(self.resid_var) else (
                0.95 * self.resid_var + 0.05 * var)
        self.n_updates += 1
        return loss

    @property
    def accepted(self) -> bool:
        """Eq. 67: 1[sigma^2 < tau_sur]."""
        return self.resid_var < self.tau_sur

    @torch.no_grad()
    def __call__(self, x: np.ndarray) -> np.ndarray:
        """Predict (power_mw, perf_gops, area_mm2) in linear space."""
        out = torch.expm1(predict(self.params,
                                  torch.as_tensor(x, device=self.device)))
        return out.cpu().numpy()


def surrogate_reward(pred_log: torch.Tensor) -> torch.Tensor:
    """r_sur = P_perf - 0.3 P_pwr - 0.2 P_area (paper §3.16 MPC reward),
    on log1p-scaled heads."""
    return pred_log[..., 1] - 0.3 * pred_log[..., 0] - 0.2 * pred_log[..., 2]


@torch.no_grad()
def screen_batch(params: Dict, s: torch.Tensor, cand: torch.Tensor,
                 weights: torch.Tensor, open_mask: torch.Tensor
                 ) -> torch.Tensor:
    """Score K candidate actions per env and pick the surrogate-best.

    s (B, 52); cand (B, K, 30), candidate 0 being the ungated action;
    weights (B, 3) normalized (w_perf, w_power, w_area); open_mask (B,)
    bool.  Where the gate is closed the pick is 0, so a closed gate is
    exactly the ungated action stream."""
    score = screen_score.screen_scores(params, s, cand, weights)
    pick = torch.argmin(score, dim=1)
    return torch.where(open_mask, pick, torch.zeros_like(pick))


@torch.no_grad()
def calib_errors(params: Dict, x: torch.Tensor,
                 metrics: torch.Tensor) -> torch.Tensor:
    """Per-sample surrogate residual (Eq. 66 numerator): (B,) mean squared
    error over the 3 log1p targets."""
    return torch.mean((predict(params, x) - targets_from_metrics(metrics))
                      ** 2, dim=-1)


@dataclasses.dataclass
class ScreenGate:
    """Per-cell Eq.-66/67 gate state for surrogate-gated screening (host
    numpy, as in the reference): one EMA residual variance per cell; a
    cell's gate opens — and stays open — the first time it drops below
    ``tau``."""
    tau: float
    resid_var: np.ndarray      # (n_cells,) EMA residual variance, init inf
    open_at: np.ndarray        # (n_cells,) env-step the gate opened; -1 closed
    screened: np.ndarray       # (n_cells,) candidates scored
    evaluated: np.ndarray      # (n_cells,) full analytic evaluations
    ema: float = 0.95

    @classmethod
    def create(cls, n_cells: int, tau: float = TAU_SUR_DEFAULT
               ) -> "ScreenGate":
        return cls(tau=float(tau),
                   resid_var=np.full(n_cells, np.inf, np.float64),
                   open_at=np.full(n_cells, -1, np.int64),
                   screened=np.zeros(n_cells, np.int64),
                   evaluated=np.zeros(n_cells, np.int64))

    @property
    def open(self) -> np.ndarray:
        return self.open_at >= 0

    def observe(self, err_per_cell: np.ndarray, t_env: int) -> None:
        """Fold one dispatch's per-cell calibration error into the EMA and
        open any cell whose variance just passed below tau; non-finite
        errors are skipped for that cell."""
        err = np.asarray(err_per_cell, np.float64)
        finite = np.isfinite(err)
        first = ~np.isfinite(self.resid_var)
        upd = np.where(first, err,
                       self.ema * self.resid_var + (1.0 - self.ema) * err)
        self.resid_var = np.where(finite, upd, self.resid_var)
        newly = (~self.open) & (self.resid_var < self.tau)
        self.open_at[newly] = t_env

    def count(self, lanes: int, k: int) -> None:
        self.evaluated += lanes
        self.screened += np.where(self.open, lanes * k, lanes)

    def to_dict(self) -> Dict:
        return dict(tau=self.tau, ema=self.ema,
                    resid_var=[float(v) for v in self.resid_var],
                    open_at=self.open_at.tolist(),
                    screened=self.screened.tolist(),
                    evaluated=self.evaluated.tolist())

    @classmethod
    def from_dict(cls, d: Dict) -> "ScreenGate":
        return cls(tau=float(d["tau"]), ema=float(d["ema"]),
                   resid_var=np.array([float(v) for v in d["resid_var"]],
                                      np.float64),
                   open_at=np.asarray(d["open_at"], np.int64),
                   screened=np.asarray(d["screened"], np.int64),
                   evaluated=np.asarray(d["evaluated"], np.int64))
