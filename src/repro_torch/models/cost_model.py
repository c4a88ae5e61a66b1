"""Persistent learned cost model over campaign archives (port of
``repro.models.cost_model``).

Campaign run directories accumulate measured (serving context, PPA) pairs:
every frontier entry of every (workload, node, mode) cell.  The model has
two heads:

* a **PPA head**, the serving-sized index surrogate (``SERVE_HIDDEN``)
  mapping log1p(workload features || node constants || design vector) ->
  log1p(power, perf, area), fitted on the caller's device (its inference
  runs through the ``fused_mlp`` kernel on a card); and
* an **episodes-to-feasible head**, a closed-form numpy ridge regression
  from the cell context (workload || node half) to log1p of the cell's
  earliest archived episode.  This is the cost behind priority-aware
  packing (``planner.plan`` and ``distrib.shard_batches``).

The episodes head, its data and the donor contexts are pure numpy over
the same extracted features as the reference's, so ``cost_w`` and the
priorities derived from it are bitwise the reference's on the same
archives; only the fitted MLP differs, by float rounding.  Two fits of the
same roots on one device are bitwise equal.  As in the reference,
:func:`dataset` and :func:`cell_contexts` extract each cell's features at
the default phase and dtype (``ArchiveIndex.training_set`` uses each
cell's own).

Persistence: ``save_cost_model`` / ``load_cost_model`` under
``<root>/model/cost/`` with the reference's leaf names
(``sur_params/<layer>/{w,b}``, ``cost_w``), so each package reads the
other's model.  ``holdout_residuals`` is the leave-one-cell-out eval.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import manager as ckpt_mod
from repro_torch.ppa import surrogate as sur_mod
from repro_torch.ppa.surrogate import (SERVE_HIDDEN, Surrogate,
                                       fit_index_surrogate)

#: ridge regularizer for the episodes head (contexts are O(1..30) log1p
#: values and campaigns may hold very few cells)
RIDGE_LAMBDA = 1.0

COST_STEPS_DEFAULT = 300
HOLDOUT_STEPS_DEFAULT = 120


@dataclasses.dataclass
class CostModel:
    """Fitted persistent cost model: ``sur`` predicts log1p (power, perf,
    area) from full serving contexts; ``cost_w`` is the episodes head's
    ridge weights over the bias-augmented cell context; ``meta`` records
    the fit's provenance and full-dataset ``resid_var``."""
    sur: Surrogate
    cost_w: np.ndarray
    meta: Dict

    def predict_ppa(self, x: np.ndarray) -> np.ndarray:
        """(N, in_dim) serving contexts -> (N, 3) linear-space PPA."""
        return self.sur(np.asarray(x, np.float32))

    def predict_episodes(self, ctx: np.ndarray) -> np.ndarray:
        """(N, ctx_dim) cell contexts -> (N,) predicted episodes-to-
        feasible (linear space, floored at 0)."""
        a = _augment(np.asarray(ctx, np.float64))
        z = a @ self.cost_w
        return np.expm1(np.maximum(z, 0.0))


def _augment(ctx: np.ndarray) -> np.ndarray:
    if ctx.ndim == 1:
        ctx = ctx[None]
    return np.concatenate([ctx, np.ones((ctx.shape[0], 1))], axis=1)


def _ridge(a: np.ndarray, z: np.ndarray,
           lam: float = RIDGE_LAMBDA) -> np.ndarray:
    eye = np.eye(a.shape[1])
    eye[-1, -1] = 0.0            # never regularize the bias
    return np.linalg.solve(a.T @ a + lam * eye, a.T @ z)


# ------------------------------------------------------------------ data
def dataset(index) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """``ArchiveIndex.training_set`` at the default phase and dtype, plus
    each row's cell id (the held-out eval's grouping).  Row order: sorted
    cell ids, archive entry order."""
    from repro_torch.launch.recommend import _log1p, split_cell_id
    xs, ys, rows = [], [], []
    for cid in sorted(index.cells):
        arch, node_nm, mode = split_cell_id(cid)
        ctx = index.query_context(index.wl_features(arch), node_nm, mode)
        for e in index.cells[cid].entries:
            xs.append(np.concatenate([ctx, _log1p(e.cfg)]))
            ys.append(np.log1p(np.maximum(
                [e.power_mw, e.perf_gops, e.area_mm2], 0.0)))
            rows.append(cid)
    return (np.asarray(xs, np.float32), np.asarray(ys, np.float32), rows)


def cell_contexts(index) -> Dict[str, np.ndarray]:
    """cell_id -> (WL_DIM + NODE_DIM,) log1p cell context (the episodes
    head's input), at the default phase and dtype."""
    from repro_torch.launch.recommend import split_cell_id
    out = {}
    for cid in sorted(index.cells):
        arch, node_nm, mode = split_cell_id(cid)
        out[cid] = index.query_context(index.wl_features(arch),
                                       node_nm, mode)
    return out


def episodes_to_feasible(index) -> Dict[str, float]:
    """cell_id -> earliest frontier entry's episode stamp."""
    return {cid: float(min(e.episode for e in ar.entries))
            for cid, ar in sorted(index.cells.items()) if len(ar)}


# ------------------------------------------------------------------- fit
def fit_cost_model(index, *, steps: int = COST_STEPS_DEFAULT,
                   seed: int = 0, device="cuda") -> CostModel:
    """Fit both heads from an ``ArchiveIndex``: the PPA head on ``device``,
    the episodes head in numpy."""
    x, y, rows = dataset(index)
    if not len(x):
        raise ValueError("cost model needs at least one archived frontier "
                         "point; run (and reconcile) a campaign first")
    sur = fit_index_surrogate(x, y, steps=steps, seed=seed,
                              hidden=SERVE_HIDDEN, device=device)
    ctxs = cell_contexts(index)
    costs = episodes_to_feasible(index)
    cids = sorted(set(ctxs) & set(costs))
    a = _augment(np.stack([ctxs[c] for c in cids]).astype(np.float64))
    z = np.log1p(np.asarray([max(0.0, costs[c]) for c in cids]))
    cost_w = _ridge(a, z)
    meta = dict(in_dim=int(x.shape[1]), ctx_dim=int(a.shape[1] - 1),
                seed=int(seed), steps=int(steps), n_rows=int(x.shape[0]),
                n_cells=len(cids), cells=cids,
                resid_var=float(sur.resid_var),
                episodes_to_feasible={c: costs[c] for c in cids})
    return CostModel(sur=sur, cost_w=cost_w, meta=meta)


def holdout_residuals(index, *, steps: int = HOLDOUT_STEPS_DEFAULT,
                      seed: int = 0, device="cuda") -> Dict[str, float]:
    """Leave-one-cell-out eval: for each cell, refit the PPA head on every
    other cell's rows and report the mean squared log-space residual on
    the held-out cell (its self-fit residual when there is one cell)."""
    x, y, rows = dataset(index)
    cids = sorted(set(rows))
    rows = np.asarray(rows)
    dev = device_mod.resolve(device)
    out: Dict[str, float] = {}
    for cid in cids:
        held = rows == cid
        rest = ~held if len(cids) > 1 else held
        sur = fit_index_surrogate(x[rest], y[rest], steps=steps, seed=seed,
                                  hidden=SERVE_HIDDEN, device=dev)
        errs = sur_mod._calib_errors_log(
            sur.params, torch.as_tensor(x[held], device=dev),
            torch.as_tensor(y[held], device=dev))
        out[cid] = float(torch.mean(errs))
    return out


# ----------------------------------------------------------- persistence
def cost_dir(root: str) -> str:
    return os.path.join(root, "model", "cost")


def save_cost_model(model: CostModel, root: str) -> str:
    """Persist under ``<root>/model/cost/`` (atomic; one step kept)."""
    return ckpt_mod.save(
        dict(sur_params=model.sur.params, cost_w=model.cost_w),
        cost_dir(root), step=1, keep=1,
        extra=dict(kind="cost_model", **model.meta))


def load_cost_model(root: str, device="cuda") -> Optional[CostModel]:
    """Reload a persisted cost model (either package's) onto ``device``,
    or None if the root has none."""
    d = cost_dir(root)
    if ckpt_mod.latest_step(d) is None:
        return None
    from repro_torch.convert import surrogate_params
    flat, manifest = ckpt_mod.restore_flat(d)
    meta = dict(manifest["extra"])
    meta.pop("kind", None)
    params = surrogate_params(flat, device_mod.resolve(device))
    sur = Surrogate(params=params, opt_state=sur_mod.init_opt(params),
                    resid_var=float(meta.get("resid_var", float("inf"))))
    return CostModel(sur=sur,
                     cost_w=np.asarray(flat["cost_w"], np.float64),
                     meta=meta)
