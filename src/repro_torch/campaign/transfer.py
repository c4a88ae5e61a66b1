"""Cross-campaign transfer: warm starts, the persistent cost model and batch
priorities (port of ``repro.campaign.transfer``).

A finished campaign leaves three reusable artifacts in its run directory:
per-cell Pareto archives (``cells/*.jsonl``), per-batch final SAC and
surrogate weights (``model/weights/<batch_id>/``) and, once a transfer has
read it, a fitted cost model (``model/cost/``).  ``--transfer-from
<root>`` feeds them into a new campaign:

* **warm start** (:func:`prepare_store` + :func:`load_warm_start`): each
  batch of the new grid is given the nearest completed donor cells by
  workload-feature/node distance across all donor roots, recorded in
  ``manifest["transfer"]``.  When the batch starts, the donor's weights
  seed the SAC and surrogate state and the donor's frontier, re-evaluated
  under the target cell by the analytic model on the batch's device, seeds
  the Pareto archive and the best incumbent.
* **priorities** (:func:`with_transfer`): the cost model's episodes head
  predicts each batch's cost into ``spec.priorities``, which orders
  ``planner.plan``'s execution and ``distrib.shard_batches``' deal.

Donors and priorities are a pure function of the donor stores and the
spec, computed once (``with_transfer`` before the store exists,
``prepare_store`` at its creation), recorded in the spec and manifest and
only read afterwards: fleet workers mirror the top-level record verbatim,
so a W-worker fleet, a W = 1 run and any kill/resume derive the same warm
start (a checkpoint resume bypasses it; the checkpoint holds the warmed
state).  The donor table, ``cost_w`` and the priorities are numpy over the
same extracted features as the reference's, hence bitwise the reference's
on the same donor roots; only the cost model's MLP is fitted on the
device.  As in the reference, donor distances use each workload's features
at the default phase and dtype.
"""
from __future__ import annotations

import dataclasses
import glob
import math
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.campaign.planner import CampaignSpec, CellBatch, plan_cached
from repro_torch.campaign.store import STATUS_DONE, CampaignStore
from repro_torch.checkpoint import manager as ckpt_mod
from repro_torch.core import fsutil

#: additive donor-distance penalty for a mode mismatch: a cross-mode donor
#: is picked only when the pool holds no same-mode cell at all
MODE_PENALTY = 100.0

EVAL_NAME = "eval.json"


# ------------------------------------------------------------- featurize
def _wl_log(arch: str, seq_len: int, batch: int) -> np.ndarray:
    """log1p workload feature vector at given extraction settings (default
    phase and dtype)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.recommend import _log1p
    from repro_torch.workload.extract import extract
    return _log1p(extract(get_config(arch), seq_len=seq_len,
                          batch=batch).features)


def cell_context(arch: str, node_nm: int, mode: str,
                 seq_len: int, batch: int) -> np.ndarray:
    """(WL_DIM + NODE_DIM,) cell context (the episodes head's input), built
    as ``ArchiveIndex.query_context`` but at the target spec's extraction
    settings."""
    from repro_torch.launch.recommend import _log1p
    from repro_torch.ppa.analytic import node_vector
    from repro_torch.ppa.nodes import node_params
    nv = node_vector(node_params(node_nm, low_power=mode != "high_perf"),
                     high_perf=mode == "high_perf")
    return np.concatenate([_wl_log(arch, seq_len, batch), _log1p(nv)])


def donor_distance(wl_t: np.ndarray, node_t: int, mode_t: str,
                   wl_d: np.ndarray, node_d: int, mode_d: str) -> float:
    """L2 over log1p workload features + |log node ratio| + a cross-mode
    penalty.  Pure and symmetric."""
    d = float(np.linalg.norm(wl_t - wl_d))
    d += abs(math.log(float(node_t) / float(node_d)))
    if mode_t != mode_d:
        d += MODE_PENALTY
    return d


# ----------------------------------------------------------- donor lookup
def _donor_pool(roots: List[str],
                stores: List[CampaignStore]) -> List[Dict]:
    """Every completed cell across the donor roots, with its log1p
    workload features at the donor's extraction settings."""
    from repro_torch.launch.recommend import split_cell_id
    pool: List[Dict] = []
    for root, ds in zip(roots, stores):
        sl, ba = ds.spec.seq_len, ds.spec.batch
        for cid in sorted(ds.manifest["cells"]):
            if ds.manifest["cells"][cid].get("status") != STATUS_DONE:
                continue
            arch, node_nm, mode = split_cell_id(cid)
            pool.append(dict(root=root, cell_id=cid, arch=arch,
                             node_nm=node_nm, mode=mode,
                             wl=_wl_log(arch, sl, ba)))
    return pool


def _donor_batch_id(donor: CampaignStore, cell_id: str) -> Optional[str]:
    """The donor batch that ran ``cell_id`` (its weights snapshot key)."""
    for b in plan_cached(donor.spec):
        if any(c.cell_id == cell_id for c in b.cells):
            return b.batch_id
    return None


def find_weights(root: str, batch_id: str) -> Optional[str]:
    """A donor batch's final-weights snapshot under ``root``: a
    single-process campaign's ``<root>/model/weights/<bid>`` or a fleet
    worker's ``<root>/worker-*/model/weights/<bid>``; the highest step
    wins."""
    cands = [os.path.join(root, "model", "weights", batch_id)] + sorted(
        glob.glob(os.path.join(root, "worker-*", "model", "weights",
                               batch_id)))
    steps = {c: s for c in cands
             if (s := ckpt_mod.latest_step(c)) is not None}
    if not steps:
        return None
    return max(steps, key=lambda c: (steps[c], c))


# ---------------------------------------------------------------- prepare
def prepare_store(store: CampaignStore,
                  progress: Callable[[str], None] = lambda m: None,
                  device="cuda") -> Dict:
    """Record the warm-start donors and fit/persist the cost model, once.

    Idempotent: a manifest that already holds a ``transfer`` record (the
    resume and fleet-worker path) is returned as it is.  Otherwise every
    donor root is opened (a missing manifest raises); each planned batch
    gets its cells' nearest donors and the weights snapshot of its nearest
    donor's batch (``manifest["transfer"]["donors"][batch.key]``); and the
    cost model is fitted on ``device`` over the donor archives and saved
    under ``<root>/model/cost/``, its leave-one-cell-out eval in
    ``<root>/model/eval.json``."""
    if "transfer" in store.manifest:
        return store.manifest["transfer"]
    spec = store.spec
    if not spec.transfer_from:
        raise ValueError("prepare_store needs spec.transfer_from donors")
    roots = [os.path.abspath(r) for r in spec.transfer_from]
    stores = [CampaignStore.open(r) for r in roots]
    by_root = dict(zip(roots, stores))
    pool = _donor_pool(roots, stores)
    if not pool:
        raise ValueError(f"transfer_from roots {roots} hold no completed "
                         "cells to warm-start from")
    record: Dict = dict(roots=roots, donors={})
    for batch in plan_cached(spec):
        cells_rec: Dict[str, Dict] = {}
        for cell in batch.cells:
            wl_t = _wl_log(cell.arch, spec.seq_len, spec.batch)
            best = min(pool, key=lambda p: (donor_distance(
                wl_t, cell.node_nm, cell.mode,
                p["wl"], p["node_nm"], p["mode"]), p["root"], p["cell_id"]))
            cells_rec[cell.cell_id] = dict(
                root=best["root"], cell_id=best["cell_id"],
                distance=round(donor_distance(
                    wl_t, cell.node_nm, cell.mode, best["wl"],
                    best["node_nm"], best["mode"]), 6))
        nearest = min(cells_rec.values(), key=lambda d: d["distance"])
        weights = None
        bid = _donor_batch_id(by_root[nearest["root"]], nearest["cell_id"])
        if bid is not None:
            wdir = find_weights(nearest["root"], bid)
            if wdir is not None:
                weights = dict(root=nearest["root"], batch_id=bid,
                               dir=os.path.abspath(wdir))
        record["donors"][batch.key] = dict(cells=cells_rec, weights=weights)
    record["cost_model"] = _fit_and_persist(store, roots, seed=spec.seed,
                                            progress=progress, device=device)
    store.manifest["transfer"] = record
    store.save_manifest()
    n_w = sum(1 for d in record["donors"].values() if d["weights"])
    progress(f"[transfer] {len(record['donors'])} batches warm-started "
             f"from {len(pool)} donor cells ({n_w} with weights) "
             f"across {len(roots)} root(s)")
    return record


def _fit_and_persist(store: CampaignStore, roots: List[str], *,
                     seed: int, progress: Callable[[str], None],
                     device="cuda") -> Optional[Dict]:
    """Fit the cost model from the donor archives on ``device``, save it
    under ``<root>/model/cost/`` and its held-out eval to
    ``model/eval.json``.  Donors whose archives are all empty yield no
    rows: recorded as None, and warm starts proceed on weights alone."""
    from repro_torch.launch.recommend import ArchiveIndex
    from repro_torch.models import cost_model as cm
    try:
        index = ArchiveIndex.build(roots)
    except ValueError:
        progress("[transfer] donor archives hold no frontier points; "
                 "skipping cost model")
        return None
    model = cm.fit_cost_model(index, seed=seed, device=device)
    cm.save_cost_model(model, store.root)
    resid = cm.holdout_residuals(index, seed=seed, device=device)
    os.makedirs(store.model_dir(), exist_ok=True)
    fsutil.atomic_write_json(
        os.path.join(store.model_dir(), EVAL_NAME),
        dict(kind="cost_model_eval", n_cells=model.meta["n_cells"],
             n_rows=model.meta["n_rows"],
             resid_var=model.meta["resid_var"],
             held_out_sq_residual=resid))
    return dict(n_rows=model.meta["n_rows"], n_cells=model.meta["n_cells"],
                resid_var=model.meta["resid_var"])


# ------------------------------------------------------------ with_transfer
def with_transfer(spec: CampaignSpec, roots: List[str],
                  device="cuda") -> CampaignSpec:
    """Arm ``spec`` for transfer: validate the donor roots, fit the cost
    model (its MLP on ``device``) and fill ``spec.priorities`` with each
    batch's predicted episodes-to-feasible, summed over its cells and
    rounded to 6 digits, so ``plan`` runs the expensive batches first and
    ``shard_batches`` deals longest first.  Donors with no archived points
    still transfer weights; priorities are then omitted."""
    roots = [os.path.abspath(str(r)) for r in roots]
    for r in roots:
        CampaignStore.open(r)           # fail fast on a bad root
    base = dataclasses.replace(spec, transfer_from=roots, priorities=None)
    from repro_torch.launch.recommend import ArchiveIndex
    from repro_torch.models import cost_model as cm
    try:
        model = cm.fit_cost_model(ArchiveIndex.build(roots),
                                  seed=spec.seed, device=device)
    except ValueError:
        return base
    pri: Dict[str, float] = {}
    for b in plan_cached(base):
        ctxs = np.stack([cell_context(c.arch, c.node_nm, c.mode,
                                      spec.seq_len, spec.batch)
                         for c in b.cells])
        pri[b.key] = round(float(np.sum(model.predict_episodes(ctxs))), 6)
    return dataclasses.replace(base, priorities=pri)


# ------------------------------------------------------------- warm start
def load_warm_start(store: CampaignStore, batch: CellBatch, workload,
                    device="cuda") -> Optional[Dict]:
    """Materialize the recorded donor into a ``run_search_cells``
    ``warm_start`` dict: the donor's SAC/surrogate weight leaves (``flat``)
    plus, per target cell, the donor frontier re-evaluated under the
    target's (workload, node, mode) on ``device`` (only feasible designs
    survive, stamped ``episode=0``) with the best incumbent ``(ppa_score,
    cfg, metrics)``.  Reads only the manifest's record and the donor
    artifacts it names; None when nothing usable is there."""
    rec = (store.manifest.get("transfer") or {}).get("donors", {}) \
        .get(batch.key)
    if not rec:
        return None
    flat = None
    w = rec.get("weights")
    if w and w.get("dir"):
        try:
            flat, _ = ckpt_mod.restore_flat(w["dir"])
        except (OSError, KeyError):
            # a pruned or corrupt donor snapshot degrades to archive-only
            # seeding rather than failing the batch
            flat = None
    from repro_torch.core.pareto import ArchiveEntry
    from repro_torch.ppa import config_space as cs
    from repro_torch.ppa.analytic import M_IDX, evaluate, node_vector
    from repro_torch.ppa.nodes import node_params
    dev = device_mod.resolve(device)
    wl_vec = torch.as_tensor(np.asarray(workload.features, np.float32),
                             device=dev)
    opened: Dict[str, CampaignStore] = {}
    cells_out: List[Optional[Dict]] = []
    for cell in batch.cells:
        d = (rec.get("cells") or {}).get(cell.cell_id)
        if not d:
            cells_out.append(None)
            continue
        try:
            ds = opened.get(d["root"]) or opened.setdefault(
                d["root"], CampaignStore.open(d["root"]))
        except FileNotFoundError:
            cells_out.append(None)
            continue
        src = ds.load_archive(d["cell_id"])
        if not src.entries:
            cells_out.append(None)
            continue
        with torch.no_grad():
            cfg_t = cs.project(torch.as_tensor(np.stack(
                [np.asarray(e.cfg, np.float32) for e in src.entries]),
                device=dev))
            node_row = torch.as_tensor(node_vector(
                node_params(cell.node_nm,
                            low_power=cell.mode != "high_perf"),
                high_perf=cell.mode == "high_perf"), device=dev)
            m_t = evaluate(cfg_t, wl_vec, node_row.expand(
                cfg_t.shape[0], node_row.shape[0]))
        cfgs, m = cfg_t.cpu().numpy(), m_t.cpu().numpy()
        feas = np.nonzero(m[:, M_IDX["feasible"]] > 0.0)[0]
        if not feas.size:
            cells_out.append(None)
            continue
        entries = [ArchiveEntry.from_metrics(cfgs[i], m[i], episode=0)
                   for i in feas]
        j = int(feas[np.argmin(m[feas, M_IDX["ppa_score"]])])
        best = (float(m[j, M_IDX["ppa_score"]]), cfgs[j].copy(),
                m[j].copy())
        cells_out.append(dict(entries=entries, best=best))
    if flat is None and not any(cells_out):
        return None
    return dict(flat=flat, cells=cells_out)
