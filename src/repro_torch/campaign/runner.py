"""Campaign runner: executes planned cell batches with resumable progress
(port of ``repro.campaign.runner``).

Each :class:`~repro_torch.campaign.planner.CellBatch` is one mixed-node
``run_search_cells`` invocation (shared env step + shared SAC/PER learner
across the batch's process nodes) on the campaign's device.  Progress is
durable at two granularities:

* **cell level** — a batch's cells are recorded ``done`` in the store
  manifest the moment the batch finishes; a resumed campaign never re-runs
  a completed cell.
* **chunk level** — within a running batch the full search state is
  checkpointed every ``spec.checkpoint_every`` dispatches under
  ``<run-dir>/ckpt/<batch_id>/``; a killed campaign resumes the batch from
  the last completed chunk, bit-for-bit.

Telemetry: ``run_batch``/``complete_cell``/``write_reports`` spans against
the installed tracer (a single-process campaign installs its own at
``<run-dir>/trace.jsonl``; a fleet worker keeps the one it installed), and
one structured log record per batch and completed cell when the caller
passes a bound logger.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

from repro_torch.campaign.planner import (DEFAULT_DTYPE, DEFAULT_PHASE,
                                          CampaignSpec, Cell, CellBatch, plan,
                                          plan_cached)
from repro_torch.campaign.report import write_reports
from repro_torch.campaign.store import CampaignStore
from repro_torch.configs import get_config
from repro_torch.core.reward import resolve_slo
from repro_torch.core.search import (SearchConfig, SearchResult,
                                     run_search_cells)
from repro_torch.obs import log as obs_log
from repro_torch.obs import trace as obs_trace
from repro_torch.ppa import config_space as cs
from repro_torch.ppa.analytic import M_IDX
from repro_torch.workload.extract import extract
from repro_torch.workload.features import Workload


def cell_summary(cell: Cell, res: SearchResult) -> Dict:
    """Best-PPA row persisted per completed cell (report source of truth)."""
    row = dict(cell_id=cell.cell_id, arch=cell.arch, node_nm=cell.node_nm,
               mode=cell.mode, method=res.method,
               episodes=res.episodes_run, feasible=res.feasible_count,
               unique=res.unique_configs, frontier=len(res.archive),
               wall_s=round(res.wall_s, 2),
               gate_open_episode=res.gate_open_episode,
               screened=res.screened, evaluated=res.evaluated)
    if res.best_cfg is not None:
        c = lambda n: float(res.best_cfg[cs.IDX[n]])
        row.update(mesh=f"{int(round(c('mesh_w')))}x{int(round(c('mesh_h')))}",
                   fetch=int(round(c("fetch"))), vlen=int(round(c("vlen"))),
                   wmem_kb=int(round(c("wmem_kb"))),
                   dmem_kb=int(round(c("dmem_kb"))),
                   imem_kb=int(round(c("imem_kb"))),
                   freq_frac=round(c("freq_frac"), 4))
    if res.best_metrics is not None:
        m = lambda n: float(res.best_metrics[M_IDX[n]])
        row.update(ppa_score=m("ppa_score"), tok_s=m("tok_s"),
                   power_mw=m("power_mw"), perf_gops=m("perf_gops"),
                   area_mm2=m("area_mm2"), freq_mhz=m("f_hz") / 1e6)
    else:
        # no feasible design found: None (not inf) keeps every campaign
        # artifact strict JSON
        row.update(ppa_score=None)
    # scenario keys appear ONLY off the default point / under an SLO, so
    # default-scenario summaries stay those of a grid without scenarios
    if cell.dtype != DEFAULT_DTYPE or cell.phase != DEFAULT_PHASE:
        row.update(dtype=cell.dtype, phase=cell.phase)
    if res.ttft_ms is not None:
        row.update(ttft_ms=res.ttft_ms, slo_ok=res.slo_ok)
    return row


def run_batch(store: CampaignStore, batch: CellBatch, workload: Workload,
              spec: CampaignSpec, device="cuda") -> List[SearchResult]:
    """Run one mixed-node batch to completion (resuming any checkpoint).

    If the manifest records a warm-start donor for this batch
    (``manifest["transfer"]``, written once by
    ``repro_torch.campaign.transfer.prepare_store``), the donor's weights
    and re-evaluated frontier seed the fresh search state; the seed comes
    from the recorded donor alone, so fleet workers and a W = 1 run derive
    the same one, and a checkpoint resume bypasses it.  The batch's final
    SAC/surrogate weights are snapshotted under
    ``<root>/model/weights/<batch_id>/``."""
    sc = SearchConfig(episodes=spec.episodes,
                      seed=spec.seed + 1000 * batch.index,
                      surrogate_gate=spec.surrogate_gate,
                      screen_k=spec.screen_k,
                      gate_threshold=spec.gate_threshold)
    warm = None
    if (store.manifest.get("transfer") or {}).get("donors", {}) \
            .get(batch.key):
        from repro_torch.campaign import transfer as transfer_mod
        warm = transfer_mod.load_warm_start(store, batch, workload,
                                            device=device)
    return run_search_cells(
        workload, list(batch.node_nms), high_perf=batch.mode == "high_perf",
        search=sc, lanes_per_cell=spec.lanes,
        checkpoint_dir=store.ckpt_dir(batch.batch_id),
        checkpoint_every=spec.checkpoint_every, resume=True,
        devices=spec.devices, warm_start=warm,
        save_weights_to=store.weights_dir(batch.batch_id),
        scenario=batch_scenario(batch, spec), device=device)


def batch_scenario(batch: CellBatch, spec: CampaignSpec) -> Optional[Dict]:
    """SLO-aware selection payload for ``run_search_cells`` (None when the
    spec carries no SLO, which leaves the search as it is without one):
    the paired prefill workload supplies TTFT, the cell's own search
    supplies tokens/s, and the per-mode SLO targets come from the spec."""
    if spec.slo is None:
        return None
    aux = extract(get_config(batch.arch), seq_len=spec.seq_len,
                  batch=spec.batch, phase="prefill", dtype=batch.dtype)
    return dict(aux_wl=aux, slo=resolve_slo(spec.slo, batch.mode),
                seq_len=spec.seq_len, batch=spec.batch)


def _resumed_spec(store: CampaignStore, root: str,
                  spec: Optional[CampaignSpec]) -> CampaignSpec:
    if spec is not None and spec.to_dict() != store.manifest["spec"]:
        raise ValueError(
            f"--resume spec differs from the manifest in {root}; "
            "resume without a grid file or start a new campaign")
    return store.spec


def execute_batch(store: CampaignStore, batch: CellBatch,
                  spec: CampaignSpec,
                  progress: Callable[[str], None] = lambda m: None,
                  device="cuda",
                  log: Optional[obs_log.JsonlLogger] = None) -> int:
    """Run one batch to completion against ``store``: resume any
    checkpoint, persist every cell, clear the batch checkpoint.  Shared by
    the single-process campaign loop and fleet workers
    (``repro_torch.campaign.distrib.run_worker``).  Returns the number of
    cells completed (0 if none were pending).  ``log`` (a bound
    :class:`~repro_torch.obs.log.JsonlLogger`) receives one structured
    record per completed cell, carrying the caller's context."""
    pending = store.pending_cells(batch)
    if not pending:
        # a kill between the batch's last complete_cell and clear_ckpt
        # would otherwise leave its checkpoints on disk forever
        store.clear_ckpt(batch.batch_id)
        return 0
    wl = extract(get_config(batch.arch), seq_len=spec.seq_len,
                 batch=spec.batch, phase=batch.phase, dtype=batch.dtype)
    progress(f"[campaign] {batch.batch_id}: {len(batch.node_nms)} cells "
             f"x {spec.lanes} lanes, {spec.episodes} ep/cell")
    if log is not None:
        log.info("batch started", cells=len(batch.node_nms),
                 lanes=spec.lanes, episodes=spec.episodes)
    done_before = {c.cell_id for c in batch.cells if c not in pending}
    store.mark_running(batch)
    with obs_trace.span("run_batch", cat="campaign",
                        batch=batch.batch_id,
                        cells=len(batch.node_nms)) as sp:
        results = run_batch(store, batch, wl, spec, device=device)
        sp.set(wall_s=round(sum(r.wall_s for r in results), 3))
    completed = 0
    for cell, res in zip(batch.cells, results):
        if cell.cell_id in done_before:
            # a re-run of a partially-completed batch reproduces the done
            # cell bit-for-bit; skipping the re-append avoids duplicate
            # records and keeps the manifest's provenance (fleet worker
            # tag) intact
            continue
        summary = cell_summary(cell, res)
        with obs_trace.span("complete_cell", cat="campaign",
                            cell=cell.cell_id):
            store.complete_cell(cell, summary, res.archive.entries)
        completed += 1
        score = summary["ppa_score"]
        progress(f"[campaign]   {cell.cell_id}: score="
                 f"{'-' if score is None else format(score, '.4f')} "
                 f"frontier={summary['frontier']}")
        if log is not None:
            log.bind(cell_id=cell.cell_id).info(
                "cell done", score=score, frontier=summary["frontier"],
                episodes=summary["episodes"])
    store.clear_ckpt(batch.batch_id)
    if log is not None:
        log.info("batch done", completed=completed)
    return completed


def run_campaign(root: str, spec: Optional[CampaignSpec] = None, *,
                 resume: bool = False,
                 progress: Callable[[str], None] = print,
                 device="cuda") -> CampaignStore:
    """Plan + execute + persist + report a full campaign on ``device``.

    ``resume=True`` reopens ``root`` (the spec is read back from the
    manifest) and continues: completed cells are skipped, an interrupted
    batch restarts from its last search checkpoint.
    """
    if resume:
        store = CampaignStore.open(root)
        if store.manifest.get("fleet", {}).get("assignments"):
            raise ValueError(
                f"{root} is a fleet campaign with undealt work; resume it "
                "at fleet scope (repro_torch.launch.dse --resume, or "
                "repro_torch.launch.fleet.launch_fleet(resume=True)) so "
                "worker results are reconciled and checkpoints relocated")
        spec = _resumed_spec(store, root, spec)
    else:
        if spec is None:
            raise ValueError("a CampaignSpec is required to start a campaign")
        store = CampaignStore.create(root, spec)
    if spec.transfer_from:
        # idempotent: records the donors and fits/persists the cost model
        # once; on resume a no-op unless a crash landed between the store's
        # creation and the transfer record
        from repro_torch.campaign import transfer as transfer_mod
        transfer_mod.prepare_store(store, progress=progress, device=device)
    t0 = time.time()
    n_done = 0
    # single-process campaigns get their own trace at <root>/trace.jsonl;
    # inside a fleet worker a tracer is already installed and kept
    own_tracer = None
    if obs_trace.current_tracer() is None \
            and not obs_trace.tracing_disabled():
        own_tracer = obs_trace.Tracer(
            os.path.join(root, obs_trace.TRACE_NAME), proc="campaign")
        obs_trace.install_tracer(own_tracer)
    try:
        for batch in plan_cached(spec):
            n_done += execute_batch(store, batch, spec, progress,
                                    device=device)
        with obs_trace.span("write_reports", cat="campaign"):
            write_reports(store)
    finally:
        if own_tracer is not None:
            obs_trace.install_tracer(None)
            own_tracer.close()
    progress(f"[campaign] {store.manifest['name']}: "
             f"{n_done} cells run, all_done={store.all_done()}, "
             f"{time.time() - t0:.1f}s -> {root}")
    return store


def run_cells_sequential(spec: CampaignSpec,
                         batches: Optional[List[CellBatch]] = None,
                         device="cuda") -> List[SearchResult]:
    """Baseline: one single-cell ``run_search_cells`` invocation per
    (workload, node, mode) at the same per-cell budget and lane count."""
    out = []
    for batch in (batches or plan(spec)):
        wl = extract(get_config(batch.arch), seq_len=spec.seq_len,
                     batch=spec.batch, phase=batch.phase, dtype=batch.dtype)
        for i, node in enumerate(batch.node_nms):
            sc = SearchConfig(episodes=spec.episodes,
                              seed=spec.seed + 1000 * batch.index + i,
                              surrogate_gate=spec.surrogate_gate,
                              screen_k=spec.screen_k,
                              gate_threshold=spec.gate_threshold)
            out.extend(run_search_cells(
                wl, [node], high_perf=batch.mode == "high_perf",
                search=sc, lanes_per_cell=spec.lanes,
                devices=spec.devices, device=device))
    return out
