"""Distributed campaign fleets (port of ``repro.campaign.distrib``): shard
cell batches across shared-nothing workers and reconcile their run
directories into one frontier.

A fleet run of campaign ``<root>`` lays out::

    <root>/manifest.json           top-level manifest: spec + every cell +
                                   the ``fleet`` block (worker count, the
                                   deterministic batch -> worker deal,
                                   per-worker stats after reconcile)
    <root>/worker-<i>/             one full CampaignStore per worker:
        manifest.json              only the worker's dealt cells
        cells/<cell_id>.jsonl      the worker's frontier points + summaries
        ckpt/<batch_id>/           the worker's in-flight search checkpoints
        worker.log                 the worker process's output
    <root>/cells/<cell_id>.jsonl   reconciled archives (merge_runs union)
    <root>/report/                 tables incl. per-worker utilization

Workers are shared-nothing: each runs its own ``run_search_cells`` loop
over its dealt batches on its device, exactly like a single-process
campaign restricted to those batches.  Batch seeds derive from the GLOBAL
batch index, so a W-worker fleet reproduces the W=1 campaign bit-for-bit
(``tests/test_torch_fleet.py``; on one card too, ``chip_smoke.py``).  The
deal itself (:func:`shard_batches`) is a pure function of the sorted batch
ids — order-independent and stable across resumes.

``reconcile`` merges worker manifests and archives into the top-level
store: dominance-filtered point union via :func:`~repro_torch.campaign.
store.merge_runs`, summary copy for newly completed cells, then ONE atomic
manifest write — JSONL first, manifest second, so a reconcile interrupted
mid-write leaves the previous manifest valid and a re-run is idempotent.

Everything here is process-agnostic and host-shardable: a worker needs
only the shared run directory (``run_worker(root, i)``), and it
advertises liveness there too — ``worker-<i>/lease.json`` refreshed by a
:class:`Heartbeat` thread — so a supervisor anywhere on the shared
filesystem can evict silent workers and ``redeal_batches`` to fresh
slots mid-run.  The launchers that actually spawn worker processes
(local subprocess or command-template/ssh) and the supervisor loop live
in ``repro_torch.launch.fleet``.

Telemetry rides the same channels: each worker appends spans to
``worker-<i>/trace.jsonl`` and structured log records to
``worker-<i>/log.jsonl`` (mirrored to stdout, which the launcher already
redirects to ``worker.log``), and the heartbeat piggybacks a
``MetricsRegistry`` snapshot onto every lease refresh — so the live
fleet view (``repro_torch.launch.fleet --status``) needs no new files or
sockets, just the leases that liveness already requires.  Each worker also
publishes its kernels' launch counts (``kernel_launches_total``, labelled
by kernel) in that snapshot, so the final lease shows which kernels the
worker ran.  The run directory is the reference's, file for file, so either
package reads the other's fleets.  A transfer campaign
(``--transfer-from``) records its warm-start donors and fits its cost model
in the parent before any worker spawns (``transfer.prepare_store``), each
worker store mirrors that top-level record verbatim, and the deal is
longest-predicted-first over ``spec.priorities``: a warm W-worker fleet
derives the W = 1 run's warm start.
"""
from __future__ import annotations

import glob
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.campaign.planner import CampaignSpec, CellBatch, plan_cached
from repro_torch.campaign.store import (DEFAULT_LEASE_TTL_S, STATUS_DONE,
                                        CampaignStore, _git_sha, merge_runs,
                                        read_lease, write_lease)
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

# manifest["cells"][cid] / summary keys that legitimately differ between
# two bit-identical runs (wall clock, scheduling) — excluded from
# fingerprints and reconciliation equality checks.
VOLATILE_KEYS = ("completed", "wall_s", "batch", "worker")


# --------------------------------------------------------------- sharding
def shard_batches(batches: List[CellBatch], workers: int,
                  priorities: Optional[Dict[str, float]] = None
                  ) -> Dict[int, List[CellBatch]]:
    """Deal batches to workers: sort by batch_id, then round-robin.

    Deterministic and order-independent (the sort makes the deal a pure
    function of the batch SET), and balanced to within one batch per
    worker.  Workers that receive no batches are absent from the result.

    With ``priorities`` (a fitted cost model's predicted episodes per
    ``CellBatch.key``; ``campaign/transfer`` in the reference), the deal
    becomes
    longest-processing-time-first: batches are taken in descending
    predicted cost (stably tied on batch_id) and each goes to the worker
    with the smallest accumulated predicted load (ties to the lowest
    slot), so workers drain together instead of one slot drawing all the
    expensive batches.  Still a pure function of (batch set, priorities)
    — batch seeds derive from the global index either way, so the dealt
    fleet fingerprints identically to W=1 regardless of the deal shape.
    """
    if workers < 1:
        raise ValueError(f"workers must be >= 1 (got {workers})")
    out: Dict[int, List[CellBatch]] = {}
    if priorities:
        load = [0.0] * workers
        for b in sorted(batches,
                        key=lambda b: (-float(priorities.get(b.key, 0.0)),
                                       b.batch_id)):
            # batch count breaks load ties: with equal (or degenerate
            # all-zero) predicted costs the deal stays balanced to within
            # one batch instead of piling everything on slot 0
            w = min(range(workers),
                    key=lambda i: (load[i], len(out.get(i, ())), i))
            load[w] += max(0.0, float(priorities.get(b.key, 0.0)))
            out.setdefault(w, []).append(b)
        return out
    for i, b in enumerate(sorted(batches, key=lambda b: b.batch_id)):
        out.setdefault(i % workers, []).append(b)
    return out


def worker_root(root: str, idx: int) -> str:
    return os.path.join(root, f"worker-{idx}")


def worker_roots(root: str) -> List[str]:
    """Existing worker run directories (those holding a manifest)."""
    return sorted(r for r in glob.glob(os.path.join(root, "worker-*"))
                  if os.path.isfile(os.path.join(r, "manifest.json")))


def pending_batches(store: CampaignStore) -> List[CellBatch]:
    """Batches with at least one cell not yet ``done`` in the manifest."""
    return [b for b in plan_cached(store.spec)
            if any(store.status(c) != STATUS_DONE for c in b.cells)]


def record_event(store: CampaignStore, kind: str, **fields) -> Dict:
    """Append a supervision event (evict / redeal / give-up / stale-leg)
    to the manifest's fleet block.  The caller owns the manifest write —
    events ride along with whatever state change triggered them."""
    ev = dict(ts=round(time.time(), 3), kind=kind, **fields)
    store.manifest.setdefault("fleet", {}).setdefault(
        "events", []).append(ev)
    obs_trace.instant(kind, cat="fleet", **fields)
    return ev


# ------------------------------------------------------------- fleet plan
def create_fleet(root: str, spec: CampaignSpec, workers: int, *,
                 lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
                 device="cuda") -> CampaignStore:
    """Create the top-level store + record the deterministic deal.

    ``lease_ttl_s`` is recorded in the fleet block so workers (which see
    only the shared run directory) know their heartbeat cadence and the
    supervisor knows when a silent worker is dead.  A transfer spec's
    donors are recorded (and its cost model fitted on ``device``) here,
    before any worker is spawned."""
    store = CampaignStore.create(root, spec)
    if spec.transfer_from:
        from repro_torch.campaign import transfer as transfer_mod
        transfer_mod.prepare_store(store, device=device)
    assign = shard_batches(plan_cached(spec), workers,
                           priorities=spec.priorities)
    store.manifest["fleet"] = dict(
        workers=workers, started_ts=time.time(),
        lease_ttl_s=float(lease_ttl_s), events=[],
        assignments={b.batch_id: w for w, bs in assign.items() for b in bs})
    store.save_manifest()
    return store


def redeal_batches(store: CampaignStore, batch_ids: List[str],
                   new_idx: int) -> None:
    """Move still-pending batches to worker slot ``new_idx`` mid-run:
    update the recorded deal and relocate the batches' newest in-flight
    checkpoints into the new owner's run directory (the same machinery a
    fleet ``--resume`` uses, so the re-dealt batch restores bit-for-bit).
    The caller saves the manifest — typically together with the event
    that triggered the re-deal."""
    with obs_trace.span("redeal_batches", cat="fleet",
                        batches=list(batch_ids), to_worker=new_idx):
        moves = {bid: new_idx for bid in batch_ids}
        _relocate_ckpts(store.root, moves)
        store.manifest["fleet"]["assignments"].update(moves)


def plan_resume(root: str, workers: Optional[int] = None, *,
                lease_ttl_s: Optional[float] = None,
                device="cuda") -> CampaignStore:
    """Fleet-scope resume: reconcile what every prior worker finished,
    re-deal the still-pending batches to ``workers`` fresh worker slots,
    and relocate any orphan in-flight checkpoints to the slot that now
    owns the batch (so a resumed batch restores bit-for-bit).

    Works on a plain single-process campaign directory too (its ``ckpt/``
    checkpoints are adopted), which is how an existing campaign is
    upgraded to a fleet.
    """
    store = CampaignStore.open(root)
    if store.spec.transfer_from:
        # crash-safe: a kill between CampaignStore.create and prepare_store
        # leaves a transfer campaign without its recorded donors;
        # prepare_store is a no-op once they are recorded
        from repro_torch.campaign import transfer as transfer_mod
        transfer_mod.prepare_store(store, device=device)
    reconcile(store)
    # snapshot the fleet block only AFTER reconcile: it just updated
    # wall_s / worker_stats in place, and a stale copy would clobber them
    fleet = dict(store.manifest.get("fleet") or {})
    workers = int(workers or fleet.get("workers") or 1)
    todo = pending_batches(store)
    assign = shard_batches(todo, workers, priorities=store.spec.priorities)
    assignments = {b.batch_id: w for w, bs in assign.items() for b in bs}
    _relocate_ckpts(root, assignments)
    _clear_stale_ckpts(root, set(assignments))
    fleet.update(workers=workers, assignments=assignments)
    if lease_ttl_s is not None:
        fleet["lease_ttl_s"] = float(lease_ttl_s)
    fleet.setdefault("lease_ttl_s", DEFAULT_LEASE_TTL_S)
    if todo:
        # close out the previous leg's wall clock (reconcile above wrote
        # wall_s for it) and start a new one; busy_s accumulates across
        # legs, so utilization = busy / (base + current leg)
        fleet["wall_base_s"] = float(fleet.get("wall_s") or 0.0)
        fleet["started_ts"] = time.time()
    store.manifest["fleet"] = fleet
    store.save_manifest()
    return store


def _clear_stale_ckpts(root: str, live_bids: set) -> None:
    """Drop checkpoints of batches that are no longer dealt (completed):
    a worker killed between its batch's last complete_cell and clear_ckpt
    would otherwise leak the batch's search state forever, since the
    finished batch is never re-dealt to anyone who would clear it."""
    stale = [d for d in
             glob.glob(os.path.join(root, "ckpt", "*")) +
             glob.glob(os.path.join(root, "worker-*", "ckpt", "*"))
             if os.path.isdir(d) and os.path.basename(d) not in live_bids]
    for d in stale:
        shutil.rmtree(d, ignore_errors=True)


def _relocate_ckpts(root: str, assignments: Dict[str, int]) -> None:
    """Move each pending batch's newest checkpoint into the run directory
    of the worker the batch is now dealt to.

    Candidates are the top-level ``ckpt/<batch_id>`` (single-process runs)
    and every ``worker-*/ckpt/<batch_id>`` (dead workers).  Checkpoints of
    one batch advance monotonically and only one worker runs a batch at a
    time, so the highest step wins; stale copies are removed."""
    from repro_torch.checkpoint import manager as ckpt_mod
    for bid, w in sorted(assignments.items()):
        dest = os.path.join(worker_root(root, w), "ckpt", bid)
        cands = [os.path.join(root, "ckpt", bid)] + [
            os.path.join(r, "ckpt", bid)
            for r in glob.glob(os.path.join(root, "worker-*"))]
        steps = {c: s for c in cands
                 if (s := ckpt_mod.latest_step(c)) is not None}
        if not steps:
            continue
        best = max(steps, key=lambda c: (steps[c], c == dest))
        if os.path.abspath(best) != os.path.abspath(dest):
            if os.path.isdir(dest):
                shutil.rmtree(dest)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            os.replace(best, dest)
        for c in steps:       # losing (older) copies are dead weight
            if os.path.abspath(c) != os.path.abspath(dest):
                shutil.rmtree(c, ignore_errors=True)


# ------------------------------------------------------------ worker side
class Heartbeat:
    """Background lease refresher for one worker process.

    Refreshes ``worker-<i>/lease.json`` every ``ttl/4`` (floored at
    200 ms) with (pid, host, ts, current batch) via the fsync'd atomic
    writer, so liveness is observable from the shared run directory
    alone.  ``beat(batch_id)`` both updates the advertised batch and
    refreshes immediately; ``stop()`` writes a final ``done`` lease so a
    clean exit is distinguishable from silent death.

    When given a ``registry``, every refresh piggybacks its snapshot onto
    the lease's ``metrics`` field — the transport behind the live fleet
    status view.  Snapshots are taken outside any search code path and
    never touch RNG streams."""

    def __init__(self, worker_dir: str, idx: int,
                 ttl_s: float = DEFAULT_LEASE_TTL_S,
                 registry: "Optional[obs_metrics.MetricsRegistry]" = None):
        self.worker_dir, self.idx = worker_dir, idx
        self.ttl_s = float(ttl_s)
        self.registry = registry
        self.batch: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _write(self, done: bool = False) -> None:
        try:
            snap = (self.registry.snapshot()
                    if self.registry is not None else None)
            write_lease(self.worker_dir, worker=self.idx,
                        batch=self.batch, ttl_s=self.ttl_s, done=done,
                        metrics=snap)
        except OSError:
            # a transient shared-FS hiccup must not kill the search; the
            # next refresh retries and the TTL absorbs one missed beat
            pass

    def _run(self) -> None:
        while not self._stop.wait(max(0.2, self.ttl_s / 4.0)):
            self._write()

    def start(self) -> "Heartbeat":
        self._write()
        self._thread = threading.Thread(
            target=self._run, name=f"lease-w{self.idx}", daemon=True)
        self._thread.start()
        return self

    def beat(self, batch: Optional[str]) -> None:
        self.batch = batch
        self._write()

    def stop(self, done: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._write(done=done)


def _open_worker_store(root: str, idx: int, top: CampaignStore,
                       batches: List[CellBatch]) -> CampaignStore:
    """Open (or create) worker ``idx``'s store, seeded with its dealt
    cells.  Cells the top-level manifest already records as done stay
    done, so a re-dealt batch skips completed work like a resume does."""
    wroot = worker_root(root, idx)
    if os.path.isfile(os.path.join(wroot, "manifest.json")):
        w = CampaignStore.open(wroot)
    else:
        os.makedirs(os.path.join(wroot, "cells"), exist_ok=True)
        w = CampaignStore(wroot, dict(
            name=f"{top.manifest['name']}/worker-{idx}",
            created=time.strftime("%Y-%m-%dT%H:%M:%S"), git_sha=_git_sha(),
            seed=top.manifest["seed"],
            episodes_per_cell=top.manifest["episodes_per_cell"],
            spec=top.manifest["spec"], cells={}))
    if "transfer" in top.manifest:
        # execute_batch resolves warm-start donors against the worker's
        # store: mirror the top-level record verbatim so a worker derives
        # the warm start a W=1 run would
        w.manifest["transfer"] = top.manifest["transfer"]
    for cid in sorted(c.cell_id for b in batches for c in b.cells):
        rec = top.manifest["cells"].get(cid, {})
        mine = w.manifest["cells"].get(cid, {})
        if mine.get("status") != STATUS_DONE:
            if rec.get("status") == STATUS_DONE:
                # seeded from the top-level manifest: keep the provenance
                # tag so utilization stats never credit this worker with
                # work another worker (or a single-process run) did
                seeded = dict(rec)
                seeded.setdefault("worker", "upstream")
                w.manifest["cells"][cid] = seeded
            else:
                w.manifest["cells"][cid] = dict(status="pending")
    w.manifest["worker"] = dict(
        index=idx, busy_s=float(w.manifest.get("worker", {})
                                .get("busy_s", 0.0)))
    w.save_manifest()
    return w


def publish_launches(registry: "obs_metrics.MetricsRegistry",
                     seen: Dict[str, int]) -> None:
    """Add the kernels' launches since the last call (``seen``, updated in
    place) to the ``kernel_launches_total`` counters, one per kernel.
    Reads the wrappers' host-side counts only."""
    from repro_torch.kernels import ops
    for name, n in ops.launch_counts().items():
        registry.counter("kernel_launches_total",
                         labels={"kernel": name}).inc(n - seen.get(name, 0))
        seen[name] = n


def run_worker(root: str, idx: int, progress=print,
               device="cuda") -> CampaignStore:
    """One worker's whole life: run every batch the top-level manifest
    deals to slot ``idx`` on ``device``, with its own checkpoints and
    durable per-cell results under ``worker-<idx>/``.  Shared-nothing: the
    only cross-worker state is the read-only top-level manifest.  A CUDA
    worker without a card raises before it touches the run directory.

    Installs the process-global tracer (``worker-<idx>/trace.jsonl``) and
    a structured JSONL logger (``worker-<idx>/log.jsonl``, mirrored to
    stdout so ``worker.log`` stays human-readable), and feeds the global
    metrics registry to the heartbeat so every lease refresh carries a
    live metrics snapshot, the kernels' launch counts among them."""
    from repro_torch import device as device_mod
    from repro_torch.campaign.runner import execute_batch
    device = device_mod.resolve(device)
    top = CampaignStore.open(root)
    fleet = top.manifest.get("fleet")
    if not fleet:
        raise ValueError(f"{root} is not a fleet campaign "
                         "(no fleet block in manifest.json)")
    mine = [b for b in plan_cached(top.spec)
            if fleet["assignments"].get(b.batch_id) == idx]
    store = _open_worker_store(root, idx, top, mine)
    tracer = None if obs_trace.tracing_disabled() else obs_trace.Tracer(
        os.path.join(store.root, obs_trace.TRACE_NAME),
        proc=f"worker-{idx}")
    obs_trace.install_tracer(tracer)
    wlog = obs_log.JsonlLogger(
        os.path.join(store.root, obs_log.LOG_NAME)).bind(worker=idx)
    registry = obs_metrics.global_registry()
    registry.gauge("worker_index").set(float(idx))
    launches: Dict[str, int] = {}
    publish_launches(registry, launches)
    hb = Heartbeat(store.root, idx,
                   ttl_s=float(fleet.get("lease_ttl_s")
                               or DEFAULT_LEASE_TTL_S),
                   registry=registry).start()
    wlog.info("worker started", batches=len(mine), pid=os.getpid())
    try:
        for batch in mine:
            hb.beat(batch.batch_id)
            registry.counter("batches_started").inc()
            t0 = time.time()
            with obs_trace.span("execute_batch", cat="campaign",
                                batch=batch.batch_id) as sp:
                n = execute_batch(
                    store, batch, top.spec,
                    progress=lambda m: progress(f"[w{idx}]{m}"),
                    device=device, log=wlog.bind(batch_id=batch.batch_id))
                sp.set(cells_run=n)
            publish_launches(registry, launches)
            if n:
                store.manifest["worker"]["busy_s"] += time.time() - t0
                store.save_manifest()
    except BaseException as e:
        # crash path: the final lease must NOT read ``done`` — an exit
        # with work outstanding is what the supervisor evicts on
        wlog.error("worker crashed", error=repr(e))
        hb.stop(done=False)
        wlog.close()
        if tracer is not None:
            obs_trace.install_tracer(None)
            tracer.close()
        raise
    hb.stop(done=True)
    progress(f"[w{idx}] done: {len(mine)} batches, "
             f"busy {store.manifest['worker']['busy_s']:.1f}s")
    wlog.info("worker done", batches=len(mine),
              busy_s=round(store.manifest["worker"]["busy_s"], 2))
    wlog.close()
    if tracer is not None:
        obs_trace.install_tracer(None)
        tracer.close()
    return store


# -------------------------------------------------------------- reconcile
def _leg_end(roots: List[str], started: float, fleet: Dict
             ) -> "tuple[float, bool]":
    """(end-of-leg timestamp, leg-is-stale) for the wall clock.

    A live leg (some worker heartbeated within the TTL, or no worker ever
    wrote a lease — the pre-lease layout) ends "now".  A STALE leg — every
    lease is older than the TTL, i.e. a SIGKILLed parent left
    ``started_ts`` dangling and the workers are long dead — is closed at
    the newest lease/heartbeat timestamp instead, so idle calendar time
    between the crash and this reconcile never inflates ``wall_s`` and
    dilutes ``util_pct``."""
    now = time.time()
    ttl = float(fleet.get("lease_ttl_s") or DEFAULT_LEASE_TTL_S)
    beats = [float(lease["ts"]) for r in roots
             if (lease := read_lease(r)) and lease.get("ts")]
    if not beats or now - max(beats) <= ttl:
        return now, False
    return max(max(beats), started), True


def reconcile(store: CampaignStore, progress=lambda m: None, *,
              freeze_clock: bool = False) -> List[str]:
    """Merge every worker run directory into the top-level store.

    Atomic, idempotent, crash-safe: archive points union in with dominance
    filtering (``merge_runs``), summaries of newly completed cells are
    appended to the top-level JSONL, and only then is the manifest flipped
    in ONE atomic write.  A kill anywhere mid-reconcile leaves the previous
    manifest valid and a re-run converges to the same state (point appends
    are dedup-guarded; a summary line can be re-appended in the window
    before the manifest flip, which is benign — last summary wins).

    ``freeze_clock=True`` ends the current wall-clock leg (the fleet
    parent passes it when its workers have exited), so idle time between
    a failed leg and a later ``--resume`` never dilutes utilization.
    Returns the cell ids newly marked done."""
    with obs_trace.span("reconcile", cat="fleet",
                        freeze_clock=freeze_clock) as sp:
        newly = _reconcile(store, progress, freeze_clock=freeze_clock)
        sp.set(newly_done=len(newly))
        return newly


def _reconcile(store: CampaignStore, progress, *,
               freeze_clock: bool) -> List[str]:
    roots = worker_roots(store.root)
    if not roots:
        return []
    stats = {}
    newly_done: Dict[str, Dict] = {}
    for r in roots:
        w = CampaignStore.open(r)
        widx = w.manifest.get("worker", {}).get("index")
        done = [cid for cid, rec in w.manifest["cells"].items()
                if rec.get("status") == STATUS_DONE]
        # stats credit only cells this worker completed itself — records
        # seeded from elsewhere carry a "worker" provenance tag
        own = [cid for cid in done
               if "worker" not in w.manifest["cells"][cid]]
        stats[os.path.basename(r)] = dict(
            worker=widx, cells=len(own),
            episodes=sum(int(w.manifest["cells"][c].get("episodes") or 0)
                         for c in own),
            busy_s=round(float(w.manifest.get("worker", {})
                               .get("busy_s", 0.0)), 2))
        for cid in done:
            if store.manifest["cells"].get(cid, {}) \
                    .get("status") == STATUS_DONE or cid in newly_done:
                continue
            rec = dict(w.manifest["cells"][cid])
            rec["worker"] = widx
            newly_done[cid] = dict(rec=rec, summary=w.load_summary(cid))
    # 1) archives: dominance-filtered union, appended to dst JSONL only
    #    when they add frontier points (idempotent on re-run)
    merge_runs(store, roots)
    # 2) summaries for newly completed cells (skipped on re-run because
    #    the manifest flip below already happened)
    for cid, d in sorted(newly_done.items()):
        if d["summary"] is not None:
            store.append_summary(cid, d["summary"])
    # 3) single atomic manifest write publishes the merged state
    for cid, d in newly_done.items():
        store.manifest["cells"][cid] = d["rec"]
    fleet = store.manifest.setdefault("fleet", {})
    fleet["worker_stats"] = stats
    # ONE plan derivation serves both the deal pruning and the finished
    # check: nothing below changes cell status, so the set is stable
    pending = pending_batches(store)
    finished = not pending
    if fleet.get("assignments"):
        # the deal only tracks OUTSTANDING work: completed batches drop
        # out, so a finished fleet has an empty deal and a plain resume
        # of it is a no-op rather than an error
        live = {b.batch_id for b in pending}
        fleet["assignments"] = {bid: w for bid, w
                                in fleet["assignments"].items()
                                if bid in live}
    started = fleet.get("started_ts")
    if started:
        # cumulative across resume legs: wall_base_s closed out earlier
        # legs, started_ts opened the current one
        end, stale = _leg_end(roots, float(started), fleet)
        fleet["wall_s"] = round(float(fleet.get("wall_base_s") or 0.0)
                                + end - float(started), 2)
        if freeze_clock or finished or stale:
            # leg over (workers exited / campaign finished) or stale (a
            # SIGKILLed PARENT left started_ts dangling; _leg_end closed
            # it at the newest heartbeat): freeze the clock so idle
            # calendar time before a later resume never dilutes util_pct
            fleet["wall_base_s"] = fleet["wall_s"]
            fleet.pop("started_ts")
            if stale:
                record_event(store, "stale-leg-closed",
                             wall_s=fleet["wall_s"])
        if finished:
            # drop any checkpoint a worker died too early to clear
            _clear_stale_ckpts(store.root, set())
    store.save_manifest()
    if newly_done:
        progress(f"[fleet] reconciled {len(newly_done)} cells "
                 f"from {len(roots)} worker dirs")
    return sorted(newly_done)


# ------------------------------------------------------------ fingerprint
def fingerprint(store: CampaignStore) -> Dict[str, Dict]:
    """Deterministic digest of a campaign's merged outcome: per-cell
    status + summary + frontier, with wall-clock noise stripped.  Two runs
    of the same grid/seed must fingerprint identically — fleet vs single
    process, interrupted vs not (``tests/test_torch_fleet.py``).
    """
    out: Dict[str, Dict] = {}
    for cid, rec in sorted(store.manifest["cells"].items()):
        r = {k: v for k, v in rec.items() if k not in VOLATILE_KEYS}
        s = store.load_summary(cid)
        if s is not None:
            r["summary"] = {k: v for k, v in s.items()
                            if k not in VOLATILE_KEYS}
        fr = store.load_archive(cid).frontier()
        r["frontier"] = sorted(zip(*(np.asarray(fr[k], np.float64).tolist()
                                     for k in sorted(fr))))
        out[cid] = r
    return out
