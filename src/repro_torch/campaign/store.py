"""Campaign persistence: JSONL run directory + manifest + archive merge,
and the fleet workers' liveness leases (port of ``repro.campaign.store``).

Layout of one campaign run directory (``experiments/campaigns/<name>/``),
the reference's, so each package reads the other's run directories:

    manifest.json            campaign spec, git sha, seed, per-cell status
    cells/<cell_id>.jsonl    appended records per completed chunk:
                               {"kind": "point", ...ArchiveEntry fields}
                               {"kind": "summary", ...best-PPA row}
    ckpt/<batch_id>/         in-flight search-state checkpoints
                             (cleared when the batch completes)
    model/weights/<batch_id>/  final SAC + surrogate weights per batch
    report/                  per-cell + cross-node adaptation tables
    worker-<i>/lease.json    a fleet worker's liveness lease

The manifest is the source of truth for resume: a cell is re-run iff its
status is not ``done``.  All manifest writes are atomic (tmp + fsync +
rename), so a kill at any point leaves either the old or the new manifest.
``merge_runs`` unions per-cell Pareto archives across run directories with
dominance filtering.
"""
from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import time
from typing import Dict, List, Optional

from repro_torch.campaign.planner import CampaignSpec, Cell, CellBatch
from repro_torch.core import fsutil
from repro_torch.core.pareto import ArchiveEntry, ParetoArchive

STATUS_PENDING = "pending"
STATUS_RUNNING = "running"
STATUS_DONE = "done"

# liveness lease defaults (fleet workers; see write_lease below).  A
# worker refreshes its lease every ttl/4, so one missed refresh never
# looks like death; the supervisor treats ``now - ts > ttl`` as expired.
LEASE_NAME = "lease.json"
DEFAULT_LEASE_TTL_S = 15.0


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


# the atomic tmp-write -> fsync -> rename -> dir-fsync sequence lives in
# core.fsutil so the checkpoint manager shares it
_atomic_write_json = fsutil.atomic_write_json


# ----------------------------------------------------------------- leases
def lease_path(worker_dir: str) -> str:
    return os.path.join(worker_dir, LEASE_NAME)


def write_lease(worker_dir: str, *, worker: int, batch: Optional[str],
                ttl_s: float, done: bool = False,
                metrics: Optional[Dict] = None) -> Dict:
    """Refresh worker ``worker``'s liveness lease under its run directory.

    The lease is the fleet's only liveness channel that crosses hosts: it
    lives in the shared run directory, so a supervisor anywhere on the
    shared filesystem can observe (pid, host, ts, current batch) without
    a process handle.  Written atomically+durably so a reader never sees
    a torn lease and a power-lost refresh leaves the previous one.

    ``metrics`` piggybacks a JSON-safe telemetry snapshot
    (``repro_torch.obs.metrics.MetricsRegistry.snapshot``) on the heartbeat —
    the live fleet view (``repro_torch.launch.fleet --status``) is aggregated
    from leases alone, no extra files or sockets."""
    lease = dict(worker=int(worker), pid=os.getpid(),
                 host=socket.gethostname(), ts=time.time(),
                 batch=batch, ttl_s=float(ttl_s), done=bool(done))
    if metrics is not None:
        lease["metrics"] = metrics
    fsutil.atomic_write_json(lease_path(worker_dir), lease)
    return lease


def read_lease(worker_dir: str) -> Optional[Dict]:
    """The worker's last lease, or None if it never wrote one (a torn or
    unreadable lease also reads as None — the refresh is atomic, so that
    only happens for pre-lease worker dirs)."""
    try:
        with open(lease_path(worker_dir)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def lease_expired(lease: Optional[Dict], *, now: Optional[float] = None,
                  ttl_s: Optional[float] = None) -> bool:
    """True when the lease-holder must be presumed dead: no refresh within
    the TTL (the lease's own, unless ``ttl_s`` overrides).  A missing
    lease is NOT expired — the worker may still be booting; callers gate
    that case on spawn time.  A ``done`` lease never expires: the worker
    finished and stopped refreshing on purpose."""
    if lease is None or lease.get("done"):
        return False
    # explicit None checks: `lease.get("ttl_s") or DEFAULT` would silently
    # promote an explicit-but-falsy ttl (0 / 0.0, e.g. a sub-second chaos
    # harness rounding down) to the 15 s default, so the holder looked
    # alive for 15 s after its last beat instead of expiring immediately
    lease_ttl = lease.get("ttl_s")
    ttl = float(ttl_s if ttl_s is not None
                else lease_ttl if lease_ttl is not None
                else DEFAULT_LEASE_TTL_S)
    return (now if now is not None else time.time()) \
        - float(lease.get("ts") or 0.0) > ttl


def _read_jsonl(path: str) -> List[Dict]:
    """Decode a JSONL file, skipping torn lines.

    A SIGKILL / power loss mid-append can leave a partial line; the
    record it belonged to is re-appended by the resumed writer (appends
    start on a fresh line past a torn tail), so after healing a torn line
    can sit mid-file.  Undecodable lines are therefore skipped wherever
    they appear — the dominance filter and last-summary-wins semantics
    make re-appended records safe."""
    with open(path) as f:
        lines = f.readlines()
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return out


class CampaignStore:
    """One campaign run directory (create once, reopen to resume)."""

    def __init__(self, root: str, manifest: Dict):
        self.root = root
        self.manifest = manifest
        self._spec: Optional[CampaignSpec] = None

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, root: str, spec: CampaignSpec) -> "CampaignStore":
        if os.path.exists(os.path.join(root, "manifest.json")):
            raise FileExistsError(
                f"{root} already holds a campaign; use resume or a new name")
        os.makedirs(os.path.join(root, "cells"), exist_ok=True)
        from repro_torch.campaign.planner import cells as expand
        manifest = dict(
            name=spec.name, created=time.strftime("%Y-%m-%dT%H:%M:%S"),
            git_sha=_git_sha(), seed=spec.seed,
            episodes_per_cell=spec.episodes, spec=spec.to_dict(),
            cells={c.cell_id: dict(status=STATUS_PENDING)
                   for c in expand(spec)})
        store = cls(root, manifest)
        store.save_manifest()
        return store

    @classmethod
    def open(cls, root: str) -> "CampaignStore":
        path = os.path.join(root, "manifest.json")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no campaign manifest at {path}")
        with open(path) as f:
            return cls(root, json.load(f))

    def save_manifest(self) -> None:
        _atomic_write_json(os.path.join(self.root, "manifest.json"),
                           self.manifest)

    @property
    def spec(self) -> CampaignSpec:
        # parsed once per store: the manifest's spec never mutates, and
        # fleet-scope operations (pending_batches, reconcile) hit this on
        # every poll tick
        if self._spec is None:
            self._spec = CampaignSpec.from_dict(self.manifest["spec"])
        return self._spec

    # ------------------------------------------------------------ cell state
    def status(self, cell: Cell) -> str:
        rec = self.manifest["cells"].get(cell.cell_id)
        return rec["status"] if rec else STATUS_PENDING

    def pending_cells(self, batch: CellBatch) -> List[Cell]:
        return [c for c in batch.cells if self.status(c) != STATUS_DONE]

    def mark_running(self, batch: CellBatch) -> None:
        for c in batch.cells:
            rec = self.manifest["cells"].setdefault(c.cell_id, {})
            if rec.get("status") != STATUS_DONE:
                rec.update(status=STATUS_RUNNING, batch=batch.batch_id)
        self.save_manifest()

    def complete_cell(self, cell: Cell, summary: Dict,
                      entries: List[ArchiveEntry]) -> None:
        """Append the cell's frontier points + summary, then flip status.

        JSONL first, manifest second: a kill between the two re-runs the
        cell and appends a second frontier (deduplicated by the dominance
        filter at merge/load time) — completed cells are never lost."""
        self.append_points(cell.cell_id, entries)
        self.append_summary(cell.cell_id, summary)
        self.manifest["cells"][cell.cell_id] = dict(
            status=STATUS_DONE, completed=time.strftime("%Y-%m-%dT%H:%M:%S"),
            **{k: summary[k] for k in ("ppa_score", "episodes", "wall_s",
                                       "gate_open_episode", "screened",
                                       "evaluated")
               if k in summary})
        self.save_manifest()

    def all_done(self) -> bool:
        cs = self.manifest["cells"].values()
        return bool(cs) and all(c["status"] == STATUS_DONE for c in cs)

    # ------------------------------------------------------------- archives
    def _cell_path(self, cell_id: str) -> str:
        return os.path.join(self.root, "cells", f"{cell_id}.jsonl")

    def _torn_tail(self, path: str) -> bool:
        """True if a previous writer died mid-line (see fsutil.torn_tail);
        the next append then starts on a fresh line so the torn tail stays
        one skippable line instead of corrupting the new record too."""
        return fsutil.torn_tail(path)

    def _append_line(self, cell_id: str, payload: Dict) -> None:
        self.append_lines(cell_id, [payload])

    def append_lines(self, cell_id: str, payloads: List[Dict]) -> None:
        """Append records as JSONL lines (one fsync for the whole chunk)."""
        if not payloads:
            return
        os.makedirs(os.path.join(self.root, "cells"), exist_ok=True)
        path = self._cell_path(cell_id)
        lead = "\n" if self._torn_tail(path) else ""
        with open(path, "a") as f:
            for p in payloads:
                f.write(lead + json.dumps(p, allow_nan=False) + "\n")
                lead = ""
            f.flush()
            os.fsync(f.fileno())

    def append_points(self, cell_id: str,
                      entries: List[ArchiveEntry]) -> None:
        """Append evaluated design points (one JSONL line per point)."""
        self.append_lines(cell_id, [dict(kind="point", **e.to_dict())
                                    for e in entries])

    def append_summary(self, cell_id: str, summary: Dict) -> None:
        """Append a best-PPA summary record (reconciler + complete_cell)."""
        self._append_line(cell_id, dict(
            kind="summary", **{k: v for k, v in summary.items()
                               if k != "kind"}))

    def load_archive(self, cell_id: str) -> ParetoArchive:
        """Rebuild the cell's Pareto archive from its JSONL (dominance-
        filtered union over every appended chunk/run)."""
        ar = ParetoArchive()
        path = self._cell_path(cell_id)
        if os.path.isfile(path):
            ar.insert_batch(_dedupe([
                ArchiveEntry.from_dict(rec) for rec in _read_jsonl(path)
                if rec.get("kind") == "point"]))
        return ar

    def _point_keys(self, cell_id: str) -> set:
        """Keys of every point record physically in the cell's JSONL —
        including dominated/duplicate lines the filtered archive drops —
        so merge appends can skip anything already on disk."""
        path = self._cell_path(cell_id)
        if not os.path.isfile(path):
            return set()
        return {_entry_key(ArchiveEntry.from_dict(rec))
                for rec in _read_jsonl(path) if rec.get("kind") == "point"}

    def load_summary(self, cell_id: str) -> Optional[Dict]:
        """Last summary line of the cell (None if never completed)."""
        path = self._cell_path(cell_id)
        out = None
        if os.path.isfile(path):
            for rec in _read_jsonl(path):
                if rec.get("kind") == "summary":
                    out = rec
        return out

    def summaries(self) -> Dict[str, Dict]:
        return {cid: s for cid in self.manifest["cells"]
                if (s := self.load_summary(cid)) is not None}

    def archive_index(self, extra_roots: Optional[List[str]] = None
                      ) -> Dict[str, ParetoArchive]:
        """Merged per-cell frontier index: the serving layer's source of
        truth (``launch/recommend`` in the reference).

        Unions this run directory's per-cell archives with those of
        ``extra_roots`` (other reconciled campaign run dirs over any grid)
        via :func:`merge_runs` — dominance-filtered, duplicate-free, keyed
        by ``cell_id``.  Merge semantics persist the union into THIS
        store's JSONL, so re-opening the primary root after background
        fleets append new frontiers rebuilds an up-to-date index and the
        extra roots never need re-reading."""
        return merge_runs(self, list(extra_roots or []))

    # ----------------------------------------------------------- checkpoints
    def ckpt_dir(self, batch_id: str) -> str:
        return os.path.join(self.root, "ckpt", batch_id)

    # ------------------------------------------------------ persistent model
    def model_dir(self) -> str:
        """``<root>/model/``: the campaign's persistent learned artifacts —
        the fitted cost model (``model/cost/``), its held-out eval
        (``model/eval.json``) and per-batch final weights
        (``model/weights/<batch_id>/``) that future campaigns warm-start
        from (``campaign/transfer`` in the reference)."""
        return os.path.join(self.root, "model")

    def weights_dir(self, batch_id: str) -> str:
        return os.path.join(self.model_dir(), "weights", batch_id)

    def clear_ckpt(self, batch_id: str) -> None:
        shutil.rmtree(self.ckpt_dir(batch_id), ignore_errors=True)


def _entry_key(e: ArchiveEntry) -> tuple:
    """Identity of a frontier point for dedup/merge (design + objectives)."""
    return (tuple(e.cfg.round(6).tolist()), e.power_mw, e.perf_gops,
            e.area_mm2)


def _dedupe(entries: List[ArchiveEntry]) -> List[ArchiveEntry]:
    """Drop exact duplicates (same design point + objectives): duplicates
    are mutually non-dominating, so without this a re-appended chunk would
    inflate the frontier."""
    out, keyset = [], set()
    for e in entries:
        k = _entry_key(e)
        if k not in keyset:
            keyset.add(k)
            out.append(e)
    return out


def merge_runs(dst: CampaignStore, src_roots: List[str]
               ) -> Dict[str, ParetoArchive]:
    """Union per-cell archives from other run directories into ``dst``.

    For every cell id present in any source, the source frontier points are
    inserted into dst's archive with dominance filtering, and the entries of
    the merged frontier *not already on dst's disk* are appended to dst's
    JSONL (a fresh ``load_archive`` then reconstructs exactly the merged
    frontier).  Returns the merged archives.

    Only genuinely novel lines are appended: the dedup key set is built
    from dst's raw on-disk point records — NOT the dominance-filtered
    archive, which undercounts what is physically in the file — so
    repeated merges (the serving re-index path calls ``archive_index()``
    per rebuild, warm-start lookups per batch) keep ``cells/*.jsonl`` at
    O(total distinct points) instead of re-appending the whole frontier
    every time one novel point shows up.
    """
    merged: Dict[str, ParetoArchive] = {}
    cell_ids = set(dst.manifest["cells"])
    srcs = [CampaignStore.open(r) for r in src_roots]
    for s in srcs:
        cell_ids |= set(s.manifest["cells"])
    for cid in sorted(cell_ids):
        own = dst.load_archive(cid)
        pool = list(own.entries)
        for s in srcs:
            pool.extend(s.load_archive(cid).entries)
        ar = ParetoArchive()
        ar.insert_batch(_dedupe(pool))
        on_disk = dst._point_keys(cid)
        novel = [e for e in ar.entries if _entry_key(e) not in on_disk]
        if novel:
            dst.append_points(cid, novel)
        merged[cid] = ar
    return merged
