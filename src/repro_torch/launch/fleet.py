"""Fleet launcher + supervisor: self-healing multi-process campaign
workers (port of ``repro.launch.fleet``).

``repro_torch.launch.dse --campaign grid.json --workers W`` routes here.
The planner's cell batches are dealt deterministically to W workers
(``repro_torch.campaign.distrib.shard_batches``); each worker is spawned
through a :class:`Launcher` — locally as

    python -m repro_torch.launch.fleet --root <run-dir> --worker <i> \
        --device <cuda|cpu>

on the device the parent was given (W workers share one card), or on a
remote host via a command template (``--launch-template`` / ``--hosts``,
e.g. ``ssh {host} python -m repro_torch.launch.fleet --root {root}
--worker {worker} --device {device}``) — and runs its own
``run_search_cells`` loop with its own checkpoints under
``<run-dir>/worker-<i>/``.  A CUDA worker without a card raises; no
worker carries on on the CPU.

**Lease/heartbeat protocol**: every worker refreshes
``worker-<i>/lease.json`` (pid, host, ts, current batch) on a short
interval through the fsync'd atomic writer, so liveness is observable
from the shared run directory alone — no process handle needed.

**Supervisor** (the default ``FleetHandle.wait()``): polls worker
handles AND leases, incrementally reconciles each finished worker's
results, and when a worker dies — observed exit, or lease expired on a
hung one (which is then killed) — re-deals its still-pending batches to
a FRESH worker slot mid-run, relocating in-flight checkpoints with the
same machinery a fleet ``--resume`` uses, so the re-dealt batch restores
bit-for-bit and the final fingerprint matches an uninterrupted run.
Evictions and re-deals are recorded as events in the manifest's fleet
block and surface in ``report/workers.*``.  Per-batch re-deals are
capped (``max_redeals``) so a deterministically-crashing batch cannot
respawn forever; what cannot be healed is left pending for ``--resume``.

``wait(supervise=False)`` keeps the fire-and-reconcile behavior: no
re-deals, but it still polls with a timeout instead of blocking
sequentially and reconciles each worker's results as soon as that worker
exits.

The reference's workers share a persistent XLA compile cache
(``REPRO_FLEET_COMPILE_CACHE``).  The port's counterpart is the kernel
library: before a local CUDA fleet spawns, the parent builds it once
(``repro_torch.kernels.build.build``), so W workers load one ``.so``
instead of running W ``nvcc`` builds; there is no environment variable.

Workers only ever touch the shared run directory, so the same layout
shards across hosts over a shared filesystem: the command-template
launcher just runs the worker entry point remotely.  A zombie remote
worker that outlives its lease writes only bit-identical results (batch
seeds are global), so a re-deal can never fork the campaign's outcome.

**Live status** (``python -m repro_torch.launch.fleet --root R --status``):
renders per-worker throughput / current batch / gate state purely from
the leases each heartbeat already refreshes — every lease carries a
metrics snapshot (``repro_torch.obs.metrics``), so the view needs no
sockets and no extra files, and works for remote workers over the shared
FS.
The supervisor parent also traces to ``<root>/trace.jsonl``; merge it
with the workers' via ``python -m repro_torch.obs.export --root R``.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shlex
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from repro_torch.obs import trace as obs_trace

#: default remote template; ``{python}`` resolves to the LOCAL
#: interpreter path and is usually wrong across hosts — the default
#: assumes ``python`` on the remote PATH imports repro_torch.
DEFAULT_REMOTE_TEMPLATE = ("ssh {host} python -m repro_torch.launch.fleet "
                           "--root {root} --worker {worker} "
                           "--device {device}")


class FleetError(RuntimeError):
    """One or more workers exited non-zero / timed out and the campaign
    could not be healed (results so far are reconciled; rerun with
    --resume to re-deal the unfinished batches)."""


def _worker_env() -> Dict[str, str]:
    """Child env: the port's ``src`` first on ``PYTHONPATH``, so a worker
    imports the same ``repro_torch`` as its parent."""
    import repro_torch
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    parts = [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                     if p and p != src]
    env["PYTHONPATH"] = os.pathsep.join(parts)
    return env


def prepare_device(device) -> None:
    """Resolve the workers' device in the parent (a CUDA request without a
    card raises here, before any worker is spawned) and, for CUDA, build
    the kernel library once so the workers load it instead of each
    running ``nvcc``."""
    from repro_torch import device as device_mod
    if device_mod.resolve(device).type == "cuda":
        from repro_torch.kernels import build
        build.build()


# ---------------------------------------------------------------- launchers
@dataclasses.dataclass
class WorkerProc:
    """One spawned worker: the process handle plus its spawn timestamp
    (the supervisor's boot-grace reference before the first lease)."""
    proc: subprocess.Popen
    spawned_ts: float

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def wait(self, timeout: Optional[float] = None) -> int:
        return self.proc.wait(timeout)

    def send_signal(self, sig: int) -> None:
        self.proc.send_signal(sig)

    @property
    def returncode(self) -> Optional[int]:
        return self.proc.returncode

    @property
    def pid(self) -> int:
        return self.proc.pid


class Launcher:
    """Spawns one worker process for a slot.  Implementations must leave
    the worker's protocol untouched: the child runs
    ``repro_torch.launch.fleet --root <root> --worker <idx> --device <dev>``
    against the shared run directory."""

    def to_config(self) -> Optional[Dict]:
        """Serializable form recorded in the fleet block (None = local),
        so a ``--resume`` respawns workers the same way."""
        return None

    def spawn(self, root: str, idx: int,
              env: Optional[Dict[str, str]] = None) -> WorkerProc:
        raise NotImplementedError

    def _popen(self, cmd: List[str], root: str, idx: int,
               env: Optional[Dict[str, str]]) -> WorkerProc:
        from repro_torch.campaign.distrib import worker_root
        wroot = worker_root(root, idx)
        os.makedirs(wroot, exist_ok=True)
        with open(os.path.join(wroot, "worker.log"), "ab") as log:
            proc = subprocess.Popen(cmd, env=env, stdout=log,
                                    stderr=subprocess.STDOUT)
        return WorkerProc(proc=proc, spawned_ts=time.time())


class LocalLauncher(Launcher):
    """Default: worker subprocesses on this machine, on ``device`` (the
    parent's; W local workers share one card)."""

    def __init__(self, device="cuda"):
        self.device = str(device)

    def spawn(self, root: str, idx: int,
              env: Optional[Dict[str, str]] = None) -> WorkerProc:
        return self._popen(
            [sys.executable, "-m", "repro_torch.launch.fleet",
             "--root", root, "--worker", str(idx), "--device", self.device],
            root, idx, env)


class CommandLauncher(Launcher):
    """Spawn workers through a command template (ssh, srun, kubectl ...).

    ``template`` is formatted with ``{host}``, ``{root}``, ``{worker}``,
    ``{device}`` and ``{python}`` then shlex-split; slot ``i`` runs on
    ``hosts[i % len(hosts)]`` (re-dealt fresh slots rotate over the same
    hosts).  The local process is the transport (e.g. the ssh client):
    its exit code stands in for the remote worker's, and killing it does
    NOT kill a hung remote — the lease protocol is what makes such a
    zombie harmless (it only ever writes bit-identical results)."""

    def __init__(self, template: str, hosts: Optional[List[str]] = None,
                 device="cuda"):
        if "{root}" not in template or "{worker}" not in template:
            raise ValueError(
                "launch template must reference {root} and {worker} "
                f"(got {template!r})")
        if "{host}" in template and not hosts:
            raise ValueError("launch template references {host} but no "
                             "hosts were given")
        self.template = template
        self.hosts = list(hosts) if hosts else None
        self.device = str(device)

    def to_config(self) -> Optional[Dict]:
        return dict(template=self.template, hosts=self.hosts)

    def command(self, root: str, idx: int) -> List[str]:
        host = self.hosts[idx % len(self.hosts)] if self.hosts else ""
        return shlex.split(self.template.format(
            host=host, root=root, worker=idx, device=self.device,
            python=sys.executable))

    def spawn(self, root: str, idx: int,
              env: Optional[Dict[str, str]] = None) -> WorkerProc:
        return self._popen(self.command(root, idx), root, idx, env)


def make_launcher(template: Optional[str] = None,
                  hosts: Optional[List[str]] = None,
                  device="cuda") -> Launcher:
    """Launcher from CLI/grid inputs: a template (and optional hosts)
    or hosts alone (default ssh template); neither = local processes.
    Every worker it spawns runs on ``device``."""
    if template:
        return CommandLauncher(template, hosts, device)
    if hosts:
        return CommandLauncher(DEFAULT_REMOTE_TEMPLATE, hosts, device)
    return LocalLauncher(device)


# ------------------------------------------------------------- fleet handle
@dataclasses.dataclass
class FleetHandle:
    """A launched fleet: the worker processes plus supervision.

    ``wait()`` runs the elastic supervisor by default: it polls handles
    and leases, reconciles finished workers' results incrementally, and
    re-deals dead/hung workers' pending batches to fresh slots mid-run —
    raising :class:`FleetError` only if the campaign could not be healed.
    ``wait(supervise=False)`` polls without re-dealing (reconciling
    opportunistically as workers exit) and raises if any worker failed,
    pointing at ``--resume``."""
    root: str
    procs: Dict[int, WorkerProc]
    progress: object = print
    launcher: Launcher = dataclasses.field(default_factory=LocalLauncher)
    poll_s: float = 0.2
    boot_grace_s: float = 120.0
    tracer: Optional[object] = None

    def kill(self, idx: int, sig: int = signal.SIGKILL) -> None:
        self.procs[idx].send_signal(sig)

    def status(self) -> Dict:
        """Live fleet view assembled from the workers' leases alone
        (:func:`fleet_status`)."""
        return fleet_status(self.root)

    # ------------------------------------------------------------- waiting
    def wait(self, raise_on_failure: bool = True, *,
             supervise: bool = True, timeout: Optional[float] = None,
             max_redeals: int = 2):
        try:
            if supervise:
                return self._supervise(raise_on_failure, timeout,
                                       max_redeals)
            return self._wait_plain(raise_on_failure, timeout)
        finally:
            # the parent trace ends with the supervision, even on a
            # FleetError path (emit() on a closed tracer is a no-op, so
            # stray late spans are harmless)
            if self.tracer is not None:
                if obs_trace.current_tracer() is self.tracer:
                    obs_trace.install_tracer(None)
                self.tracer.close()

    def _reconcile_now(self, store=None):
        """Incremental reconcile (workers may still be running: torn
        JSONL tails are skipped, the manifest flip is atomic, and only
        this parent writes the top-level manifest)."""
        from repro_torch.campaign.distrib import reconcile
        from repro_torch.campaign.store import CampaignStore
        store = store or CampaignStore.open(self.root)
        reconcile(store, progress=self.progress)
        return store

    def _wait_plain(self, raise_on_failure: bool, timeout: Optional[float]):
        """Poll (not block) until every worker exits, reconciling each
        worker's results as soon as IT exits — a hung worker no longer
        defers reconciliation of the finished ones.  ``timeout`` bounds
        the whole wait; on expiry the workers are left running and
        :class:`FleetError` is raised."""
        deadline = None if timeout is None else time.time() + timeout
        live = dict(self.procs)
        while live:
            for idx in sorted(live):
                if live[idx].poll() is not None:
                    del live[idx]
                    self._reconcile_now()
            if not live:
                break
            if deadline is not None and time.time() > deadline:
                raise FleetError(
                    f"fleet wait timed out after {timeout}s with "
                    f"worker(s) {sorted(live)} still running; they were "
                    f"left alive — kill() them or --resume {self.root} "
                    "later")
            time.sleep(self.poll_s)
        store = finalize_fleet(self.root, progress=self.progress)
        failed = {i: p.returncode for i, p in self.procs.items()
                  if p.returncode != 0}
        if failed and raise_on_failure:
            raise FleetError(
                f"worker(s) {sorted(failed)} exited non-zero "
                f"({failed}); completed cells are reconciled — rerun with "
                f"--resume {self.root} to re-deal the unfinished batches")
        return store

    # ---------------------------------------------------------- supervisor
    def _supervise(self, raise_on_failure: bool, timeout: Optional[float],
                   max_redeals: int):
        """The elastic loop: leases + handles in, re-deals out."""
        from repro_torch.campaign import distrib
        from repro_torch.campaign.store import (DEFAULT_LEASE_TTL_S,
                                                CampaignStore, lease_expired,
                                                read_lease)
        store = CampaignStore.open(self.root)
        fleet = store.manifest.get("fleet") or {}
        ttl = float(fleet.get("lease_ttl_s") or DEFAULT_LEASE_TTL_S)
        deadline = None if timeout is None else time.time() + timeout
        live = dict(self.procs)
        next_slot = max(live, default=-1) + 1
        redeals: Dict[str, int] = {}
        unhealed = False
        next_lease_check = 0.0
        while live:
            # handles are polled every tick; leases only need checking at
            # TTL granularity (a worker refreshes every ttl/4), so the
            # steady-state supervisor stays out of the shared FS
            now = time.time()
            check_leases = now >= next_lease_check
            if check_leases:
                next_lease_check = now + max(self.poll_s, ttl / 4.0)
            for idx in sorted(live):
                h = live[idx]
                rc = h.poll()
                now = time.time()
                lease = (read_lease(distrib.worker_root(self.root, idx))
                         if check_leases and rc is None else None)
                if lease and float(lease.get("ts") or 0.0) < h.spawned_ts:
                    # leftover from a previous leg's occupant of this
                    # slot dir, not this process: judging the fresh
                    # worker by it would SIGKILL it mid-boot.  Boot
                    # grace governs until ITS first beat lands.
                    lease = None
                hung = rc is None and check_leases and (
                    lease_expired(lease, now=now, ttl_s=ttl)
                    or (lease is None
                        and now - h.spawned_ts > self.boot_grace_s))
                if rc is None and not hung:
                    continue
                if hung:
                    # lease expired but the process handle lives: a hung
                    # worker (or a dead remote behind a live transport).
                    # Evict it — after a full TTL of silence it either
                    # cannot write anymore or will only write
                    # bit-identical results.
                    h.send_signal(signal.SIGKILL)
                    try:
                        h.wait(timeout=10.0)
                    except Exception:
                        pass
                    rc = h.poll()
                del live[idx]
                self._reconcile_now(store)
                # reconcile pruned the deal to pending-only batches, so
                # what still maps to this slot is exactly what it lost
                assignments = store.manifest["fleet"]["assignments"]
                mine = sorted(b for b, w in assignments.items()
                              if w == idx)
                if rc == 0 and not mine:
                    continue                     # clean, complete exit
                reason = "lease-expired" if hung else f"exit-{rc}"
                distrib.record_event(store, "evict", worker=idx,
                                     reason=reason, returncode=rc,
                                     pending=mine)
                gave_up = [b for b in mine
                           if redeals.get(b, 0) >= max_redeals]
                todo = [b for b in mine if b not in gave_up]
                if gave_up:
                    unhealed = True
                    distrib.record_event(store, "gave-up", worker=idx,
                                         batches=gave_up,
                                         max_redeals=max_redeals)
                    self.progress(
                        f"[fleet] giving up on batch(es) {gave_up} after "
                        f"{max_redeals} re-deal(s); left pending for "
                        "--resume")
                if todo:
                    new_idx = next_slot
                    next_slot += 1
                    for b in todo:
                        redeals[b] = redeals.get(b, 0) + 1
                    distrib.redeal_batches(store, todo, new_idx)
                    distrib.record_event(store, "redeal", from_worker=idx,
                                         to_worker=new_idx, batches=todo,
                                         reason=reason)
                    f = store.manifest["fleet"]
                    if "started_ts" not in f:
                        # the reconcile above may have closed the leg as
                        # stale (evicting the LAST hung worker happens a
                        # full TTL after its final beat) — reopen it for
                        # the fresh worker so its run is billed
                        f["wall_base_s"] = float(f.get("wall_s") or 0.0)
                        f["started_ts"] = time.time()
                    store.save_manifest()
                    self.progress(
                        f"[fleet] worker {idx} down ({reason}); re-dealt "
                        f"{len(todo)} batch(es) to fresh slot {new_idx}")
                    wp = self.launcher.spawn(self.root, new_idx,
                                             _worker_env())
                    obs_trace.instant("worker_spawned", cat="fleet",
                                      worker=new_idx)
                    live[new_idx] = self.procs[new_idx] = wp
                else:
                    store.save_manifest()        # publish the events
            if not live:
                break
            if deadline is not None and time.time() > deadline:
                raise FleetError(
                    f"fleet supervision timed out after {timeout}s with "
                    f"worker(s) {sorted(live)} still running")
            time.sleep(self.poll_s)
        store = finalize_fleet(self.root, progress=self.progress)
        if raise_on_failure and (unhealed or not store.all_done()):
            pend = [b.batch_id for b in distrib.pending_batches(store)]
            raise FleetError(
                f"fleet could not be fully healed: batch(es) {pend} "
                f"still pending after supervision; completed cells are "
                f"reconciled — rerun with --resume {self.root}")
        return store


def fleet_status(root: str, now: Optional[float] = None) -> Dict:
    """Live fleet view from the shared run directory alone.

    Reads the top-level manifest plus every ``worker-*/lease.json`` —
    the file each heartbeat already refreshes with a metrics snapshot —
    so the view needs no sockets, no process handles, and works for
    remote workers over the shared filesystem.  Each worker row carries
    its lease state (``live`` / ``stale`` / ``done`` / ``no-lease``),
    current batch, lease age, and the headline search metrics; the full
    snapshot rides along under ``metrics`` for callers that want more."""
    from repro_torch.campaign.store import (DEFAULT_LEASE_TTL_S,
                                            lease_expired, read_lease)
    from repro_torch.obs.metrics import snapshot_value
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    now = time.time() if now is None else now
    fleet = manifest.get("fleet") or {}
    ttl = float(fleet.get("lease_ttl_s") or DEFAULT_LEASE_TTL_S)
    cells = manifest.get("cells") or {}
    rows: List[Dict] = []
    for wdir in sorted(glob.glob(os.path.join(root, "worker-*"))):
        if not os.path.isdir(wdir):
            continue
        name = os.path.basename(wdir)
        lease = read_lease(wdir)
        if lease is None:
            rows.append(dict(worker=name, state="no-lease", batch=None,
                             age_s=None, metrics=None))
            continue
        state = ("done" if lease.get("done")
                 else "stale" if lease_expired(lease, now=now, ttl_s=ttl)
                 else "live")
        snap = lease.get("metrics")
        rows.append(dict(
            worker=name, state=state, batch=lease.get("batch"),
            age_s=round(max(0.0, now - float(lease.get("ts") or 0.0)), 1),
            pid=lease.get("pid"), host=lease.get("host"),
            env_steps_s=snapshot_value(snap, "gauges", "env_steps_per_s"),
            gate_open_frac=snapshot_value(snap, "gauges",
                                          "gate_open_frac"),
            eps=snapshot_value(snap, "gauges", "search_eps"),
            best_score=snapshot_value(snap, "gauges", "best_score"),
            env_steps=snapshot_value(snap, "counters", "env_steps_total"),
            batches_started=snapshot_value(snap, "counters",
                                           "batches_started"),
            metrics=snap))
    return dict(
        root=root, name=manifest.get("name"), lease_ttl_s=ttl,
        cells_done=sum(1 for r in cells.values()
                       if r.get("status") == "done"),
        cells_total=len(cells),
        pending_batches=len(fleet.get("assignments") or {}),
        events=len(fleet.get("events") or []),
        workers=rows)


def render_status(status: Dict) -> str:
    """Human rendering of :func:`fleet_status` (the ``--status`` CLI)."""
    def _n(v, fmt: str) -> str:
        return "-" if v is None else format(v, fmt)

    head = (f"fleet {status['name']}: {status['cells_done']}/"
            f"{status['cells_total']} cells done, "
            f"{status['pending_batches']} batch(es) dealt, "
            f"{status['events']} event(s), "
            f"lease ttl {status['lease_ttl_s']:g}s")
    workers = status["workers"]
    if not workers:
        return head + "\n  (no worker directories yet)"
    table = [("worker", "state", "batch", "age", "steps/s", "gate",
              "eps", "env-steps", "best")]
    for r in workers:
        table.append((
            str(r["worker"]), r["state"], str(r.get("batch") or "-"),
            "-" if r.get("age_s") is None else f"{r['age_s']:.1f}s",
            _n(r.get("env_steps_s"), ",.0f"),
            _n(r.get("gate_open_frac"), ".2f"),
            _n(r.get("eps"), ".3f"),
            _n(r.get("env_steps"), ",.0f"),
            _n(r.get("best_score"), ".4f")))
    widths = [max(len(row[i]) for row in table)
              for i in range(len(table[0]))]
    lines = [head] + ["  " + "  ".join(c.ljust(w) for c, w
                                       in zip(row, widths)).rstrip()
                      for row in table]
    live = [r for r in workers if r["state"] == "live"]
    total = sum(r.get("env_steps_s") or 0.0 for r in live)
    lines.append(f"  fleet throughput: {total:,.0f} env-steps/s over "
                 f"{len(live)} live worker(s)")
    return "\n".join(lines)


def finalize_fleet(root: str, progress=print):
    """Reconcile worker results into the top-level store + write reports."""
    from repro_torch.campaign.distrib import reconcile
    from repro_torch.campaign.report import write_reports
    from repro_torch.campaign.store import CampaignStore
    store = CampaignStore.open(root)
    reconcile(store, progress=progress, freeze_clock=True)
    with obs_trace.span("write_reports", cat="fleet"):
        write_reports(store)
    done = sum(r["status"] == "done"
               for r in store.manifest["cells"].values())
    progress(f"[fleet] {store.manifest['name']}: {done}/"
             f"{len(store.manifest['cells'])} cells done, "
             f"all_done={store.all_done()} -> {root}")
    return store


def launch_fleet(root: str, spec=None, *, workers: Optional[int] = None,
                 resume: bool = False, progress=print,
                 launcher: Optional[Launcher] = None,
                 lease_ttl_s: Optional[float] = None,
                 device="cuda") -> FleetHandle:
    """Deal the campaign's batches to ``workers`` worker processes.

    Fresh launch needs ``spec``; ``resume=True`` reopens ``root``
    (reconciling first, re-dealing pending batches, relocating
    checkpoints).  ``launcher`` defaults to local subprocesses on
    ``device`` — on resume, a launcher recorded in the fleet block (command
    template + hosts) is reused unless one is passed explicitly, and its
    workers run on ``device`` too.  A local fleet resolves ``device`` in
    this process first (raising for CUDA without a card) and, for CUDA,
    builds the kernels once.  Returns a :class:`FleetHandle`; call
    ``.wait()``."""
    from repro_torch.campaign import distrib
    from repro_torch.campaign.store import DEFAULT_LEASE_TTL_S
    if workers is not None and workers < 1:
        raise ValueError(f"workers must be >= 1 (got {workers})")
    if lease_ttl_s is not None and lease_ttl_s <= 0:
        raise ValueError(f"lease_ttl_s must be > 0 (got {lease_ttl_s})")
    if launcher is None or isinstance(launcher, LocalLauncher):
        prepare_device(getattr(launcher, "device", device))
    if resume:
        store = distrib.plan_resume(root, workers,
                                    lease_ttl_s=lease_ttl_s, device=device)
    else:
        if spec is None:
            raise ValueError("a CampaignSpec is required to start a fleet")
        store = distrib.create_fleet(
            root, spec, int(workers or 1),
            lease_ttl_s=(lease_ttl_s if lease_ttl_s is not None
                         else DEFAULT_LEASE_TTL_S), device=device)
    fleet = store.manifest["fleet"]
    if launcher is None:
        cfg = fleet.get("launcher")
        if cfg:
            launcher = CommandLauncher(cfg["template"], cfg.get("hosts"),
                                       device)
        elif getattr(store.spec, "hosts", None):
            launcher = make_launcher(hosts=store.spec.hosts, device=device)
        else:
            launcher = LocalLauncher(device)
    if fleet.get("launcher") != launcher.to_config():
        fleet["launcher"] = launcher.to_config()
        store.save_manifest()
    assignments = fleet["assignments"]
    # the supervisor parent traces to <root>/trace.jsonl (closed when
    # wait() returns); a caller with its own tracer installed keeps it
    tracer = None
    if obs_trace.current_tracer() is None and not obs_trace.tracing_disabled():
        tracer = obs_trace.Tracer(
            os.path.join(root, obs_trace.TRACE_NAME), proc="fleet")
        obs_trace.install_tracer(tracer)
    env = _worker_env()
    procs: Dict[int, WorkerProc] = {}
    for idx in sorted(set(assignments.values())):
        procs[idx] = launcher.spawn(root, idx, env)
        obs_trace.instant("worker_spawned", cat="fleet", worker=idx)
    n_batches = len(assignments)
    progress(f"[fleet] {store.manifest['name']}: {len(procs)} workers x "
             f"{n_batches} batches"
             + (" (resume)" if resume else "")
             + (": nothing pending" if not n_batches else ""))
    return FleetHandle(root=root, procs=procs, progress=progress,
                       launcher=launcher, tracer=tracer)


def run_fleet(root: str, spec=None, *, workers: Optional[int] = None,
              resume: bool = False, progress=print,
              launcher: Optional[Launcher] = None,
              lease_ttl_s: Optional[float] = None, supervise: bool = True,
              max_redeals: int = 2, device="cuda"):
    """launch_fleet + wait: the blocking one-call fleet run."""
    return launch_fleet(root, spec, workers=workers, resume=resume,
                        progress=progress, launcher=launcher,
                        lease_ttl_s=lease_ttl_s, device=device
                        ).wait(supervise=supervise, max_redeals=max_redeals)


def main(argv: Optional[List[str]] = None) -> None:
    """Worker entry point (the parent CLI is ``repro_torch.launch.dse``),
    plus the ``--status`` live fleet view."""
    ap = argparse.ArgumentParser(
        description="fleet worker process (spawned by launch_fleet), or "
                    "--status for the lease-based live fleet view")
    ap.add_argument("--root", required=True,
                    help="campaign run directory (shared with the parent)")
    ap.add_argument("--worker", type=int, default=None,
                    help="this worker's slot index in the manifest deal")
    ap.add_argument("--device", default="cuda",
                    help="torch device of this worker: cuda (default) or "
                         "cpu; a cuda worker without a card raises")
    ap.add_argument("--status", action="store_true",
                    help="render the live fleet view from worker leases "
                         "and exit")
    ap.add_argument("--json", action="store_true",
                    help="with --status: print the raw status dict as "
                         "JSON instead of the table")
    a = ap.parse_args(argv)
    if a.status and a.worker is not None:
        ap.error("--status and --worker are mutually exclusive")
    if not a.status and a.worker is None:
        ap.error("--worker is required (or pass --status for the live "
                 "fleet view)")
    if a.json and not a.status:
        ap.error("--json only applies to --status")
    if a.worker is not None and a.worker < 0:
        ap.error(f"--worker must be >= 0 (got {a.worker})")
    manifest_path = os.path.join(a.root, "manifest.json")
    if not os.path.isfile(manifest_path):
        ap.error(f"--root: no campaign manifest at {manifest_path}")
    if a.status:
        status = fleet_status(a.root)
        print(json.dumps(status, indent=2) if a.json
              else render_status(status))
        return
    with open(manifest_path) as f:
        fleet = json.load(f).get("fleet")
    if not fleet:
        ap.error(f"--root {a.root} is not a fleet campaign (no fleet "
                 "block in manifest.json); launch it with --workers "
                 "via repro_torch.launch.dse first")
    slots = sorted(set((fleet.get("assignments") or {}).values()))
    if a.worker not in slots:
        desc = (f"slots with work: {slots}" if slots
                else "the deal is empty — campaign complete")
        ap.error(f"--worker {a.worker} has no batches in the recorded "
                 f"deal ({desc}); re-deal with repro_torch.launch.dse "
                 "--resume --workers N")
    from repro_torch.campaign.distrib import run_worker
    run_worker(a.root, a.worker, device=a.device)


if __name__ == "__main__":
    main()
