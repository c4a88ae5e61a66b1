"""The ported elastic fleet supervisor on the CPU (no searches; mirrors
``tests/test_fleet_supervisor.py``): the lease/heartbeat protocol,
hung-worker eviction with capped re-deals, opportunistic non-blocking
``wait``, the stale-leg wall-clock fix, the single-plan-derivation
memoization, worker and dse CLI validation, and leases and fleet manifests
read by the reference."""
import json
import os
import signal
import time

import pytest

import repro.campaign.store as ref_store
import repro_torch.campaign.distrib as distrib_mod
import repro_torch.campaign.planner as planner_mod
from repro_torch.campaign import CampaignSpec, CampaignStore
from repro_torch.campaign.distrib import (Heartbeat, create_fleet,
                                          pending_batches, reconcile,
                                          worker_root)
from repro_torch.campaign.planner import plan, plan_cached
from repro_torch.campaign.store import (lease_expired, lease_path,
                                        read_lease, write_lease)
from repro_torch.core import fsutil
from repro_torch.launch import dse
from repro_torch.launch import fleet as fleet_mod

ARCH = "smollm-135m"
GRID = os.path.join(os.path.dirname(__file__), os.pardir,
                    "examples", "grids", "ci_smoke.json")
_silent = lambda m: None


def tiny_spec(name, **kw):
    base = dict(name=name, workloads=[ARCH], nodes=[3, 5],
                modes=["high_perf"], episodes=8, lanes=4, max_envs=4,
                seed=0, seq_len=256, batch=1)
    base.update(kw)
    return CampaignSpec(**base)


# ------------------------------------------------------------------ leases
def test_lease_write_read_refresh_expiry(tmp_path):
    wdir = str(tmp_path / "worker-0")
    assert read_lease(wdir) is None
    lease = write_lease(wdir, worker=0, batch="b000", ttl_s=5.0)
    got = read_lease(wdir)
    assert got == lease
    assert got["pid"] == os.getpid() and got["host"]
    assert got["batch"] == "b000" and not got["done"]
    assert not lease_expired(got)
    # refresh advances ts; expiry is TTL past the LAST refresh
    time.sleep(0.02)
    newer = write_lease(wdir, worker=0, batch="b001", ttl_s=5.0)
    assert newer["ts"] > got["ts"]
    assert lease_expired(dict(newer, ts=newer["ts"] - 6.0))
    assert not lease_expired(dict(newer, ts=newer["ts"] - 4.0))
    # per-call TTL override + the missing/done cases never expire
    assert lease_expired(dict(newer, ts=newer["ts"] - 1.0), ttl_s=0.5)
    assert not lease_expired(None)
    assert not lease_expired(dict(newer, ts=0.0, done=True))
    # an explicit zero TTL expires at once, as in the reference
    assert lease_expired(dict(newer, ttl_s=0.0, ts=newer["ts"] - 0.01))
    # the reference reads and judges the port's lease alike
    assert ref_store.read_lease(wdir) == newer
    for ago in (4.0, 6.0):
        old = dict(newer, ts=newer["ts"] - ago)
        assert ref_store.lease_expired(old) == lease_expired(old)


def test_heartbeat_refreshes_and_marks_done(tmp_path):
    wdir = str(tmp_path / "worker-3")
    hb = Heartbeat(wdir, 3, ttl_s=0.8).start()
    try:
        first = read_lease(wdir)
        assert first is not None and first["worker"] == 3
        hb.beat("b007")
        assert read_lease(wdir)["batch"] == "b007"
        # the background thread refreshes without further beats
        ts = read_lease(wdir)["ts"]
        deadline = time.time() + 5.0
        while time.time() < deadline and read_lease(wdir)["ts"] <= ts:
            time.sleep(0.05)
        assert read_lease(wdir)["ts"] > ts, "heartbeat thread never fired"
    finally:
        hb.stop()
    final = read_lease(wdir)
    assert final["done"], "clean stop must write a done lease"
    # a crash-path stop must NOT read done
    hb2 = Heartbeat(wdir, 3, ttl_s=0.8).start()
    hb2.stop(done=False)
    assert not read_lease(wdir)["done"]


# ------------------------------------------------------- supervisor (stubs)
class FakeProc:
    """Stub worker handle: exits with ``rc`` once ``exit_after`` seconds
    have passed (never, if None); SIGKILL forces an immediate -9."""

    def __init__(self, rc=0, exit_after=None):
        self._rc, self._exit_at = rc, (
            None if exit_after is None else time.time() + exit_after)
        self.signals = []
        self.spawned_ts = time.time()

    def poll(self):
        if self._exit_at is not None and time.time() >= self._exit_at:
            return self._rc
        return None

    def wait(self, timeout=None):
        self._exit_at = time.time()
        return self._rc

    def send_signal(self, sig):
        self.signals.append(sig)
        self._rc, self._exit_at = -int(signal.SIGKILL), time.time()

    @property
    def returncode(self):
        return self.poll()


class FakeLauncher(fleet_mod.Launcher):
    """Records spawns (and the manifest as seen at spawn time); spawned
    workers exit clean WITHOUT doing work."""

    def __init__(self):
        self.spawned = []
        self.manifests = []

    def spawn(self, root, idx, env=None):
        self.spawned.append(idx)
        with open(os.path.join(root, "manifest.json")) as f:
            self.manifests.append(json.load(f))
        return FakeProc(rc=0, exit_after=0.0)


def test_supervisor_evicts_hung_worker_and_caps_redeals(tmp_path):
    """A worker whose lease expires while its handle stays alive is
    killed and its batches re-dealt to a fresh slot; a batch that keeps
    dying is given up after ``max_redeals`` and left pending for
    --resume (FleetError), never respawned forever."""
    spec = tiny_spec("hung", nodes=[3])          # one single-cell batch
    root = str(tmp_path / "hung")
    store = create_fleet(root, spec, workers=1, lease_ttl_s=0.3)
    (bid,) = store.manifest["fleet"]["assignments"]

    # stale lease + live handle = hung worker.  The lease must POST-date
    # the spawn (a pre-spawn leftover is ignored, see the boot test), so
    # the worker "booted long ago, beat once, went silent"
    write_lease(worker_root(root, 0), worker=0, batch=bid, ttl_s=0.3)
    lease = read_lease(worker_root(root, 0))
    fsutil.atomic_write_json(lease_path(worker_root(root, 0)),
                             dict(lease, ts=lease["ts"] - 10.0))
    launcher = FakeLauncher()
    hung = FakeProc(rc=None, exit_after=None)
    hung.spawned_ts = time.time() - 60.0
    h = fleet_mod.FleetHandle(root=root, procs={0: hung},
                              progress=_silent, launcher=launcher,
                              poll_s=0.01)
    with pytest.raises(fleet_mod.FleetError, match="--resume"):
        h.wait(max_redeals=1)

    assert hung.signals == [signal.SIGKILL], "hung worker must be killed"
    assert launcher.spawned == [1], \
        "exactly one re-deal to one fresh slot, then give up"
    store = CampaignStore.open(root)
    kinds = [e["kind"] for e in store.manifest["fleet"]["events"]]
    assert kinds.count("redeal") == 1 and "gave-up" in kinds
    evict = next(e for e in store.manifest["fleet"]["events"]
                 if e["kind"] == "evict")
    assert evict["reason"] == "lease-expired" and evict["worker"] == 0
    # the unhealable batch stays pending AND dealt, so --resume finds it
    assert [b.batch_id for b in pending_batches(store)] == [bid]
    assert bid in store.manifest["fleet"]["assignments"]
    # the wall-clock leg was open when the fresh worker spawned (an
    # eviction-triggered stale-leg close must not leave the healed
    # worker's run unbilled)
    assert "started_ts" in launcher.manifests[0]["fleet"]


def test_supervisor_ignores_pre_spawn_leftover_lease(tmp_path):
    """Regression: a lease left by a previous leg's occupant of the slot
    dir must not get a freshly-respawned worker SIGKILLed mid-boot —
    boot grace governs until the new worker's first beat lands."""
    spec = tiny_spec("boot", nodes=[3])
    root = str(tmp_path / "boot")
    create_fleet(root, spec, workers=1, lease_ttl_s=0.2)
    # stale NON-done lease from a previous (crashed) leg
    write_lease(worker_root(root, 0), worker=0, batch="old", ttl_s=0.2)
    lease = read_lease(worker_root(root, 0))
    fsutil.atomic_write_json(lease_path(worker_root(root, 0)),
                             dict(lease, ts=lease["ts"] - 30.0))
    launcher = FakeLauncher()
    booting = FakeProc(rc=None, exit_after=None)   # fresh spawn, no beat
    h = fleet_mod.FleetHandle(root=root, procs={0: booting},
                              progress=_silent, launcher=launcher,
                              poll_s=0.01)
    with pytest.raises(fleet_mod.FleetError, match="timed out"):
        h.wait(timeout=0.5)
    assert booting.signals == [], \
        "booting worker was evicted on a pre-spawn leftover lease"
    assert launcher.spawned == []
    assert CampaignStore.open(root).manifest["fleet"]["events"] == []


def test_supervisor_clean_exit_without_pending_is_success(tmp_path):
    """Workers that exit 0 with their deal complete need no healing: no
    events, no respawns, no FleetError."""
    spec = tiny_spec("clean", nodes=[3])
    root = str(tmp_path / "clean")
    store = create_fleet(root, spec, workers=1)
    # fabricate the worker having completed its cell
    batches = plan(spec)
    cell = batches[0].cells[0]
    wroot = worker_root(root, 0)
    os.makedirs(os.path.join(wroot, "cells"))
    w = CampaignStore(wroot, dict(
        name="clean/worker-0", spec=spec.to_dict(),
        worker=dict(index=0, busy_s=1.0),
        cells={cell.cell_id: dict(status="pending")}))
    from repro_torch.core.pareto import ArchiveEntry
    import numpy as np
    w.complete_cell(cell, dict(cell_id=cell.cell_id, ppa_score=0.5,
                               episodes=8, wall_s=0.5),
                    [ArchiveEntry(cfg=np.zeros(30, np.float32),
                                  power_mw=1.0, perf_gops=2.0,
                                  area_mm2=3.0, tok_s=1.0, ppa_score=0.5,
                                  episode=0)])
    launcher = FakeLauncher()
    h = fleet_mod.FleetHandle(root=root,
                              procs={0: FakeProc(rc=0, exit_after=0.0)},
                              progress=_silent, launcher=launcher,
                              poll_s=0.01)
    store = h.wait()
    assert store.all_done()
    assert launcher.spawned == []
    assert store.manifest["fleet"]["events"] == []


# --------------------------------------- satellite: non-blocking wait()
def test_wait_plain_reconciles_as_each_worker_exits(tmp_path, monkeypatch):
    """Regression for the blocking sequential ``p.wait()``: the finished
    worker's results must reconcile while a slower worker is still
    running, not after every worker exits."""
    spec = tiny_spec("nb")
    root = str(tmp_path / "nb")
    create_fleet(root, spec, workers=2)
    calls = []
    real = distrib_mod.reconcile
    monkeypatch.setattr(
        distrib_mod, "reconcile",
        lambda s, *a, **k: (calls.append(time.time()),
                            real(s, *a, **k))[1])
    slow = FakeProc(rc=0, exit_after=0.6)
    h = fleet_mod.FleetHandle(
        root=root, procs={0: FakeProc(rc=0, exit_after=0.0), 1: slow},
        progress=_silent, poll_s=0.01)
    h.wait(raise_on_failure=False, supervise=False)
    assert len(calls) >= 2
    assert calls[0] < slow._exit_at, \
        "first reconcile must not wait for the slow worker"


def test_wait_plain_timeout_leaves_workers_and_raises(tmp_path):
    spec = tiny_spec("to")
    root = str(tmp_path / "to")
    create_fleet(root, spec, workers=1)
    stuck = FakeProc(rc=None, exit_after=None)
    h = fleet_mod.FleetHandle(root=root, procs={0: stuck},
                              progress=_silent, poll_s=0.01)
    t0 = time.time()
    with pytest.raises(fleet_mod.FleetError, match="timed out"):
        h.wait(supervise=False, timeout=0.2)
    assert time.time() - t0 < 5.0
    assert stuck.signals == [], "plain wait must not kill on timeout"


# ------------------------------- satellite: stale-leg wall-clock fix
def _fake_worker_dir(root, idx, spec, busy_s=8.0):
    wroot = worker_root(root, idx)
    os.makedirs(os.path.join(wroot, "cells"), exist_ok=True)
    w = CampaignStore(wroot, dict(
        name=f"x/worker-{idx}", spec=spec.to_dict(),
        worker=dict(index=idx, busy_s=busy_s), cells={}))
    w.save_manifest()
    return wroot


def _backdate_lease(wroot, ago_s, **kw):
    lease = write_lease(wroot, **kw)
    fsutil.atomic_write_json(lease_path(wroot),
                             dict(lease, ts=lease["ts"] - ago_s))


def test_reconcile_closes_stale_leg_at_last_heartbeat(tmp_path):
    """Regression: a SIGKILLed fleet parent leaves ``started_ts``
    dangling; the next reconcile used to bill all idle calendar time
    since then to ``wall_s``, diluting util_pct.  With leases, the stale
    leg is closed at the newest heartbeat instead — and frozen, so it is
    never re-billed."""
    spec = tiny_spec("wall")
    root = str(tmp_path / "wall")
    store = create_fleet(root, spec, workers=2, lease_ttl_s=5.0)
    now = time.time()
    store.manifest["fleet"]["started_ts"] = now - 1000.0
    store.save_manifest()
    # both workers last heartbeated ~990s ago (leg really lasted ~10s);
    # the parent was SIGKILLed so nothing froze the clock
    for i in (0, 1):
        wroot = _fake_worker_dir(root, i, spec)
        _backdate_lease(wroot, 990.0 + i, worker=i, batch=None, ttl_s=5.0)
    store = CampaignStore.open(root)
    reconcile(store)
    fleet = store.manifest["fleet"]
    assert fleet["wall_s"] == pytest.approx(10.0, abs=2.0), \
        f"stale leg billed idle time: wall_s={fleet['wall_s']}"
    assert "started_ts" not in fleet, "stale leg must be frozen"
    assert any(e["kind"] == "stale-leg-closed" for e in fleet["events"])
    # idempotent: a later reconcile never re-opens or re-bills the leg
    wall = fleet["wall_s"]
    store = CampaignStore.open(root)
    reconcile(store)
    assert store.manifest["fleet"]["wall_s"] == wall


def test_reconcile_live_leg_still_uses_now(tmp_path):
    """Fresh heartbeats mean the leg is live: wall_s keeps extending to
    'now' (and is NOT frozen) exactly as before the fix."""
    spec = tiny_spec("live")
    root = str(tmp_path / "live")
    store = create_fleet(root, spec, workers=1, lease_ttl_s=5.0)
    store.manifest["fleet"]["started_ts"] = time.time() - 30.0
    store.save_manifest()
    wroot = _fake_worker_dir(root, 0, spec)
    write_lease(wroot, worker=0, batch="b", ttl_s=5.0)   # fresh beat
    store = CampaignStore.open(root)
    reconcile(store)
    fleet = store.manifest["fleet"]
    assert fleet["wall_s"] == pytest.approx(30.0, abs=2.0)
    assert "started_ts" in fleet, "live leg must stay open"


def test_reconcile_pre_lease_layout_falls_back_to_now(tmp_path):
    """Worker dirs without any lease (pre-lease runs) keep the legacy
    wall clock: end = now, leg stays open."""
    spec = tiny_spec("legacy")
    root = str(tmp_path / "legacy")
    store = create_fleet(root, spec, workers=1)
    store.manifest["fleet"]["started_ts"] = time.time() - 100.0
    store.save_manifest()
    _fake_worker_dir(root, 0, spec)
    store = CampaignStore.open(root)
    reconcile(store)
    fleet = store.manifest["fleet"]
    assert fleet["wall_s"] == pytest.approx(100.0, abs=2.0)
    assert "started_ts" in fleet


# ------------------------------- satellite: one plan derivation per call
def test_reconcile_derives_plan_at_most_once(tmp_path, monkeypatch):
    """Regression: reconcile used to run the full ``plan(store.spec)``
    twice per call (deal pruning + finished check) and ``run_worker``
    re-planned again; ``plan_cached`` plus the single pending_batches
    call cap it at one derivation per distinct spec."""
    spec = tiny_spec("memo")
    root = str(tmp_path / "memo")
    create_fleet(root, spec, workers=2)
    _fake_worker_dir(root, 0, spec)
    planner_mod._PLAN_CACHE.clear()
    calls = []
    real_plan = planner_mod.plan
    monkeypatch.setattr(planner_mod, "plan",
                        lambda s: (calls.append(1), real_plan(s))[1])
    reconcile(CampaignStore.open(root))
    assert len(calls) <= 1, f"plan derived {len(calls)}x in one reconcile"
    calls.clear()
    reconcile(CampaignStore.open(root))   # same spec: cache hit
    assert calls == []
    # a different spec is a different cache entry, not a stale hit
    other = tiny_spec("memo2", nodes=[7])
    assert plan_cached(other) == real_plan(other)


def test_plan_cached_returns_equal_plan(tmp_path):
    planner_mod._PLAN_CACHE.clear()
    spec = tiny_spec("pc")
    assert plan_cached(spec) == plan(spec)
    assert plan_cached(spec) is plan_cached(spec), "memoized object"


# ----------------------------------------- satellite: CLI validation
def test_fleet_worker_cli_rejects_bad_inputs(tmp_path, capsys):
    # negative worker index
    with pytest.raises(SystemExit):
        fleet_mod.main(["--root", str(tmp_path / "x"), "--worker", "-1"])
    assert "--worker must be >= 0" in capsys.readouterr().err
    # missing campaign
    with pytest.raises(SystemExit):
        fleet_mod.main(["--root", str(tmp_path / "x"), "--worker", "0"])
    assert "no campaign manifest" in capsys.readouterr().err
    # plain (non-fleet) campaign
    plain = str(tmp_path / "plain")
    CampaignStore.create(plain, tiny_spec("plain"))
    with pytest.raises(SystemExit):
        fleet_mod.main(["--root", plain, "--worker", "0"])
    assert "not a fleet campaign" in capsys.readouterr().err
    # index outside the recorded deal
    froot = str(tmp_path / "fl")
    create_fleet(froot, tiny_spec("fl"), workers=2)
    with pytest.raises(SystemExit):
        fleet_mod.main(["--root", froot, "--worker", "7"])
    err = capsys.readouterr().err
    assert "no batches in the recorded deal" in err
    assert "slots with work: [0, 1]" in err
    # --status and --worker exclude each other; --json needs --status
    with pytest.raises(SystemExit):
        fleet_mod.main(["--root", froot, "--worker", "0", "--status"])
    assert "mutually exclusive" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        fleet_mod.main(["--root", froot])
    assert "--worker is required" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        fleet_mod.main(["--root", froot, "--worker", "0", "--json"])
    assert "--json only applies to --status" in capsys.readouterr().err


def test_dse_cli_rejects_bad_fleet_flags(capsys):
    def err_of(argv):
        with pytest.raises(SystemExit):
            dse.main(argv)
        return capsys.readouterr().err

    base = ["--campaign", GRID, "--workers", "2", "--device", "cpu"]
    assert "--lease-ttl must be > 0" in err_of(base + ["--lease-ttl", "0"])
    assert "--lease-ttl must be > 0" in err_of(base + ["--lease-ttl",
                                                       "-3"])
    assert "--hosts must be" in err_of(base + ["--hosts", " , "])
    assert "must reference {root} and {worker}" in \
        err_of(base + ["--launch-template", "ssh {host} worker"])
    assert "pass --hosts too" in \
        err_of(base + ["--launch-template",
                       "ssh {host} w --root {root} --worker {worker}"])
    assert "pass --workers" in \
        err_of(["--campaign", GRID, "--lease-ttl", "5"])
    assert "pass --workers" in \
        err_of(["--campaign", GRID, "--no-supervise"])
    # negative/zero --workers stays a clean one-liner, not a traceback
    assert "--workers must be >= 1" in \
        err_of(["--campaign", GRID, "--workers", "-2"])
    # a transfer donor root needs a campaign manifest
    assert "--transfer-from: no campaign manifest under /x" in \
        err_of(base + ["--transfer-from", "/x"])


def test_dse_resume_non_fleet_rejects_fleet_flags(tmp_path, capsys):
    """Regression: fleet flags on a single-process --resume without
    --workers used to be dropped silently; now they error."""
    root = str(tmp_path / "plain2")
    CampaignStore.create(root, tiny_spec("plain2"))
    with pytest.raises(SystemExit):
        dse.main(["--resume", root, "--lease-ttl", "9", "--device", "cpu"])
    assert "single-process campaign" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        dse.main(["--resume", root, "--hosts", "a,b", "--device", "cpu"])
    assert "--workers" in capsys.readouterr().err


def test_launch_fleet_rejects_bad_workers_and_ttl(tmp_path):
    """Regression: ``launch_fleet(workers=0)`` used to fall back to 1
    silently (``workers or 1``); now it refuses, matching the CLI."""
    with pytest.raises(ValueError, match="workers must be >= 1"):
        fleet_mod.launch_fleet(str(tmp_path / "w"), tiny_spec("w"),
                               workers=0, device="cpu")
    with pytest.raises(ValueError, match="lease_ttl_s must be > 0"):
        fleet_mod.launch_fleet(str(tmp_path / "w"), tiny_spec("w"),
                               workers=1, lease_ttl_s=0.0, device="cpu")


# --------------------------------------------------- launcher plumbing
def test_command_launcher_template_and_host_rotation(tmp_path):
    cl = fleet_mod.CommandLauncher(
        "ssh {host} {python} -m repro_torch.launch.fleet --root {root} "
        "--worker {worker}", hosts=["h0", "h1"])
    c0 = cl.command(str(tmp_path), 0)
    c2 = cl.command(str(tmp_path), 2)
    assert c0[1] == "h0" and cl.command(str(tmp_path), 1)[1] == "h1"
    assert c2[1] == "h0", "fresh slots rotate over the same hosts"
    assert c0[-2:] == ["--worker", "0"]
    assert fleet_mod.make_launcher(None, None).to_config() is None
    cfg = fleet_mod.make_launcher(None, ["h0"]).to_config()
    assert cfg["template"] == fleet_mod.DEFAULT_REMOTE_TEMPLATE
    assert cfg["hosts"] == ["h0"]
    # the default template runs the port's worker on the launcher's device
    remote = fleet_mod.make_launcher(None, ["h0"], "cpu").command("/r", 3)
    assert remote[:4] == ["ssh", "h0", "python", "-m"]
    assert remote[4:] == ["repro_torch.launch.fleet", "--root", "/r",
                          "--worker", "3", "--device", "cpu"]
    with pytest.raises(ValueError, match="{root} and {worker}"):
        fleet_mod.CommandLauncher("ssh {host} w", ["h0"])
    with pytest.raises(ValueError, match="no hosts"):
        fleet_mod.CommandLauncher("ssh {host} w {root} {worker}")


def test_worker_env_puts_the_ports_src_first():
    """Workers import the parent's ``repro_torch``: its ``src`` leads
    ``PYTHONPATH`` (once), and nothing of the reference is imported to
    find it."""
    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = fleet_mod._worker_env()
    parts = env["PYTHONPATH"].split(os.pathsep)
    assert parts[0] == src and parts.count(src) == 1


def test_spec_hosts_field_validated():
    spec = tiny_spec("h", hosts=["a", "b"])
    assert CampaignSpec.from_dict(spec.to_dict()).hosts == ["a", "b"]
    with pytest.raises(ValueError, match="hosts"):
        tiny_spec("h", hosts=[])
    with pytest.raises(ValueError, match="hosts"):
        tiny_spec("h", hosts=[" "])
    assert tiny_spec("d", devices=2).devices == 2
    with pytest.raises(ValueError, match="devices must be >= 1"):
        tiny_spec("d", devices=0)
