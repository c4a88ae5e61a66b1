"""The ported fleets (``repro_torch.campaign.distrib``,
``repro_torch.launch.fleet``) on the CPU: deterministic order-independent
sharding (the reference's deal), W=2 fleet == W=1 campaign bitwise, chaos
SIGKILL + fleet --resume bitwise, the supervisor's mid-run re-deal,
reconciler idempotency and crash-safety, the per-worker report, workers
on the parent's device with their launch counts on the lease, the CLI,
and fleet run directories read by the reference (``--status``, the trace
export, the reports).

Worker subprocesses run ``repro_torch.launch.fleet --device cpu`` with
one OpenMP thread each; every wait has a deadline."""
import dataclasses
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.campaign import CampaignSpec as RefSpec
from repro.campaign import CampaignStore as RefStore
from repro.campaign import run_campaign as ref_run_campaign
from repro.campaign import write_reports as ref_write_reports
from repro.campaign.distrib import shard_batches as ref_shard_batches
from repro.campaign.planner import plan as ref_plan
from repro.launch.fleet import fleet_status as ref_fleet_status
from repro.obs import export as ref_export
from repro.ppa import analytic as ref_an
from repro.ppa import config_space as ref_cs
from repro_torch.campaign import CampaignSpec, CampaignStore, run_campaign
from repro_torch.campaign.distrib import (create_fleet, fingerprint,
                                          pending_batches, reconcile,
                                          shard_batches, worker_root)
from repro_torch.campaign.planner import plan
from repro_torch.campaign.store import STATUS_DONE, read_lease
from repro_torch.core.pareto import ArchiveEntry
from repro_torch.kernels import ops
from repro_torch.launch import dse
from repro_torch.launch import fleet as fleet_mod
from repro_torch.obs import export as obs_export
from repro_torch.obs.metrics import snapshot_value
from repro_torch.ppa import analytic as an
from repro_torch.ppa.nodes import node_params
from repro_torch.workload.extract import extract
from repro_torch.configs import get_config

ARCH = "smollm-135m"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = os.path.join(ROOT, "examples", "grids", "ci_smoke.json")
CPU = dict(progress=lambda m: None, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_each():
    """One intra-op thread here and in every worker subprocess (they
    inherit the environment): tiny searches are per-op overhead, and the
    other test workers share the cores."""
    old_threads, old_env = torch.get_num_threads(), os.environ.get(
        "OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(old_threads)
    if old_env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = old_env


def smoke_spec(name, **kw):
    """The ci_smoke grid (2 single-cell batches), optionally re-budgeted."""
    return dataclasses.replace(CampaignSpec.from_file(GRID), name=name, **kw)


@pytest.fixture(scope="module")
def w1_w2(tmp_path_factory):
    """The ci_smoke grid as a W=1 campaign and as a W=2 fleet (shared by
    the equivalence, report, lease and cross-package tests)."""
    base = tmp_path_factory.mktemp("eq")
    spec = smoke_spec("eq")
    ref = run_campaign(str(base / "w1"), spec, **CPU)
    store = fleet_mod.run_fleet(str(base / "w2"), spec, workers=2, **CPU)
    return spec, ref, store


# ---------------------------------------------------------------- sharding
def test_shard_deterministic_order_independent_balanced():
    spec = CampaignSpec(name="s", workloads=[ARCH],
                        nodes=[3, 5, 7, 10, 14], modes=["high_perf",
                                                        "low_power"],
                        episodes=8, lanes=4, max_envs=4)
    batches = plan(spec)          # 10 single-cell batches
    assert len(batches) == 10
    for w in (1, 2, 3, 4, 7, 10, 16):
        deal = shard_batches(batches, w)
        dealt = [b.batch_id for bs in deal.values() for b in bs]
        assert sorted(dealt) == sorted(b.batch_id for b in batches)
        sizes = [len(bs) for bs in deal.values()]
        assert max(sizes) - min(sizes) <= 1
        assert len(deal) == min(w, len(batches))
        shuffled = shard_batches(list(reversed(batches)), w)
        assert {k: [b.batch_id for b in bs] for k, bs in deal.items()} == \
               {k: [b.batch_id for b in bs] for k, bs in shuffled.items()}
    with pytest.raises(ValueError, match="workers"):
        shard_batches(batches, 0)


@pytest.mark.parametrize("priorities", [False, True])
def test_shard_deal_is_the_references(priorities):
    """The deal (round-robin, or longest-predicted-first with
    priorities) is the reference's for the same batches, so either
    package can resume the other's fleet."""
    d = dict(name="s", workloads=[ARCH, "smolvlm"], nodes=[3, 7, 28],
             modes=["high_perf", "low_power"], episodes=8, lanes=4,
             max_envs=8)
    port, ref = plan(CampaignSpec(**d)), ref_plan(RefSpec(**d))
    pr = ({b.key: float((7 * i) % 5) for i, b in enumerate(port)}
          if priorities else None)
    for w in (1, 2, 3, 5):
        got = shard_batches(port, w, priorities=pr)
        want = ref_shard_batches(ref, w, priorities=pr)
        assert {k: [b.batch_id for b in v] for k, v in got.items()} == \
            {k: [b.batch_id for b in v] for k, v in want.items()}


# ----------------------------------------------- reconciler (no search)
def _mk_entries(vals, cfg_fill=0.0):
    return [ArchiveEntry(cfg=np.full(30, cfg_fill, np.float32),
                         power_mw=float(p), perf_gops=float(g),
                         area_mm2=float(a), tok_s=1.0, ppa_score=0.5,
                         episode=i)
            for i, (p, g, a) in enumerate(vals)]


def test_reconcile_idempotent_and_crash_safe(tmp_path, monkeypatch):
    spec = smoke_spec("rec")
    root = str(tmp_path / "rec")
    store = create_fleet(root, spec, workers=2)
    batches = plan(spec)
    assert [store.manifest["fleet"]["assignments"][b.batch_id]
            for b in batches] == [0, 1]

    cell = batches[1].cells[0]
    wroot = worker_root(root, 1)
    os.makedirs(os.path.join(wroot, "cells"))
    w = CampaignStore(wroot, dict(name="rec/worker-1", spec=spec.to_dict(),
                                  worker=dict(index=1, busy_s=2.0),
                                  cells={cell.cell_id:
                                         dict(status="pending")}))
    w.complete_cell(cell, dict(cell_id=cell.cell_id, ppa_score=0.7,
                               episodes=48, wall_s=1.0),
                    _mk_entries([(10, 50, 1), (5, 40, 1), (10, 50, 2)]))

    real_save = CampaignStore.save_manifest
    monkeypatch.setattr(CampaignStore, "save_manifest",
                        lambda self: (_ for _ in ()).throw(
                            OSError("simulated crash")))
    with pytest.raises(OSError, match="simulated crash"):
        reconcile(CampaignStore.open(root))
    monkeypatch.setattr(CampaignStore, "save_manifest", real_save)
    store = CampaignStore.open(root)
    assert store.status(cell) != STATUS_DONE, \
        "interrupted reconcile must not have published a torn manifest"

    newly = reconcile(store)
    assert newly == [cell.cell_id]
    store = CampaignStore.open(root)
    assert store.status(cell) == STATUS_DONE
    objs = sorted((e.power_mw, e.perf_gops)
                  for e in store.load_archive(cell.cell_id).entries)
    assert objs == [(5.0, 40.0), (10.0, 50.0)]
    assert store.load_summary(cell.cell_id)["ppa_score"] == 0.7
    assert batches[1].batch_id not in \
        store.manifest["fleet"]["assignments"]

    fp = fingerprint(store)
    size = os.path.getsize(store._cell_path(cell.cell_id))
    assert reconcile(store) == []
    store = CampaignStore.open(root)
    assert fingerprint(store) == fp
    assert os.path.getsize(store._cell_path(cell.cell_id)) == size


def test_run_campaign_refuses_fleet_scope_resume(tmp_path):
    spec = smoke_spec("guard")
    root = str(tmp_path / "guard")
    create_fleet(root, spec, workers=2)
    with pytest.raises(ValueError, match="fleet scope"):
        run_campaign(root, resume=True, **CPU)


# ------------------------------------------------- equivalence (W=2 == W=1)
def test_fleet_w2_matches_w1_bitwise(w1_w2):
    spec, ref, store = w1_w2
    assert store.all_done()
    assert fingerprint(store) == fingerprint(ref)
    assert all(len(ref.load_archive(c)) for c in ref.manifest["cells"])
    with open(os.path.join(store.root, "report", "workers.json")) as f:
        report = json.load(f)
    rows = report["workers"]
    assert report["events"] == []
    assert [r["worker"] for r in rows] == ["worker-0", "worker-1"]
    assert sum(r["cells"] for r in rows) == spec.n_cells
    assert all(r["busy_s"] > 0 and r["util_pct"] > 0 for r in rows)
    md = open(os.path.join(store.root, "report", "workers.md")).read()
    assert "| worker |" in md and "worker-1" in md


def test_fleet_warm_start_w2_matches_w1_bitwise(tmp_path, w1_w2):
    """A warm-started (``--transfer-from``) fleet fingerprints as the W=1
    warm run: the parent records the donors before the workers spawn,
    every worker mirrors the top-level transfer record verbatim, and the
    priority deal changes only where batches run.  The donor is the W=1
    campaign of ``w1_w2`` (a port run directory)."""
    from repro_torch.campaign import transfer as transfer_mod
    donor = w1_w2[1]
    tspec = transfer_mod.with_transfer(smoke_spec("weq"), [donor.root],
                                       device="cpu")
    assert tspec.priorities is not None
    ref = run_campaign(str(tmp_path / "w1"), tspec, **CPU)
    store = fleet_mod.run_fleet(str(tmp_path / "w2"), tspec, workers=2,
                                **CPU)
    assert store.all_done()
    assert fingerprint(store) == fingerprint(ref)
    top = store.manifest["transfer"]
    assert top["donors"] and top == ref.manifest["transfer"]
    assert all(d["weights"] for d in top["donors"].values())
    mirrored = 0
    for wr in glob.glob(os.path.join(store.root, "worker-*")):
        if os.path.isfile(os.path.join(wr, "manifest.json")):
            assert CampaignStore.open(wr).manifest["transfer"] == top
            mirrored += 1
    assert mirrored == 2


def test_workers_trace_log_and_publish_launch_counts(w1_w2):
    """Each worker traces and logs into its own directory, and its final
    (done) lease carries its metrics, the kernels' launch counts among
    them (all zero on the CPU: the plain versions ran)."""
    _, _, store = w1_w2
    for i in (0, 1):
        wdir = worker_root(store.root, i)
        names = {json.loads(ln)["name"] for ln in open(
            os.path.join(wdir, "trace.jsonl")) if ln.strip()}
        assert {"execute_batch", "run_batch", "run_search_cells",
                "first_dispatch", "complete_cell"} <= names
        msgs = [json.loads(ln)["msg"] for ln in open(
            os.path.join(wdir, "log.jsonl"))]
        assert msgs[0] == "worker started" and msgs[-1] == "worker done"
        assert "cell done" in msgs
        lease = read_lease(wdir)
        assert lease["done"] and lease["worker"] == i
        snap = lease["metrics"]
        assert snapshot_value(snap, "counters", "env_steps_total") == 48
        for name in ops.KERNELS:
            assert snapshot_value(snap, "counters", "kernel_launches_total",
                                  {"kernel": name}) == 0
    parent = {json.loads(ln)["name"] for ln in open(
        os.path.join(store.root, "trace.jsonl")) if ln.strip()}
    assert {"worker_spawned", "reconcile"} <= parent


def test_reference_reads_a_port_fleet(w1_w2):
    """The reference's ``fleet_status``, trace exporter and report writer
    read the port's fleet directory and give the port's answers."""
    _, _, store = w1_w2
    root = store.root
    now = time.time()
    assert ref_fleet_status(root, now=now) == fleet_mod.fleet_status(
        root, now=now)
    port_out = obs_export.export_run(root)
    port_doc = json.load(open(port_out))
    ref_doc = json.load(open(ref_export.export_run(
        root, os.path.join(root, "report", "trace_ref.json"))))
    assert ref_doc == port_doc
    assert {e["args"]["name"] for e in port_doc["traceEvents"]
            if e["ph"] == "M"} == {"main", "worker-0", "worker-1"}
    os.remove(os.path.join(root, "report", "trace_ref.json"))
    os.remove(port_out)
    rep = os.path.join(root, "report")
    own = {n: open(os.path.join(rep, n), "rb").read()
           for n in sorted(os.listdir(rep))}
    shutil.rmtree(rep)
    ref_write_reports(RefStore.open(root))
    assert {n: open(os.path.join(rep, n), "rb").read()
            for n in sorted(os.listdir(rep))} == own


def test_port_campaign_matches_the_reference_on_ci_smoke(tmp_path, w1_w2):
    """The port's W=1 campaign and the reference's on ci_smoke.json: the
    same cells, batches, budgets and summary fields, and every design the
    port archived is the reference evaluator's at rtol 1e-5 (the search's
    policy noise is torch's, so the designs themselves differ)."""
    spec, port, _ = w1_w2
    ref = ref_run_campaign(str(tmp_path / "ref"), RefSpec.from_file(GRID),
                           progress=lambda m: None)
    assert port.spec.to_dict() == dict(ref.spec.to_dict(), name="eq")
    assert sorted(port.manifest["cells"]) == sorted(ref.manifest["cells"])
    for cid in ref.manifest["cells"]:
        ps, rs = port.load_summary(cid), ref.load_summary(cid)
        assert ps.keys() == rs.keys()
        assert (ps["episodes"], ps["arch"], ps["node_nm"]) == (
            rs["episodes"], rs["arch"], rs["node_nm"])
        ents = port.load_archive(cid).entries
        assert ents
        wl = extract(get_config(ARCH), seq_len=spec.seq_len,
                     batch=spec.batch)
        node = an.node_vector(node_params(ps["node_nm"]), high_perf=True)
        want = np.asarray(ref_an.evaluate_batch(
            ref_cs.project(jnp.asarray(np.stack([e.cfg for e in ents]))),
            jnp.asarray(wl.features), jnp.asarray(node)))
        got = np.array([[e.power_mw, e.perf_gops, e.area_mm2, e.tok_s,
                         e.ppa_score] for e in ents])
        cols = [an.M_IDX[n] for n in ("power_mw", "perf_gops", "area_mm2",
                                      "tok_s", "ppa_score")]
        np.testing.assert_allclose(got, want[:, cols], rtol=1e-5)
        assert (want[:, an.M_IDX["feasible"]] == 1.0).all()


# ------------------------------------------------------- chaos kill/resume
def _wait_for_ckpt(h, root, victim, deadline_s=240):
    """Block until the victim worker has an in-flight checkpoint (so a
    kill provably interrupts mid-batch), or it exits."""
    ckpts = os.path.join(worker_root(root, victim), "ckpt", "*", "step_*")
    deadline = time.time() + deadline_s
    while time.time() < deadline and not glob.glob(ckpts) \
            and h.procs[victim].poll() is None:
        time.sleep(0.02)
    assert h.procs[victim].poll() is None and glob.glob(ckpts), \
        "victim finished before the kill window; raise spec.episodes"


@pytest.fixture(scope="module")
def chaos_ref(tmp_path_factory):
    spec = smoke_spec("chaos", episodes=240, checkpoint_every=4)
    return spec, run_campaign(str(tmp_path_factory.mktemp("chaos") / "ref"),
                              spec, **CPU)


def test_chaos_sigkill_worker_resume_bitwise_exact(tmp_path, chaos_ref):
    """SIGKILL one worker of a W=2 fleet mid-batch, then fleet --resume
    with one worker: the merged outcome is bitwise the uninterrupted run
    (the killed batch's checkpoint relocated to the survivor)."""
    spec, ref = chaos_ref
    root = str(tmp_path / "fleet")
    h = fleet_mod.launch_fleet(root, spec, workers=2, **CPU)
    victim = 1
    _wait_for_ckpt(h, root, victim)
    h.kill(victim, signal.SIGKILL)
    with pytest.raises(fleet_mod.FleetError, match="--resume"):
        h.wait(supervise=False, timeout=240)
    store = CampaignStore.open(root)
    assert not store.all_done()
    pend = pending_batches(store)
    assert pend and all(
        b.batch_id in store.manifest["fleet"]["assignments"] for b in pend)
    h = fleet_mod.launch_fleet(root, workers=1, resume=True, **CPU)
    store = h.wait(timeout=240)
    assert store.all_done()
    assert fingerprint(store) == fingerprint(ref)
    assert not glob.glob(os.path.join(root, "worker-*", "ckpt", "*"))


def test_chaos_supervisor_redeals_sigkilled_worker(tmp_path, chaos_ref):
    """SIGKILL a worker mid-batch under the supervisor: its batch is
    re-dealt to a fresh slot mid-run and the fingerprint is bitwise the
    uninterrupted run's; the manifest and report record the eviction and
    the re-deal."""
    spec, ref = chaos_ref
    root = str(tmp_path / "fleet")
    h = fleet_mod.launch_fleet(root, spec, workers=2, lease_ttl_s=3.0,
                               **CPU)
    victim = 1
    _wait_for_ckpt(h, root, victim)
    h.kill(victim, signal.SIGKILL)
    store = h.wait(timeout=240)
    assert store.all_done()
    assert fingerprint(store) == fingerprint(ref)
    events = store.manifest["fleet"]["events"]
    redeals = [e for e in events if e["kind"] == "redeal"]
    assert redeals and redeals[0]["from_worker"] == victim
    fresh = redeals[0]["to_worker"]
    assert fresh not in (0, victim) and fresh in h.procs
    assert any(e["kind"] == "evict" and e["worker"] == victim
               for e in events)
    with open(os.path.join(store.root, "report", "workers.json")) as f:
        rep = json.load(f)
    assert any(e["kind"] == "redeal" for e in rep["events"])
    assert f"worker-{fresh}" in {r["worker"] for r in rep["workers"]}
    lease = read_lease(worker_root(root, fresh))
    assert lease["done"] and lease["batch"] is not None


# ---------------------------------------------------------------- devices
def test_workers_run_on_the_parents_device(tmp_path, monkeypatch):
    """The local launcher passes the parent's device to every worker; a
    CUDA worker without a card raises before it touches the run
    directory, and a CUDA fleet without a card fails in the parent before
    anything is written or spawned."""
    assert fleet_mod.LocalLauncher("cpu").device == "cpu"
    assert fleet_mod.make_launcher(None, None, "cpu").device == "cpu"
    assert fleet_mod.CommandLauncher(
        "ssh {host} w --root {root} --worker {worker} --device {device}",
        ["h0"], "cpu").command("/r", 1)[-2:] == ["--device", "cpu"]
    root = str(tmp_path / "cuda")
    create_fleet(root, smoke_spec("cuda"), workers=2)
    env = dict(fleet_mod._worker_env(), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fleet", "--root", root,
         "--worker", "0", "--device", "cuda"], env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    assert not glob.glob(os.path.join(root, "worker-*"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_mod.launch_fleet(root, resume=True, progress=lambda m: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_mod.launch_fleet(str(tmp_path / "new"), smoke_spec("new"),
                               workers=2, progress=lambda m: None)
    assert not os.path.exists(str(tmp_path / "new"))
    assert not glob.glob(os.path.join(root, "worker-*"))


# -------------------------------------------------------------------- CLI
def test_cli_rejects_bad_workers(capsys):
    with pytest.raises(SystemExit):
        dse.main(["--campaign", GRID, "--workers", "0", "--device", "cpu"])
    assert "--workers must be >= 1" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        dse.main(["--workers", "2", "--device", "cpu"])
    assert "--campaign" in capsys.readouterr().err


def test_cli_fleet_end_to_end(tmp_path, capsys):
    """--campaign --workers 2 runs a fleet; --status renders it from the
    leases; --resume routes a fleet manifest back to fleet scope (a
    finished fleet resume is a no-op)."""
    grid = tmp_path / "grid.json"
    payload = json.loads(open(GRID).read())
    payload.update(name="clifleet", episodes=16)
    grid.write_text(json.dumps(payload))
    dse.main(["--campaign", str(grid), "--workers", "2", "--device", "cpu",
              "--campaign-root", str(tmp_path / "runs")])
    root = str(tmp_path / "runs" / "clifleet")
    store = CampaignStore.open(root)
    assert store.all_done()
    assert store.manifest["fleet"]["workers"] == 2
    assert store.manifest["fleet"]["assignments"] == {}
    assert os.path.isfile(os.path.join(root, "report", "workers.json"))
    capsys.readouterr()
    fleet_mod.main(["--root", root, "--status"])
    out = capsys.readouterr().out
    assert "fleet clifleet: 2/2 cells done" in out and "done" in out
    fleet_mod.main(["--root", root, "--status", "--json"])
    assert json.loads(capsys.readouterr().out)["cells_done"] == 2
    dse.main(["--resume", root, "--device", "cpu"])
    assert CampaignStore.open(root).all_done()
    assert "nothing pending" in capsys.readouterr().out
