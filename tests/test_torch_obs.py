"""The ported telemetry layer (``repro_torch.obs``) on the CPU: span serde
and torn-tail tolerance, the Chrome trace exporter, deterministic
histogram bucketing and snapshot merge, the lease-metrics round trip, the
fleet ``--status`` view, Prometheus text, the structured logger, the
supervision-event formatting, records equal to the reference's for the
same inputs, and the contract that tracing never perturbs a search
(bitwise), with the spans and counters the reference writes."""
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.obs import export as ref_export
from repro.obs import metrics as ref_metrics
from repro_torch.configs import get_config
from repro_torch.core.search import SearchConfig, run_search_cells
from repro_torch.obs import export as obs_export
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.workload.extract import extract

ARCH = "smollm-135m"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny searches spend their time in per-op overhead; one intra-op
    thread keeps them from contending with the other test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------- tracing + serde
def test_span_serde_and_torn_tail(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = obs_trace.Tracer(path, proc="t0")
    obs_trace.install_tracer(tr)
    try:
        with obs_trace.span("work", cat="test", n=3) as sp:
            sp.set(extra=1)
        obs_trace.instant("tick", cat="test")
        obs_trace.counter("load", a=1.0, b=2.0)
        obs_trace.complete("measured", 12.0, 0.5, cat="test")
    finally:
        obs_trace.install_tracer(None)
        tr.close()
    with open(path, "a") as f:          # torn tail from a crash mid-append
        f.write('{"ph": "X", "name": "to')
    recs = obs_trace.read_trace(path)
    assert [r["ph"] for r in recs] == ["M", "X", "i", "C", "X"]
    x = recs[1]
    assert x["name"] == "work" and x["args"] == {"n": 3, "extra": 1}
    assert x["dur"] >= 0.0
    assert recs[3]["args"] == {"a": 1.0, "b": 2.0}
    assert recs[4]["ts"] == 12.0 and recs[4]["dur"] == 0.5
    # a second writer heals the torn tail before appending
    tr2 = obs_trace.Tracer(path, proc="t1")
    tr2.close()
    assert [r["ph"] for r in obs_trace.read_trace(path)][-1] == "M"


def test_span_records_error_and_null_span_without_tracer(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = obs_trace.Tracer(path)
    obs_trace.install_tracer(tr)
    try:
        with pytest.raises(RuntimeError):
            with obs_trace.span("boom"):
                raise RuntimeError("no")
    finally:
        obs_trace.install_tracer(None)
        tr.close()
    recs = obs_trace.read_trace(path)
    assert recs[-1]["args"]["error"].startswith("RuntimeError")
    # with no tracer installed the API is a no-op, not an error
    assert obs_trace.current_tracer() is None
    with obs_trace.span("ignored") as sp:
        sp.set(x=1)
    obs_trace.instant("ignored")


def test_trace_env_veto(tmp_path, monkeypatch):
    monkeypatch.setenv(obs_trace.TRACE_ENV, "0")
    tr = obs_trace.Tracer(str(tmp_path / "trace.jsonl"))
    try:
        assert obs_trace.tracing_disabled()
        assert obs_trace.install_tracer(tr) is None
        assert obs_trace.current_tracer() is None
    finally:
        obs_trace.install_tracer(None)
        tr.close()


def test_chrome_export_matches_the_reference(tmp_path):
    """Two processes' traces become two named pid lanes in microseconds,
    and the reference's exporter writes the same document for the port's
    run directory."""
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "worker-0"))
    tr = obs_trace.Tracer(os.path.join(root, "trace.jsonl"), proc="fleet")
    tr.instant("worker_spawned", cat="fleet", worker=0)
    tr.close()
    tw = obs_trace.Tracer(
        os.path.join(root, "worker-0", obs_trace.TRACE_NAME),
        proc="worker-0")
    tw.complete("dispatch", 100.0, 0.25, cat="search")
    tw.counter("search", env_steps_s=3.0)
    tw.close()
    out = obs_export.export_run(root)
    assert out == os.path.join(root, "report", "trace.json")
    doc = json.load(open(out))
    evs = doc["traceEvents"]
    assert all(e["ph"] in ("X", "i", "C", "M") for e in evs)
    names = {e["pid"]: e["args"]["name"]
             for e in evs if e["ph"] == "M"}
    assert sorted(names.values()) == ["main", "worker-0"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert xs and xs[0]["dur"] == pytest.approx(0.25e6)  # microseconds
    assert all(e["ts"] >= 0 for e in evs if "ts" in e)   # relative timebase
    ref_out = ref_export.export_run(root, str(tmp_path / "ref.json"))
    assert json.load(open(ref_out)) == doc
    with pytest.raises(FileNotFoundError):
        obs_export.export_run(str(tmp_path / "empty"))


def test_export_cli(tmp_path, capsys):
    tr = obs_trace.Tracer(str(tmp_path / "trace.jsonl"), proc="campaign")
    tr.close()
    obs_export.main(["--root", str(tmp_path)])
    assert "exported 1 trace file(s)" in capsys.readouterr().out
    assert json.load(open(tmp_path / "report" / "trace.json"))
    with pytest.raises(SystemExit):
        obs_export.main(["--root", str(tmp_path / "nothing")])
    assert "no trace.jsonl" in capsys.readouterr().err


# ----------------------------------------------------------- metrics
def _build(mod):
    r = mod.MetricsRegistry()
    h = r.histogram("lat", edges=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.005, 0.05, 0.5, float("nan")):
        h.observe(v)
    r.counter("n").inc(2)
    r.counter("req", labels={"route": "/x"}).inc(3)
    r.gauge("g").set(10.0)
    return r.snapshot()


def test_histogram_deterministic_and_merge():
    a, b = _build(obs_metrics), _build(obs_metrics)
    assert a == b                       # fixed edges -> identical snapshots
    m = obs_metrics.merge_snapshots([a, b])
    hist = obs_metrics.snapshot_value(m, "histograms", "lat")
    assert hist["counts"] == [2, 2, 2, 2]          # elementwise ADD
    assert hist["sum"] == pytest.approx(2 * (0.0005 + 0.005 + 0.05 + 0.5))
    assert obs_metrics.snapshot_value(m, "counters", "n") == 4   # ADD
    assert obs_metrics.snapshot_value(m, "gauges", "g") == 10.0  # AVERAGE
    bad = _build(obs_metrics)
    bad["histograms"][0]["edges"] = [1.0, 2.0]
    with pytest.raises(ValueError):
        obs_metrics.merge_snapshots([a, bad])
    with pytest.raises(ValueError):
        obs_metrics.MetricsRegistry().histogram("x", edges=(2.0, 1.0))


def test_snapshots_merge_and_render_as_the_reference():
    """The same observations snapshot, merge and render to the same bytes
    in both packages (fleet views mix leases from either)."""
    port, ref = _build(obs_metrics), _build(ref_metrics)
    assert port == ref
    assert obs_metrics.merge_snapshots([port, port]) == \
        ref_metrics.merge_snapshots([ref, ref])
    assert obs_metrics.render_prometheus(port) == \
        ref_metrics.render_prometheus(ref)


def test_snapshot_value_labels_and_default():
    r = obs_metrics.MetricsRegistry()
    r.counter("req", labels={"route": "/a"}).inc()
    r.counter("req", labels={"route": "/b"}).inc(5)
    s = r.snapshot()
    assert obs_metrics.snapshot_value(s, "counters", "req",
                                      {"route": "/b"}) == 5
    assert obs_metrics.snapshot_value(s, "counters", "nope",
                                      default=-1) == -1
    assert obs_metrics.snapshot_value(None, "gauges", "x") is None
    r.clear()
    assert r.snapshot() == dict(counters=[], gauges=[], histograms=[])


def test_render_prometheus_text_format():
    r = obs_metrics.MetricsRegistry()
    r.counter("req", labels={"route": "/x"}).inc(3)
    r.gauge("up").set(1.0)
    h = r.histogram("lat", edges=(0.1, 1.0))
    h.observe(0.05)
    h.observe(5.0)
    text = obs_metrics.render_prometheus(r.snapshot())
    for ln in text.strip().split("\n"):
        if ln.startswith("#"):
            assert ln.startswith("# TYPE ")
            continue
        name_part, val = ln.rsplit(" ", 1)
        float(val)
        assert name_part.startswith("repro_")
    assert "# TYPE repro_req counter" in text
    assert 'repro_req{route="/x"} 3' in text
    assert 'repro_lat_bucket{le="0.1"} 1' in text
    assert 'repro_lat_bucket{le="+Inf"} 2' in text
    assert "repro_lat_count 2" in text


# ------------------------------------------- lease piggyback + --status
def test_lease_metrics_roundtrip(tmp_path):
    from repro_torch.campaign.distrib import Heartbeat
    from repro_torch.campaign.store import read_lease, write_lease

    wdir = str(tmp_path / "worker-0")
    os.makedirs(wdir)
    reg = obs_metrics.MetricsRegistry()
    reg.counter("env_steps_total").inc(128)
    reg.gauge("env_steps_per_s").set(42.5)
    hb = Heartbeat(wdir, 0, ttl_s=30.0, registry=reg)
    hb.start()
    try:
        hb.beat("b0003")
    finally:
        hb.stop(done=False)
    lease = read_lease(wdir)
    assert lease["batch"] == "b0003" and not lease["done"]
    snap = lease["metrics"]
    assert obs_metrics.snapshot_value(snap, "counters",
                                      "env_steps_total") == 128
    assert obs_metrics.snapshot_value(snap, "gauges",
                                      "env_steps_per_s") == 42.5
    write_lease(wdir, worker=0, batch=None, ttl_s=30.0, done=True)
    assert read_lease(wdir)["done"] and "metrics" not in read_lease(wdir)


def test_fleet_status_reads_leases(tmp_path):
    from repro.launch.fleet import fleet_status as ref_fleet_status
    from repro_torch.campaign.store import write_lease
    from repro_torch.launch.fleet import fleet_status, render_status

    root = str(tmp_path)
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump({"name": "statrun",
                   "cells": {"a": {"status": "done"},
                             "b": {"status": "pending"}},
                   "fleet": {"lease_ttl_s": 20.0,
                             "assignments": {"b0002": 1},
                             "events": []}}, f)
    w0 = os.path.join(root, "worker-0")
    os.makedirs(w0)
    os.makedirs(os.path.join(root, "worker-1"))
    reg = obs_metrics.MetricsRegistry()
    reg.gauge("env_steps_per_s").set(99.0)
    reg.counter("env_steps_total").inc(1000)
    write_lease(w0, worker=0, batch="b0001", ttl_s=20.0,
                metrics=reg.snapshot())
    now = time.time()
    st = fleet_status(root, now=now)
    assert st == ref_fleet_status(root, now=now)
    assert (st["name"], st["cells_done"], st["cells_total"],
            st["pending_batches"]) == ("statrun", 1, 2, 1)
    by = {r["worker"]: r for r in st["workers"]}
    assert by["worker-0"]["state"] == "live"
    assert by["worker-0"]["env_steps_s"] == 99.0
    assert by["worker-0"]["env_steps"] == 1000
    assert by["worker-1"]["state"] == "no-lease"
    txt = render_status(st)
    assert "worker-0" in txt and "live" in txt
    assert "99 env-steps/s over 1 live worker(s)" in txt
    assert "no-lease" in txt
    st2 = fleet_status(root, now=now + 1e4)
    assert {r["worker"]: r["state"] for r in st2["workers"]}[
        "worker-0"] == "stale"


# ------------------------------------------------------ structured log
def test_jsonl_logger_bind_mirror_and_torn_tail(tmp_path):
    path = str(tmp_path / "log.jsonl")
    mirror = str(tmp_path / "worker.log")
    with open(mirror, "w") as mf:
        lg = obs_log.JsonlLogger(path, mirror=mf, context={"worker": 1})
        lg.info("worker up", ttl=15)
        lg.bind(batch_id="b0001").error("cell failed", cell_id="c3")
        lg.warning("slow")
        lg.close()
    recs = obs_log.read_log(path)
    assert recs[0]["msg"] == "worker up" and recs[0]["worker"] == 1
    assert recs[1]["level"] == "error" and recs[1]["batch_id"] == "b0001"
    assert recs[1]["worker"] == 1       # bound context inherited
    assert recs[2]["level"] == "warning" and "batch_id" not in recs[2]
    text = open(mirror).read()
    assert "worker up" in text and "ERROR" in text and "b0001" in text
    with open(path, "a") as f:
        f.write('{"torn')
    assert len(obs_log.read_log(path)) == 3


# -------------------------------------------------- event formatting
def test_format_event_human_readable():
    from repro.campaign.report import format_event as ref_format_event
    from repro_torch.campaign.report import format_event

    evs = [dict(kind="evict", ts=1700000000.0, worker=2,
                reason="lease-expired", returncode=-9,
                pending=["b0004", "b0005"]),
           dict(kind="redeal", ts=1700000100.0, batches=["b0004"],
                from_worker=2, to_worker=3, reason="lease-expired"),
           dict(kind="gave-up", ts=1.0, worker=1, batches=["b1"],
                max_redeals=2),
           dict(kind="stale-leg-closed", ts=2.0, wall_s=12.5),
           dict(kind="mystery", ts=0.0, foo=1, bar="x")]
    ev, rd, _, _, unk = (format_event(e) for e in evs)
    assert "**evict**" in ev and "worker 2" in ev
    assert "`b0004`, `b0005`" in ev and "lease-expired" in ev
    assert "{" not in ev                # no raw dict rendering
    assert "re-dealt from worker 2 to fresh slot 3" in rd
    assert "**mystery**" in unk and "bar=x" in unk and "foo=1" in unk
    assert [format_event(e) for e in evs] == [ref_format_event(e)
                                              for e in evs]


# ------------------------------------- tracing never perturbs results
def _fp(results):
    return [(None if r.best_cfg is None
             else np.asarray(r.best_cfg, np.float64).tobytes(),
             r.best_score, r.episodes_run, r.feasible_count,
             r.unique_configs, r.screened, r.evaluated,
             [t.__dict__ for t in r.trace],
             sorted(e.objectives().tobytes() for e in r.archive.entries))
            for r in results]


@pytest.mark.parametrize("gate", ["closed", "open"])
def test_tracing_on_off_bitwise_identical_search(tmp_path, gate):
    """A traced search (its checkpoints too) is bitwise the untraced one,
    and the trace holds the reference's spans and counters: one
    ``run_search_cells`` and ``first_dispatch``, the ``search`` counters,
    one ``checkpoint`` span a checkpoint.  The registry's gauges are the
    loop's own host values."""
    wl = extract(get_config(ARCH), seq_len=256, batch=1)
    kw = dict(gate_threshold=1e9, screen_k=3) if gate == "open" else {}
    sc = SearchConfig(episodes=96, warmup=24, batch_size=32, seed=0, **kw)

    def run(tag):
        return run_search_cells(
            wl, [3, 7], search=sc, lanes_per_cell=4, device="cpu",
            checkpoint_dir=str(tmp_path / tag), checkpoint_every=5)

    obs_metrics.global_registry().clear()
    assert obs_trace.current_tracer() is None
    off = run("off")
    untraced_snap = obs_metrics.global_registry().snapshot()

    path = str(tmp_path / "trace.jsonl")
    tr = obs_trace.Tracer(path, proc="test")
    obs_trace.install_tracer(tr)
    obs_metrics.global_registry().clear()
    try:
        on = run("on")
    finally:
        obs_trace.install_tracer(None)
        tr.close()
    assert _fp(on) == _fp(off)
    assert (off[0].gate_open_episode is None) == (gate == "closed")
    recs = obs_trace.read_trace(path)
    by = {}
    for r in recs:
        by.setdefault(r["name"], []).append(r)
    assert len(by["run_search_cells"]) == 1
    assert by["run_search_cells"][0]["args"]["env_steps"] == 2 * 96
    assert len(by["first_dispatch"]) == 1
    n_disp = 96 // 4
    assert len(by["checkpoint"]) == (n_disp - 1) // 5
    assert [c["args"]["step"] for c in by["checkpoint"]] == [5, 10, 15, 20]
    assert by["search"] and all(r["ph"] == "C" for r in by["search"])
    snap = obs_metrics.global_registry().snapshot()
    assert snap["counters"] == untraced_snap["counters"]
    val = lambda k, n: obs_metrics.snapshot_value(snap, k, n)
    assert val("counters", "env_steps_total") == 2 * 4 * n_disp
    assert val("counters", "evaluated_total") == on[0].evaluated \
        + on[1].evaluated
    assert val("counters", "screened_total") == on[0].screened \
        + on[1].screened
    assert val("gauges", "search_eps") > 0
    assert val("gauges", "per_size") == 2 * 4 * n_disp
    assert val("histograms", "dispatch_seconds")["count"] == n_disp
