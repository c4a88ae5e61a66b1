"""The ported campaign subsystem on the CPU at a small size: planner
packing and spec validation (against the reference planner), store
persistence and ``merge_runs``, reports, mid-batch kill/resume reproducing
the uninterrupted campaign bit-for-bit, the CLI, and run directories read
across the two packages (each package's reports of the other's run
directory equal its own, byte for byte)."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.campaign import CampaignSpec as RefSpec
from repro.campaign import CampaignStore as RefStore
from repro.campaign import merge_runs as ref_merge_runs
from repro.campaign import plan as ref_plan
from repro.campaign import run_campaign as ref_run_campaign
from repro.campaign import write_reports as ref_write_reports
import repro_torch.core.search as search_mod
from repro_torch.campaign import (CampaignSpec, CampaignStore, merge_runs,
                                  plan, run_campaign, runner, write_reports)
from repro_torch.campaign.planner import cells
from repro_torch.campaign.store import STATUS_DONE
from repro_torch.core.pareto import ArchiveEntry
from repro_torch.launch import dse

ARCH = "smolvlm"
QUIET = dict(progress=lambda m: None, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny searches spend their time in per-op overhead; one intra-op
    thread keeps them from contending with the other test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def tiny(name, **kw):
    base = dict(name=name, workloads=[ARCH], nodes=[3, 7],
                modes=["high_perf"], episodes=32, lanes=4, max_envs=8,
                seed=0, seq_len=256, batch=1, checkpoint_every=2)
    base.update(kw)
    return base


def _summaries_without_clock(store):
    """Every summary field except ``wall_s`` (a clock reading)."""
    return {cid: {k: v for k, v in s.items() if k != "wall_s"}
            for cid, s in store.summaries().items()}


def _frontiers(store):
    return {cid: {k: np.sort(v) for k, v in
                  store.load_archive(cid).frontier().items()}
            for cid in store.manifest["cells"]}


def _assert_same_campaign(a, b):
    assert _summaries_without_clock(a) == _summaries_without_clock(b)
    fa, fb = _frontiers(a), _frontiers(b)
    assert fa.keys() == fb.keys()
    for cid in fa:
        for k in fa[cid]:
            np.testing.assert_array_equal(fa[cid][k], fb[cid][k])


# ---------------------------------------------------------------- planner
def test_grid_expansion_and_packing_match_the_reference():
    d = dict(name="g", workloads=["llama3.1-8b", "smolvlm"],
             nodes=[3, 5, 7, 10, 14, 22, 28], modes=["high_perf",
                                                    "low_power"],
             episodes=4613, lanes=64, max_envs=448)
    spec = CampaignSpec(**d)
    cs = cells(spec)
    assert len(cs) == spec.n_cells == 28
    batches = plan(spec)
    assert len(batches) == 4 and all(len(b.node_nms) == 7 for b in batches)
    packed = [c.cell_id for b in batches for c in b.cells]
    assert sorted(packed) == sorted(c.cell_id for c in cs)
    assert [b.batch_id for b in batches] == [b.batch_id
                                             for b in ref_plan(RefSpec(**d))]
    assert spec.to_dict() == RefSpec(**d).to_dict()


@pytest.mark.parametrize("kw,match", [
    (dict(workloads=["nope"]), "unknown workloads"),
    (dict(nodes=[4]), "unknown process nodes"),
    (dict(modes=["turbo"]), "unknown modes"),
    (dict(lanes=64, max_envs=8), "max_envs"),
    (dict(screen_k=0), "screen_k"),
    (dict(priorities={"k": "high"}),
     "priorities must map batch keys to numbers"),
    (dict(devices=0), "devices must be >= 1"),
    (dict(hosts=[" "]), "hosts must be a non-empty list"),
])
def test_spec_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        CampaignSpec(**tiny("x", **kw))


@pytest.mark.parametrize("kw,n_cells", [
    (dict(workloads=["smollm-135m"]), 2),
    (dict(slo={"tok_s": 5.0}), 2),
    (dict(dtypes=["native", "fp8"]), 4),
    (dict(phases=["prefill"]), 2),
], ids=["zoo-workload", "slo", "dtypes", "phases"])
def test_spec_accepts_the_zoo_and_scenario_axes(kw, n_cells):
    """What the spec refused before the zoo and the scenario engine were
    ported: a zoo workload, an SLO and scenario axes; each plans as the
    reference's spec does."""
    spec = CampaignSpec(**tiny("x", **kw))
    ref = RefSpec(**tiny("x", **kw))
    assert spec.to_dict() == ref.to_dict() and spec.n_cells == n_cells
    assert [b.batch_id for b in plan(spec)] == [b.batch_id
                                                for b in ref_plan(ref)]


def test_spec_from_dict_names_bad_and_missing_keys():
    with pytest.raises(ValueError, match="did you mean 'episodes'"):
        CampaignSpec.from_dict(dict(name="x", workloads=[ARCH], episode=3))
    with pytest.raises(ValueError, match="missing required key"):
        CampaignSpec.from_dict(dict(name="x"))


# ------------------------------------------------------------------ store
def _entry(power, perf, area, tag=0.0):
    return ArchiveEntry(cfg=np.full(30, tag, np.float32), power_mw=power,
                        perf_gops=perf, area_mm2=area, tok_s=perf,
                        ppa_score=power / perf, episode=0)


def test_store_create_append_reload_and_refuse_overwrite(tmp_path):
    spec = CampaignSpec(**tiny("st"))
    root = str(tmp_path / "st")
    store = CampaignStore.create(root, spec)
    cell = cells(spec)[0]
    assert store.status(cell) == "pending" and not store.all_done()
    store.complete_cell(cell, dict(cell_id=cell.cell_id, ppa_score=0.5,
                                   episodes=32, wall_s=1.0),
                        [_entry(1, 1, 1), _entry(2, 2, 1), _entry(3, 1, 2)])
    again = CampaignStore.open(root)
    assert again.status(cell) == STATUS_DONE
    assert again.load_summary(cell.cell_id)["ppa_score"] == 0.5
    assert len(again.load_archive(cell.cell_id)) == 2   # (3,1,2) dominated
    assert again.spec.to_dict() == spec.to_dict()
    with pytest.raises(FileExistsError):
        CampaignStore.create(root, spec)


def _one_cell_store(pkg, root, entries):
    store_cls = CampaignStore if pkg == "port" else RefStore
    os.makedirs(os.path.join(root, "cells"), exist_ok=True)
    s = store_cls(root, dict(name=os.path.basename(root),
                             cells={"c": dict(status="pending")}))
    s.save_manifest()
    s.append_points("c", entries)
    return s


def _keys(archive):
    return sorted((tuple(e.cfg.tolist()), e.power_mw, e.perf_gops,
                   e.area_mm2) for e in archive.entries)


@pytest.mark.parametrize("case", ["dominance", "first_seen_wins"])
def test_merge_runs_matches_the_reference(tmp_path, case):
    """``merge_runs`` keeps the non-dominated union and appends only novel
    points.  ``first_seen_wins`` is the example of ROADMAP §C
    (``.hypothesis/patches/2026-10-16--e950904e.patch``): two archives,
    each one entry with equal objectives and another cfg; the reference
    keeps the first one it sees, so the merge depends on order, and the
    port must do the same."""
    if case == "dominance":        # lower power, higher perf, lower area
        a = [_entry(1, 1, 1), _entry(3, 3, 1)]
        b = [_entry(2, 2, 1, tag=1.0), _entry(4, 1, 2, tag=2.0)]
    else:
        a = [_entry(1, 1, 1, tag=0.0)]
        b = [_entry(1, 1, 1, tag=1.0)]
    for order in ((a, b), (b, a)):
        got = {}
        for pkg, merge in (("port", merge_runs), ("ref", ref_merge_runs)):
            dst = _one_cell_store(pkg, str(tmp_path / pkg / "dst"), order[0])
            _one_cell_store(pkg, str(tmp_path / pkg / "src"), order[1])
            merged = merge(dst, [str(tmp_path / pkg / "src")])
            got[pkg] = _keys(merged["c"])
            assert _keys(dst.load_archive("c")) == got[pkg]
            merge(dst, [str(tmp_path / pkg / "src")])       # idempotent
            assert _keys(dst.load_archive("c")) == got[pkg]
            shutil.rmtree(str(tmp_path / pkg))
        assert got["port"] == got["ref"]
        if case == "first_seen_wins":
            assert got["port"] == _keys(
                _one_cell_store("port", str(tmp_path / "x"), order[0])
                .load_archive("c"))
            shutil.rmtree(str(tmp_path / "x"))
        else:
            assert len(got["port"]) == 3      # all but (4, 1, 2)


# --------------------------------------------------- campaign + kill/resume
def test_campaign_runs_every_cell_and_reports(tmp_path):
    spec = CampaignSpec(**tiny("rep", modes=["high_perf", "low_power"]))
    store = run_campaign(str(tmp_path / "rep"), spec, **QUIET)
    assert store.all_done() and len(store.summaries()) == 4
    rep = os.path.join(store.root, "report")
    assert sorted(os.listdir(rep)) == sorted(
        f"{n}.{x}" for n in ("cells", "adaptation", "scaling")
        for x in ("json", "md"))
    adapt = json.load(open(os.path.join(rep, "adaptation.json")))
    assert [r["node_nm"] for r in adapt[f"{ARCH}__high_perf"]] == [3, 7]
    assert len(json.load(open(os.path.join(rep, "cells.json")))) == 4
    # the final weights snapshot of every batch
    for b in plan(spec):
        assert os.listdir(store.weights_dir(b.batch_id)) == ["step_00000032"]
    assert not os.listdir(os.path.join(store.root, "ckpt"))


def test_sequential_baseline_equals_a_one_cell_batch(tmp_path):
    """``run_cells_sequential`` runs each cell alone with the batch's seed
    (plus its position): for one-node batches that is the campaign's own
    search, so the results agree."""
    spec = CampaignSpec(**tiny("seq", nodes=[3], modes=["high_perf",
                                                        "low_power"]))
    store = run_campaign(str(tmp_path / "seq"), spec, **QUIET)
    seq = runner.run_cells_sequential(spec, device="cpu")
    assert [r.node_nm for r in seq] == [3, 3]
    for b, r in zip(plan(spec), seq):
        s = store.load_summary(b.cells[0].cell_id)
        assert (s["episodes"], s["frontier"], s["feasible"]) == (
            r.episodes_run, len(r.archive), r.feasible_count)
        assert s["ppa_score"] == (None if r.best_metrics is None
                                  else r.best_score)


@pytest.mark.parametrize("gate", ["closed", "open"])
def test_midbatch_kill_resume_is_bitwise(tmp_path, monkeypatch, gate):
    """Kill mid-batch after a checkpoint; ``--resume`` reproduces the
    uninterrupted campaign bit-for-bit (summaries but their clock, and
    frontiers), with every gate closed and with them forced open (the
    reference's test_campaign.py kill/resume cases)."""
    if gate == "closed":
        spec = CampaignSpec(**tiny("ck", episodes=48, checkpoint_every=3))
        kill_at = 2
    else:   # learning from dispatch 32, the loose threshold opens the gates
        spec = CampaignSpec(**tiny("ck", episodes=192, checkpoint_every=8,
                                   gate_threshold=1e9, screen_k=3))
        kill_at = 5
    ref = run_campaign(str(tmp_path / "ref"), spec, **QUIET)
    # designs were found, so the frontiers compared below are not empty
    assert all(len(ref.load_archive(cid)) for cid in ref.manifest["cells"])
    sums = ref.summaries().values()
    if gate == "open":
        assert all(s["gate_open_episode"] is not None
                   and s["screened"] > s["evaluated"] for s in sums)
    else:
        assert all(s["gate_open_episode"] is None for s in sums)

    real_save = search_mod._save_search_ckpt
    saves = []

    def killing_save(*args, **kw):
        out = real_save(*args, **kw)
        saves.append(args[1])
        if len(saves) == kill_at:
            raise KeyboardInterrupt("simulated kill after checkpoint")
        return out

    monkeypatch.setattr(search_mod, "_save_search_ckpt", killing_save)
    root = str(tmp_path / "ck")
    with pytest.raises(KeyboardInterrupt):
        run_campaign(root, spec, **QUIET)
    monkeypatch.setattr(search_mod, "_save_search_ckpt", real_save)
    assert not CampaignStore.open(root).all_done()
    store = run_campaign(root, resume=True, **QUIET)
    assert store.all_done()
    _assert_same_campaign(store, ref)
    for cid, s in ref.summaries().items():
        rec = store.manifest["cells"][cid]
        assert rec["screened"] == s["screened"]
        assert rec["gate_open_episode"] == s["gate_open_episode"]


# -------------------------------------------------------------------- CLI
def test_cli_campaign_and_resume(tmp_path, capsys):
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps(tiny("cli", modes=["low_power"])))
    root = str(tmp_path / "runs")
    dse.main(["--campaign", str(grid), "--campaign-root", root,
              "--device", "cpu"])
    store = CampaignStore.open(os.path.join(root, "cli"))
    assert store.all_done() and len(store.summaries()) == 2
    assert "[campaign] cli: 2 cells run" in capsys.readouterr().out
    dse.main(["--resume", os.path.join(root, "cli"), "--device", "cpu"])
    assert "0 cells run, all_done=True" in capsys.readouterr().out


def test_cli_resumes_a_zoo_workload_run_dir(tmp_path, capsys):
    """A run directory of a zoo workload the port once refused
    (``smollm-135m``), written by the reference, resumes through the
    port's CLI: nothing is left to run and the reports are rewritten."""
    spec = tiny("zoo", workloads=["smollm-135m"], nodes=[7], episodes=16)
    root = str(tmp_path / "zoo")
    ref_run_campaign(root, RefSpec(**spec), progress=lambda m: None)
    dse.main(["--resume", root, "--device", "cpu"])
    assert "0 cells run, all_done=True" in capsys.readouterr().out
    summ = CampaignStore.open(root).load_summary("smollm-135m__7nm__high_perf")
    assert summ["arch"] == "smollm-135m"


@pytest.mark.parametrize("flags,needle", [
    (["--workers", "0"], "--workers must be >= 1"),
    (["--hosts", "a,b"], "pass --workers"),
    (["--transfer-from", "/x", "--resume"], "keeps the warm-start donors"),
    (["--mesh", "x"], "--mesh must be 'auto'"),
    (["--devices", "2", "--resume"], "keeps the mesh"),
    (["--phase", "prefill"], "sweep these as 'phases'"),
    (["--screen-k", "3", "--resume"], "keeps the gate settings"),
    (["--resume"], "no campaign manifest"),
    (["--campaign", "GRID", "--resume"], "pass exactly one"),
    (["--campaign", "missing.json"], "grid file not found"),
    (["--campaign", "BADGRID"], "did you mean 'episodes'"),
])
def test_cli_rejects_what_is_not_ported_or_invalid(tmp_path, capsys, flags,
                                                   needle):
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps(tiny("cli")))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(dict(name="b", workloads=[ARCH], episode=3)))
    argv = [{"GRID": str(grid), "BADGRID": str(bad)}.get(f, f)
            for f in flags]
    if argv[-1] == "--resume":
        argv.append(str(tmp_path))
    if "--campaign" not in argv and "--resume" not in argv:
        argv += ["--campaign", str(grid)]
    with pytest.raises(SystemExit) as exc:
        dse.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert needle in capsys.readouterr().err


# ------------------------------------------------------ cross-package dirs
def _report_bytes(root):
    rep = os.path.join(root, "report")
    return {n: open(os.path.join(rep, n), "rb").read()
            for n in sorted(os.listdir(rep))}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_run_dirs_read_across_packages(tmp_path, writer):
    """A campaign run by one package is opened by the other's store: the
    same spec, cells, summaries and frontiers, and the other package's
    ``write_reports`` writes the same bytes as the writer's own."""
    d = tiny("x", episodes=32)
    root = str(tmp_path / writer)
    if writer == "ref":
        ref_run_campaign(root, RefSpec(**d), progress=lambda m: None)
    else:
        run_campaign(root, CampaignSpec(**d), **QUIET)
    own = _report_bytes(root)
    port, ref = CampaignStore.open(root), RefStore.open(root)
    assert port.spec.to_dict() == ref.spec.to_dict()
    assert port.summaries() == ref.summaries()
    assert port.all_done() and ref.all_done()
    for cid in ref.manifest["cells"]:
        assert _keys(port.load_archive(cid)) == _keys(ref.load_archive(cid))
    reader = write_reports if writer == "ref" else ref_write_reports
    shutil.rmtree(os.path.join(root, "report"))
    reader(port if writer == "ref" else ref)
    assert _report_bytes(root) == own
