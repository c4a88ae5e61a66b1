"""The ported cross-campaign transfer (``repro_torch.campaign.transfer``,
``repro_torch.models.cost_model``, ``run_search_cells(warm_start=)``) on
the CPU, held against the JAX reference.

Each case of ``tests/test_transfer.py`` is mirrored.  The cross-package
cases: the donor table, ``cost_w`` and the priorities are numpy over the
same extracted features, so they are bitwise the reference's on the same
donor roots; each package's ``load_cost_model`` reads the other's
``model/cost/``; ``load_warm_start`` re-evaluates the donor frontier
within rtol 1e-5 of the reference's; a port campaign warm-started from a
reference donor root runs, its designs re-evaluated by the reference's
evaluator within rtol 1e-5 (the tolerance of ``test_torch_search.py``),
and a killed warm-started campaign resumes bitwise its uninterrupted
run."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.search as search_mod
from repro.campaign import CampaignSpec as RefSpec
from repro.campaign import CampaignStore as RefStore
from repro.campaign import run_campaign as ref_run_campaign
from repro.campaign import transfer as ref_transfer
from repro.configs import get_config as ref_get_config
from repro.launch.recommend import ArchiveIndex as RefIndex
from repro.models import cost_model as ref_cm
from repro.ppa import analytic as ref_an
from repro.ppa import config_space as ref_cs
from repro.workload.extract import extract as ref_extract
from repro_torch.campaign import CampaignSpec, CampaignStore, run_campaign
from repro_torch.campaign import transfer as transfer_mod
from repro_torch.campaign.distrib import shard_batches
from repro_torch.campaign.planner import cells, plan, plan_cached
from repro_torch.campaign.store import (DEFAULT_LEASE_TTL_S, lease_expired,
                                        merge_runs)
from repro_torch.checkpoint import manager as ckpt_mod
from repro_torch.configs import get_config
from repro_torch.core.pareto import ArchiveEntry
from repro_torch.launch import dse
from repro_torch.launch.recommend import ArchiveIndex
from repro_torch.models import cost_model as cm
from repro_torch.ppa import config_space as cs
from repro_torch.ppa import surrogate as sur_mod
from repro_torch.ppa.analytic import M_DIM, M_IDX
from repro_torch.ppa.nodes import node_params
from repro_torch.workload.extract import extract

ARCH = "smollm-135m"
CPU = dict(device="cpu")
_silent = lambda m: None


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _kw(name, **kw):
    base = dict(name=name, workloads=[ARCH], nodes=[3, 7],
                modes=["high_perf"], episodes=32, lanes=4, max_envs=4,
                seed=0, seq_len=256, batch=1, checkpoint_every=0)
    base.update(kw)
    return base


def _spec(name, **kw):
    return CampaignSpec(**_kw(name, **kw))


def _entries(n, seed=0, episode0=0):
    """n mutually non-dominating archive entries with in-range designs."""
    rng = np.random.default_rng(seed)
    return [ArchiveEntry(
        cfg=rng.uniform(cs.LO, cs.HI).astype(np.float32),
        power_mw=10.0 + i, perf_gops=50.0 + 10.0 * i, area_mm2=1.0,
        tok_s=100.0, ppa_score=0.5 - 0.01 * i, episode=episode0 + 4 * i)
        for i in range(n)]


def _fab_campaign(root, spec, *, points=3):
    """A completed campaign run directory without any search: every cell
    done, with a small synthetic frontier."""
    store = CampaignStore.create(str(root), spec)
    for k, cell in enumerate(cells(spec)):
        store.complete_cell(
            cell, dict(cell_id=cell.cell_id, ppa_score=0.5 - 0.1 * k,
                       episodes=spec.episodes, wall_s=1.0),
            _entries(points, seed=k, episode0=2 * k))
    return store


@pytest.fixture(scope="module")
def ref_donor(tmp_path_factory):
    """A real donor campaign written by the reference (with its weights
    snapshots)."""
    root = str(tmp_path_factory.mktemp("refdonor") / "donor")
    return ref_run_campaign(root, RefSpec(**_kw("donor", episodes=32)),
                            progress=_silent)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ===================================================== bugfix regressions
def test_surrogate_update_skips_nonfinite_batches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    good = np.zeros((16, M_DIM), np.float32)
    good[:, M_IDX["power_mw"]] = 100.0
    good[:, M_IDX["perf_gops"]] = 50.0
    good[:, M_IDX["area_mm2"]] = 2.0
    bad = good.copy()
    bad[0, M_IDX["perf_gops"]] = np.inf

    sur = sur_mod.Surrogate.create(8, seed=0)
    sur.update(x, good)
    assert np.isfinite(sur.resid_var)
    rv = sur.resid_var
    loss = sur.update(x, bad)
    assert not np.isfinite(loss)
    assert sur.resid_var == rv, "non-finite batch folded into the EMA"
    assert sur.n_updates == 2

    fresh = sur_mod.Surrogate.create(8, seed=0)
    fresh.update(x, bad)
    assert np.isinf(fresh.resid_var) and not np.isnan(fresh.resid_var)
    assert not fresh.accepted


def test_merge_runs_appends_only_novel_points(tmp_path):
    spec = _spec("m", nodes=[3])
    cell = cells(spec)[0]
    src = _fab_campaign(tmp_path / "src", spec, points=3)
    dst = CampaignStore.create(str(tmp_path / "dst"), spec)

    merged = merge_runs(dst, [src.root])
    assert len(merged[cell.cell_id]) == 3
    path = dst._cell_path(cell.cell_id)
    lines = lambda: sum(1 for _ in open(path))
    n1 = lines()
    for _ in range(3):
        merge_runs(dst, [src.root])
    assert lines() == n1, "unchanged source re-appended its frontier"

    nov = ArchiveEntry(cfg=np.full(cs.DIM, 1.0, np.float32), power_mw=5.0,
                      perf_gops=200.0, area_mm2=0.5, tok_s=300.0,
                      ppa_score=0.1, episode=9)
    src.append_points(cell.cell_id, [nov])
    merge_runs(dst, [src.root])
    assert lines() == n1 + 1
    merge_runs(dst, [src.root])
    assert lines() == n1 + 1


def test_lease_expired_honors_falsy_and_sub_second_ttls():
    base = dict(worker=0, pid=1, host="h", ts=1000.0, batch="b",
                done=False)
    assert lease_expired(dict(base, ttl_s=0.0), now=1000.01)
    assert not lease_expired(dict(base, ttl_s=0.0), now=1000.0)
    assert not lease_expired(dict(base, ttl_s=0.25), now=1000.2)
    assert lease_expired(dict(base, ttl_s=0.25), now=1000.3)
    assert not lease_expired(dict(base, ttl_s=None),
                             now=1000.0 + DEFAULT_LEASE_TTL_S - 1)
    assert lease_expired(dict(base, ttl_s=None),
                         now=1000.0 + DEFAULT_LEASE_TTL_S + 1)
    assert lease_expired(dict(base, ttl_s=60.0), now=1000.5, ttl_s=0.0)
    assert not lease_expired(dict(base, ttl_s=0.0, done=True), now=2000.0)
    assert not lease_expired(None, now=2000.0)


def test_fit_index_surrogate_reports_full_dataset_resid_var():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 6)).astype(np.float32)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    y = (x @ w).astype(np.float32)
    steps, mb = 30, 8
    sur = sur_mod.fit_index_surrogate(x, y, steps=steps, seed=0,
                                      minibatch=mb, **CPU)
    full = float(np.mean(sur_mod._calib_errors_log(
        sur.params, torch.as_tensor(x), torch.as_tensor(y)).numpy()))
    assert sur.resid_var == pytest.approx(full, rel=1e-6)
    picks = np.random.default_rng(0)
    for _ in range(steps):
        pick = picks.integers(0, x.shape[0], size=mb)
    last = float(np.mean(sur_mod._calib_errors_log(
        sur.params, torch.as_tensor(x[pick]),
        torch.as_tensor(y[pick])).numpy()))
    assert last != pytest.approx(full, rel=1e-6)


# ======================================================= donor distance
def test_donor_distance_metric():
    wl = transfer_mod._wl_log(ARCH, 256, 1)
    assert np.array_equal(wl, ref_transfer._wl_log(ARCH, 256, 1))
    assert transfer_mod.donor_distance(wl, 5, "high_perf",
                                       wl, 5, "high_perf") == 0.0
    d7 = transfer_mod.donor_distance(wl, 5, "high_perf",
                                     wl, 7, "high_perf")
    d3 = transfer_mod.donor_distance(wl, 5, "high_perf",
                                     wl, 3, "high_perf")
    assert 0.0 < d7 < d3, "|log 5/7| must beat |log 5/3|"
    assert d7 == pytest.approx(transfer_mod.donor_distance(
        wl, 7, "high_perf", wl, 5, "high_perf"))
    assert transfer_mod.donor_distance(
        wl, 5, "high_perf", wl, 5, "low_power") >= transfer_mod.MODE_PENALTY
    for node, mode in ((3, "high_perf"), (22, "low_power")):
        assert np.array_equal(
            transfer_mod.cell_context(ARCH, node, mode, 256, 1),
            ref_transfer.cell_context(ARCH, node, mode, 256, 1))


# ================================================ priority-aware packing
def test_plan_priorities_reorder_execution_not_identity():
    spec = _spec("p")
    ref = plan(spec)
    assert [b.index for b in ref] == [0, 1]
    pri = {ref[1].key: 10.0, ref[0].key: 1.0}
    got = plan(dataclasses.replace(spec, priorities=pri))
    assert [b.key for b in got] == [ref[1].key, ref[0].key]
    assert {b.key: (b.index, b.batch_id) for b in got} == \
           {b.key: (b.index, b.batch_id) for b in ref}
    from repro.campaign.planner import plan as ref_plan
    assert [b.batch_id for b in got] == [b.batch_id for b in ref_plan(
        RefSpec(**_kw("p", priorities=pri)))]
    with pytest.raises(ValueError, match="priorities"):
        _spec("bad", priorities={"k": "high"})


def test_shard_batches_lpt_balances_predicted_load():
    spec = _spec("s", nodes=[3, 5, 7, 10, 14])
    batches = plan(spec)
    assert len(batches) == 5
    costs = [8.0, 5.0, 3.0, 2.0, 2.0]
    pri = {b.key: c for b, c in zip(batches, costs)}
    deal = shard_batches(batches, 2, priorities=pri)
    dealt = [b.batch_id for bs in deal.values() for b in bs]
    assert sorted(dealt) == sorted(b.batch_id for b in batches)
    loads = {w: sum(pri[b.key] for b in bs) for w, bs in deal.items()}
    assert loads == {0: 10.0, 1: 10.0}
    again = shard_batches(list(reversed(batches)), 2, priorities=pri)
    assert {w: [b.batch_id for b in bs] for w, bs in deal.items()} == \
           {w: [b.batch_id for b in bs] for w, bs in again.items()}
    zero = shard_batches(batches, 2, priorities={b.key: 0.0
                                                 for b in batches})
    assert sorted(len(bs) for bs in zero.values()) == [2, 3]


# ================================================== prepare_store record
def test_prepare_store_records_nearest_donors_and_is_idempotent(
        tmp_path, monkeypatch):
    donor = _fab_campaign(tmp_path / "donor", _spec("donor"))
    tspec = _spec("tgt", nodes=[5], transfer_from=[str(tmp_path / "donor")])
    store = CampaignStore.create(str(tmp_path / "tgt"), tspec)
    rec = transfer_mod.prepare_store(store, _silent, **CPU)

    batch = plan_cached(tspec)[0]
    d = rec["donors"][batch.key]["cells"][batch.cells[0].cell_id]
    assert d["cell_id"] == f"{ARCH}__7nm__high_perf"
    assert d["root"] == os.path.abspath(str(tmp_path / "donor"))
    assert d["distance"] > 0
    assert rec["donors"][batch.key]["weights"] is None
    assert rec["cost_model"]["n_cells"] == 2
    assert cm.load_cost_model(store.root, **CPU) is not None
    with open(os.path.join(store.model_dir(), "eval.json")) as f:
        ev = json.load(f)
    assert set(ev["held_out_sq_residual"]) == \
           {c.cell_id for c in cells(donor.spec)}

    # the reference's record of the same donor: donors and roots bitwise
    rstore = RefStore.create(str(tmp_path / "rtgt"), RefSpec(**_kw(
        "tgt", nodes=[5], transfer_from=[str(tmp_path / "donor")])))
    want = ref_transfer.prepare_store(rstore, _silent)
    assert rec["donors"] == want["donors"] and rec["roots"] == want["roots"]
    assert {k: v for k, v in rec["cost_model"].items() if k != "resid_var"} \
        == {k: v for k, v in want["cost_model"].items()
            if k != "resid_var"}

    def boom(*a, **kw):
        raise AssertionError("prepare_store refit on re-entry")
    monkeypatch.setattr(transfer_mod, "_fit_and_persist", boom)
    assert transfer_mod.prepare_store(store, _silent, **CPU) == rec
    assert CampaignStore.open(store.root).manifest["transfer"] == rec


def test_prepare_store_rejects_unusable_donors(tmp_path):
    store = CampaignStore.create(str(tmp_path / "plain"), _spec("plain"))
    with pytest.raises(ValueError, match="transfer_from"):
        transfer_mod.prepare_store(store, _silent, **CPU)
    CampaignStore.create(str(tmp_path / "idle"), _spec("idle"))
    tspec = _spec("t2", transfer_from=[str(tmp_path / "idle")])
    store = CampaignStore.create(str(tmp_path / "t2"), tspec)
    with pytest.raises(ValueError, match="no completed"):
        transfer_mod.prepare_store(store, _silent, **CPU)


def test_find_weights_prefers_highest_step(tmp_path):
    root, bid = str(tmp_path), "b000__x__high_perf__3nm"
    assert transfer_mod.find_weights(root, bid) is None
    ckpt_mod.save(dict(a=np.zeros(2)),
                  os.path.join(root, "model", "weights", bid), step=2)
    ckpt_mod.save(dict(a=np.ones(2)),
                  os.path.join(root, "worker-1", "model", "weights", bid),
                  step=5)
    got = transfer_mod.find_weights(root, bid)
    assert got == os.path.join(root, "worker-1", "model", "weights", bid)
    flat, _ = ckpt_mod.restore_flat(got)
    assert np.array_equal(flat["a"], np.ones(2))


# ==================================================== persistent cost model
def test_cost_model_fit_roundtrip_deterministic(tmp_path):
    _fab_campaign(tmp_path / "donor", _spec("donor"))
    index = ArchiveIndex.build([str(tmp_path / "donor")])
    model = cm.fit_cost_model(index, steps=25, seed=3, **CPU)
    assert model.meta["n_rows"] == 6 and model.meta["n_cells"] == 2

    x, y, rows = cm.dataset(index)
    assert model.predict_ppa(x).shape == (6, 3)
    ctx = np.stack(list(cm.cell_contexts(index).values()))
    ep = model.predict_episodes(ctx)
    assert ep.shape == (2,) and np.all(np.isfinite(ep)) and np.all(ep >= 0)

    again = cm.fit_cost_model(ArchiveIndex.build([str(tmp_path / "donor")]),
                              steps=25, seed=3, **CPU)
    assert np.array_equal(again.cost_w, model.cost_w)
    assert np.array_equal(again.predict_ppa(x), model.predict_ppa(x))

    root = str(tmp_path / "store")
    cm.save_cost_model(model, root)
    back = cm.load_cost_model(root, **CPU)
    assert np.allclose(back.cost_w, model.cost_w)
    assert np.allclose(back.predict_ppa(x), model.predict_ppa(x),
                       rtol=1e-6)
    assert np.allclose(back.predict_episodes(ctx), ep, rtol=1e-6)
    assert back.meta["cells"] == model.meta["cells"]
    assert cm.load_cost_model(str(tmp_path / "nowhere"), **CPU) is None

    res = cm.holdout_residuals(index, steps=10, seed=3, **CPU)
    assert set(res) == set(model.meta["cells"])
    assert all(np.isfinite(v) and v >= 0 for v in res.values())


def test_with_transfer_fills_priorities_or_degrades_to_weights_only(
        tmp_path):
    _fab_campaign(tmp_path / "donor", _spec("donor"))
    tspec = transfer_mod.with_transfer(_spec("tgt", nodes=[5]),
                                       [str(tmp_path / "donor")], **CPU)
    assert tspec.transfer_from == [os.path.abspath(str(tmp_path / "donor"))]
    assert set(tspec.priorities) == {b.key for b in plan_cached(tspec)}
    assert all(isinstance(v, float) and v >= 0
               for v in tspec.priorities.values())
    assert CampaignSpec.from_dict(tspec.to_dict()) == tspec

    spec_e = _spec("empty")
    store_e = CampaignStore.create(str(tmp_path / "empty"), spec_e)
    for cell in cells(spec_e):
        store_e.complete_cell(cell, dict(cell_id=cell.cell_id,
                                         ppa_score=1e9,
                                         episodes=8, wall_s=1.0), [])
    weak = transfer_mod.with_transfer(_spec("t2", nodes=[5]),
                                      [str(tmp_path / "empty")], **CPU)
    assert weak.transfer_from and weak.priorities is None
    with pytest.raises(FileNotFoundError):
        transfer_mod.with_transfer(_spec("t3"), [str(tmp_path / "nope")],
                                   **CPU)


# =================================================================== CLI
def test_cli_transfer_from_validation(tmp_path, capsys):
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps(dict(name="g", workloads=[ARCH], nodes=[3],
                                    modes=["high_perf"], episodes=8,
                                    lanes=4, max_envs=4)))
    with pytest.raises(SystemExit):
        dse.main(["--campaign", str(grid), "--device", "cpu",
                  "--transfer-from", str(tmp_path / "nope")])
    assert "no campaign manifest" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        dse.main(["--resume", str(tmp_path), "--device", "cpu",
                  "--transfer-from", str(tmp_path)])
    assert "start a new campaign" in capsys.readouterr().err


# ======================================================== end to end
def _target(ref_donor, name, **kw):
    return transfer_mod.with_transfer(_spec(name, **{"nodes": [5], **kw}),
                                      [ref_donor.root], **CPU)


def test_transfer_end_to_end_warm_start(tmp_path, ref_donor):
    """A donor campaign the reference ran -> the port's with_transfer -> a
    warm-started port campaign: donors and weights recorded, the warm seed
    re-evaluated and feasible, the cost model and its eval on the target
    root."""
    assert ref_donor.all_done()
    with open(os.path.join(ref_donor.root, "report", "scaling.json")) as f:
        assert set(json.load(f)["cells"]) == {
            c.cell_id for c in cells(_spec("donor"))}
    tspec = _target(ref_donor, "tgt")
    store = run_campaign(str(tmp_path / "tgt"), tspec, progress=_silent,
                         **CPU)
    assert store.all_done()

    rec = store.manifest["transfer"]
    assert rec["roots"] == [os.path.abspath(ref_donor.root)]
    batch = plan_cached(tspec)[0]
    assert rec["donors"][batch.key]["cells"][batch.cells[0].cell_id][
        "cell_id"] == f"{ARCH}__7nm__high_perf"
    w = rec["donors"][batch.key]["weights"]
    assert w and os.path.isdir(w["dir"])
    assert rec["cost_model"]["n_rows"] > 0

    wl = extract(get_config(ARCH), seq_len=tspec.seq_len, batch=tspec.batch)
    ws = transfer_mod.load_warm_start(store, batch, wl, **CPU)
    assert ws is not None and ws["flat"]
    assert any(k.startswith("sac/") for k in ws["flat"])
    seeded = [c for c in ws["cells"] if c]
    assert seeded
    for c in seeded:
        assert all(e.episode == 0 for e in c["entries"])
        score, cfg, metrics = c["best"]
        assert score == min(e.ppa_score for e in c["entries"])
        assert cfg.shape == (cs.DIM,) and len(metrics) == M_DIM

    assert cm.load_cost_model(store.root, **CPU) is not None
    assert os.path.isfile(os.path.join(store.model_dir(), "eval.json"))
    assert os.path.isfile(os.path.join(store.root, "report",
                                       "scaling.json"))


# ================================================== against the reference
def test_with_transfer_and_cost_w_bitwise_the_reference(tmp_path,
                                                        ref_donor):
    """On the same donor roots (a real reference campaign and a
    fabricated one): priorities, the donor record and ``cost_w`` are
    bitwise the reference's (the MLP, fitted from another init, is held
    by ``test_torch_recommend.py``)."""
    fab = _fab_campaign(tmp_path / "fab", _spec("fab", nodes=[3, 10]))
    roots = [ref_donor.root, fab.root]
    kw = dict(nodes=[5, 14, 28], modes=["high_perf", "low_power"],
              max_envs=8)
    ours = transfer_mod.with_transfer(_spec("t", **kw), roots, **CPU)
    want = ref_transfer.with_transfer(RefSpec(**_kw("t", **kw)), roots)
    assert ours.to_dict() == want.to_dict()
    assert ours.priorities and len(ours.priorities) == 4

    model = cm.fit_cost_model(ArchiveIndex.build(roots), **CPU)
    ref_model = ref_cm.fit_cost_model(RefIndex.build(roots))
    assert np.array_equal(model.cost_w, ref_model.cost_w)
    assert {k: v for k, v in model.meta.items() if k != "resid_var"} == \
        {k: v for k, v in ref_model.meta.items() if k != "resid_var"}

    store = CampaignStore.create(str(tmp_path / "ours"), ours)
    rstore = RefStore.create(str(tmp_path / "ref"), want)
    got = transfer_mod.prepare_store(store, _silent, **CPU)
    ref_rec = ref_transfer.prepare_store(rstore, _silent)
    assert got["donors"] == ref_rec["donors"]


def test_load_cost_model_reads_across_both_ways(tmp_path, ref_donor):
    index = ArchiveIndex.build([ref_donor.root])
    ours = cm.fit_cost_model(index, steps=20, **CPU)
    cm.save_cost_model(ours, str(tmp_path / "a"))
    back = ref_cm.load_cost_model(str(tmp_path / "a"))
    assert np.array_equal(back.cost_w, ours.cost_w)
    assert back.meta == json.loads(json.dumps(ours.meta))
    for layer in ("l1", "l2", "head"):
        for k in ("w", "b"):
            assert np.array_equal(np.asarray(back.sur.params[layer][k]),
                                  ours.sur.params[layer][k].numpy())

    ref = ref_cm.fit_cost_model(RefIndex.build([ref_donor.root]), steps=20)
    ref_cm.save_cost_model(ref, str(tmp_path / "b"))
    mine = cm.load_cost_model(str(tmp_path / "b"), **CPU)
    assert np.array_equal(mine.cost_w, ref.cost_w)
    for layer in ("l1", "l2", "head"):
        for k in ("w", "b"):
            assert np.array_equal(mine.sur.params[layer][k].numpy(),
                                  np.asarray(ref.sur.params[layer][k]))
    x, _, _ = cm.dataset(index)
    # atol for predictions near 0, where float32 products' absolute
    # error of ~1e-7 dominates
    np.testing.assert_allclose(mine.predict_ppa(x), ref.predict_ppa(x),
                               rtol=1e-5, atol=1e-6)
    ctx = np.stack(list(cm.cell_contexts(index).values()))
    assert np.array_equal(mine.predict_episodes(ctx),
                          ref.predict_episodes(ctx))


def test_load_warm_start_matches_the_reference(tmp_path, ref_donor):
    """The same manifest record, materialized by each package: the donor
    leaves bitwise, the re-evaluated frontier (designs bitwise, metrics
    within rtol 1e-5, the same feasible set) and the incumbent."""
    tspec = _target(ref_donor, "ws", nodes=[5, 10], max_envs=8)
    store = CampaignStore.create(str(tmp_path / "ws"), tspec)
    transfer_mod.prepare_store(store, _silent, **CPU)
    batch = plan_cached(tspec)[0]
    wl = extract(get_config(ARCH), seq_len=256, batch=1)
    ours = transfer_mod.load_warm_start(store, batch, wl, **CPU)
    ref_store = RefStore.open(store.root)
    from repro.campaign.planner import plan_cached as ref_plan_cached
    want = ref_transfer.load_warm_start(
        ref_store, ref_plan_cached(ref_store.spec)[0],
        ref_extract(ref_get_config(ARCH), seq_len=256, batch=1))
    assert ours["flat"].keys() == want["flat"].keys()
    for k in ours["flat"]:
        assert np.array_equal(ours["flat"][k], want["flat"][k])
    assert len(ours["cells"]) == len(want["cells"]) == 2
    n_seeded = 0
    for got, ref in zip(ours["cells"], want["cells"]):
        assert (got is None) == (ref is None)
        if got is None:
            continue
        n_seeded += 1
        assert len(got["entries"]) == len(ref["entries"])
        for a, b in zip(got["entries"], ref["entries"]):
            assert np.array_equal(a.cfg, b.cfg) and a.episode == b.episode
            np.testing.assert_allclose(
                [a.power_mw, a.perf_gops, a.area_mm2, a.tok_s, a.ppa_score],
                [b.power_mw, b.perf_gops, b.area_mm2, b.tok_s, b.ppa_score],
                rtol=1e-5)
        assert got["best"][0] == pytest.approx(ref["best"][0], rel=1e-5)
        assert np.array_equal(got["best"][1], ref["best"][1])
    assert n_seeded


def test_warm_started_designs_hold_against_the_reference(tmp_path,
                                                         ref_donor):
    """The warm-started search's archive and pick, re-evaluated by the
    reference's evaluator: feasible, within rtol 1e-5.  The donor's
    weights really seeded the learner: the batch ran from them."""
    tspec = _target(ref_donor, "hold")
    store = CampaignStore.create(str(tmp_path / "hold"), tspec)
    transfer_mod.prepare_store(store, _silent, **CPU)
    batch = plan_cached(tspec)[0]
    wl = extract(get_config(ARCH), seq_len=256, batch=1)
    warm = transfer_mod.load_warm_start(store, batch, wl, **CPU)
    seen = {}
    real_create = search_mod.sac_mod.create

    def spying_create(*a, **kw):
        seen["fresh"] = real_create(*a, **kw)
        return seen["fresh"]

    search_mod.sac_mod.create = spying_create
    try:
        res, = search_mod.run_search_cells(
            wl, [5], search=search_mod.SearchConfig(episodes=32, seed=0),
            lanes_per_cell=4, warm_start=warm, **CPU)
    finally:
        search_mod.sac_mod.create = real_create
    assert res.best_cfg is not None and len(res.archive)
    # the donor's weights differ from the fresh init the search replaced
    fresh = seen["fresh"].params.actor["l1"]["w"].numpy()
    donor = warm["flat"]["sac/.params/.actor/l1/w"]
    assert not np.array_equal(fresh, donor)
    node = ref_an.node_vector(node_params(5), high_perf=True)
    cfgs = np.stack([e.cfg for e in res.archive.entries] + [res.best_cfg])
    m = np.asarray(ref_an.evaluate_batch(
        ref_cs.project(jnp.asarray(cfgs)), jnp.asarray(wl.features),
        jnp.asarray(node)))
    stored = np.array([[e.power_mw, e.perf_gops, e.area_mm2, e.tok_s,
                        e.ppa_score] for e in res.archive.entries])
    cols = [M_IDX[n] for n in ("power_mw", "perf_gops", "area_mm2",
                               "tok_s", "ppa_score")]
    np.testing.assert_allclose(stored, m[:-1, cols], rtol=1e-5)
    assert (m[:, M_IDX["feasible"]] == 1.0).all()
    assert res.best_score == pytest.approx(
        float(m[-1, M_IDX["ppa_score"]]), rel=1e-5)


def test_warm_campaign_kill_resume_is_bitwise(tmp_path, ref_donor):
    """A warm-started campaign killed after its first checkpoint and
    resumed equals its uninterrupted run (summaries but their clock,
    frontiers, the transfer record): the resume restores the warmed
    state from the checkpoint and does not warm-start again."""
    tspec = _target(ref_donor, "kr", nodes=[5, 14], episodes=48,
                     max_envs=8, checkpoint_every=2)
    full = run_campaign(str(tmp_path / "full"), tspec, progress=_silent,
                        **CPU)
    real = search_mod._save_search_ckpt
    saves = []

    def killing(*a, **kw):
        out = real(*a, **kw)
        saves.append(a[1])
        raise KeyboardInterrupt("killed after a checkpoint")

    search_mod._save_search_ckpt = killing
    try:
        with pytest.raises(KeyboardInterrupt):
            run_campaign(str(tmp_path / "kill"), tspec, progress=_silent,
                         **CPU)
    finally:
        search_mod._save_search_ckpt = real
    assert saves == [2]
    resumed = run_campaign(str(tmp_path / "kill"), progress=_silent,
                           resume=True, **CPU)
    assert resumed.all_done()
    assert resumed.manifest["transfer"] == full.manifest["transfer"]
    for cid in full.manifest["cells"]:
        strip = lambda s: {k: v for k, v in s.items() if k != "wall_s"}
        assert strip(resumed.load_summary(cid)) == strip(
            full.load_summary(cid))
        fa = full.load_archive(cid).frontier()
        fb = resumed.load_archive(cid).frontier()
        for k in fa:
            np.testing.assert_array_equal(np.sort(fa[k]), np.sort(fb[k]))
