"""The port's scenario engine (prefill/decode extraction, grouped MoE graphs
and routing imbalance, dtype axes, SLO-aware selection, scenario cell ids
and reports) against the JAX reference's, on the CPU at a small size.

Each case mirrors one of ``tests/test_scenarios.py``.  Where that file
compares with its golden fingerprint, these compare with a fresh reference
run; the campaign cases recompute the port's SLO picks with the
reference's ``ttft_ms``, ``slo_objective`` and ``evaluate_batch``.  The
reduced scenario campaign also survives a kill/resume bit for bit."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.campaign.runner as ref_runner_mod
from repro.campaign import CampaignSpec as RefSpec
from repro.campaign import plan as ref_plan
from repro.campaign import run_campaign as ref_run_campaign
from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.core import reward as ref_rw
from repro.launch import dse as ref_dse
from repro.launch.recommend import split_cell_id as ref_split_cell_id
from repro.launch.recommend import split_scenario as ref_split_scenario
from repro.ppa import analytic as ref_an
from repro.ppa import config_space as ref_cs
from repro.ppa.nodes import node_params as ref_node_params
from repro.workload import extract as ref_ex
from repro.workload.features import as_feature_vector as ref_as_vec
import repro_torch.campaign.runner as runner_mod
import repro_torch.core.search as search_mod
from repro_torch.campaign import CampaignSpec, CampaignStore, plan, run_campaign
from repro_torch.campaign.planner import scenario_suffix
from repro_torch.launch.recommend import split_cell_id, split_scenario
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.reward import (DEFAULT_SLOS, resolve_slo,
                                     slo_objective, ttft_ms)
from repro_torch.launch import dse
from repro_torch.workload.extract import (_PREC_BYTES, build_graph, extract,
                                          routing_imbalance)
from repro_torch.workload.features import (WL_DIM, WL_DIM_LEGACY, WL_IDX,
                                           as_feature_vector)

MOE_ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b")
QUIET = dict(progress=lambda m: None, device="cpu")
# the reduced Mixtral campaign over the phase axis with per-mode SLOs
MOE_SPEC = dict(name="moe-scen", workloads=["mixtral-8x7b"], nodes=[7],
                modes=["high_perf"], episodes=16, lanes=4, max_envs=4,
                seed=0, seq_len=128, batch=1, checkpoint_every=4,
                phases=["decode", "prefill"], slo=DEFAULT_SLOS)
SCEN_KEYS = ("dtype", "phase", "ttft_ms", "slo_ok")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def wlf(wl, name):
    return float(wl.features[WL_IDX[name]])


def _same_features(got, want):
    np.testing.assert_array_equal(np.asarray(got.features),
                                  np.asarray(want.features))


# ------------------------------------------------------------- extraction
def test_prec_bytes_has_fp8():
    assert _PREC_BYTES == ref_ex._PREC_BYTES
    assert _PREC_BYTES["fp8"] == _PREC_BYTES["float8"] == 1
    assert _PREC_BYTES["int8"] == 1


def test_dtype_axis_shrinks_weight_bytes():
    cfg, rcfg = get_config("smollm-135m"), ref_get_config("smollm-135m")
    base = extract(cfg, seq_len=256, batch=1)
    fp8 = extract(cfg, seq_len=256, batch=1, dtype="fp8")
    int8 = extract(cfg, seq_len=256, batch=1, dtype="int8")
    for dt, wl in (("native", base), ("fp8", fp8), ("int8", int8)):
        _same_features(wl, ref_ex.extract(rcfg, seq_len=256, batch=1,
                                          dtype=dt))
    assert wlf(fp8, "weight_mb") == pytest.approx(
        0.5 * wlf(base, "weight_mb"))
    assert wlf(int8, "weight_mb") == pytest.approx(
        0.5 * wlf(base, "weight_mb"))
    assert wlf(fp8, "dtype_fp8") == 1.0 and wlf(fp8, "dtype_int8") == 0.0
    assert wlf(int8, "dtype_int8") == 1.0 and wlf(int8, "dtype_fp8") == 0.0
    assert wlf(base, "dtype_fp8") == 0.0 and wlf(base, "dtype_int8") == 0.0
    with pytest.raises(ValueError):
        extract(cfg, seq_len=256, batch=1, dtype="fp4")
    with pytest.raises(ValueError):
        extract(cfg, seq_len=256, batch=1, phase="chunked")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_graph_is_linear_in_layers(arch):
    cfg = get_config(arch)
    g = build_graph(cfg, 256)
    want = ref_ex.build_graph(ref_get_config(arch), 256)
    assert g.names == want.names
    np.testing.assert_array_equal(g.flops, want.flops)
    assert g.n_ops <= 12 * cfg.n_layers
    n_moe_layers = sum(cfg.moe_on_layer(li) for li in range(cfg.n_layers))
    grouped = [n for n in g.names if n.endswith(".experts")]
    assert len(grouped) == n_moe_layers
    assert not any("exp0" in n or "expert0" in n for n in g.names)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_weight_traffic_respects_activation(arch):
    cfg = get_config(arch)
    dec = extract(cfg, seq_len=256, batch=1)
    pre = extract(cfg, seq_len=256, batch=1, phase="prefill")
    _same_features(dec, ref_ex.extract(ref_get_config(arch), seq_len=256,
                                       batch=1))
    _same_features(pre, ref_ex.extract(ref_get_config(arch), seq_len=256,
                                       batch=1, phase="prefill"))
    assert 0 < wlf(dec, "weight_traffic_mb") < wlf(dec, "weight_mb")
    assert wlf(pre, "weight_traffic_mb") == wlf(pre, "weight_mb")
    assert wlf(dec, "weight_mb") == wlf(pre, "weight_mb")


def test_dense_weight_traffic_equals_footprint():
    wl = extract(get_config("smollm-135m"), seq_len=256, batch=1)
    assert wlf(wl, "weight_traffic_mb") == wlf(wl, "weight_mb")


def test_routing_imbalance_bounds():
    for args in ((1, 1, 64), (8, 8, 64), (8, 2, 1), (8, 2, 4096),
                 (128, 1, 1), (16, 2, 3 * 2048)):
        assert routing_imbalance(*args) == ref_ex.routing_imbalance(*args)
    assert routing_imbalance(1, 1, 64) == 0.0
    assert routing_imbalance(8, 8, 64) == 0.0
    few = routing_imbalance(8, 2, 1)
    many = routing_imbalance(8, 2, 4096)
    assert few > many > 0.0
    assert few <= 8 / 2 - 1


def test_prefill_phase_semantics():
    cfg = get_config("mixtral-8x7b")
    dec = extract(cfg, seq_len=512, batch=2)
    pre = extract(cfg, seq_len=512, batch=2, phase="prefill")
    _same_features(pre, ref_ex.extract(ref_get_config("mixtral-8x7b"),
                                       seq_len=512, batch=2, phase="prefill"))
    assert wlf(dec, "phase") == 0.0 and wlf(pre, "phase") == 1.0
    assert wlf(pre, "batch") == 2 * 512
    assert wlf(dec, "batch") == 2
    assert wlf(pre, "spec_decode_ok") == 0.0
    assert wlf(pre, "moe_imbalance") < wlf(dec, "moe_imbalance")


def test_legacy_30dim_vector_zero_pads():
    v = as_feature_vector(np.ones(WL_DIM_LEGACY, np.float32))
    assert v.shape == (WL_DIM,)
    assert (v[:WL_DIM_LEGACY] == 1.0).all()
    assert (v[WL_DIM_LEGACY:] == 0.0).all()
    np.testing.assert_array_equal(
        v, ref_as_vec(np.ones(WL_DIM_LEGACY, np.float32)))


# -------------------------------------------------------------- cell ids
def test_cell_id_scenario_roundtrip():
    assert scenario_suffix("native", "decode") == ""
    assert scenario_suffix("fp8", "prefill") == "__fp8-prefill"
    cid = "a__b__5nm__low_power"
    for c in (cid, cid + "__fp8-prefill", cid + "__int8-decode"):
        assert split_scenario(c) == ref_split_scenario(c)
        assert split_cell_id(c) == ref_split_cell_id(c)
    assert split_cell_id(cid) == ("a__b", 5, "low_power")
    assert split_scenario(cid) == (cid, "native", "decode")
    assert split_scenario(cid + "__fp8-prefill") == (cid, "fp8", "prefill")


# ------------------------------------------------------------------- SLO
def test_slo_resolution_and_objective():
    assert DEFAULT_SLOS == ref_rw.DEFAULT_SLOS
    flat = {"ttft_ms": 100.0, "tok_s": 5.0}
    for spec in (None, {}, flat, DEFAULT_SLOS, {"high_perf": {"tok_s": 9}}):
        for mode in ("high_perf", "low_power"):
            assert resolve_slo(spec, mode) == ref_rw.resolve_slo(spec, mode)
    assert resolve_slo(None, "high_perf") == DEFAULT_SLOS["high_perf"]
    assert resolve_slo(flat, "low_power") == flat
    assert ttft_ms(1000.0, 512, 2) == pytest.approx(1024.0)
    for args in ((0.5, 50.0, 80.0), (0.5, 2.0, 300.0), (0.1, 29.0, 501.0)):
        assert slo_objective(*args, flat) == ref_rw.slo_objective(*args,
                                                                  flat)
    meets = slo_objective(0.5, 50.0, 80.0, flat)
    misses = slo_objective(0.5, 2.0, 300.0, flat)
    assert meets == pytest.approx(0.5)
    assert misses > meets


@pytest.mark.parametrize("kw", [dict(dtypes=["fp4"]), dict(phases=[]),
                                dict(slo={"ttft_ms": -1.0}),
                                dict(slo={"high_perf": {"nope": 1.0}}),
                                dict(slo={"turbo": {"tok_s": 1.0}}),
                                dict(slo={"tok_s": True})])
def test_campaign_spec_scenario_validation(kw):
    base = dict(name="x", workloads=["smollm-135m"])
    with pytest.raises(ValueError):
        RefSpec(**base, **kw)
    with pytest.raises(ValueError):
        CampaignSpec(**base, **kw)
    spec = CampaignSpec(**base, dtypes=["native", "fp8"],
                        phases=["decode", "prefill"], slo=DEFAULT_SLOS)
    assert spec.n_cells == len(spec.nodes) * len(spec.modes) * 4


def test_planner_scenario_grid_keeps_default_first():
    kw = dict(name="g", workloads=["smollm-135m"], nodes=[7],
              modes=["high_perf"], dtypes=["native", "fp8"],
              phases=["decode", "prefill"])
    batches = plan(CampaignSpec(**kw))
    assert [b.key for b in batches] == [
        "smollm-135m__high_perf__7nm",
        "smollm-135m__high_perf__7nm__native-prefill",
        "smollm-135m__high_perf__7nm__fp8-decode",
        "smollm-135m__high_perf__7nm__fp8-prefill"]
    assert [b.batch_id for b in batches] == [
        b.batch_id for b in ref_plan(RefSpec(**kw))]
    assert batches[0].index == 0
    assert batches[0].cells[0].cell_id == "smollm-135m__7nm__high_perf"


def test_default_summary_has_no_scenario_keys(tmp_path):
    spec = dict(name="dflt", workloads=["smollm-135m"], nodes=[7],
                modes=["high_perf"], episodes=16, lanes=4, max_envs=4,
                seed=0, seq_len=128, batch=1)
    ours = run_campaign(str(tmp_path / "port"), CampaignSpec(**spec),
                        **QUIET)
    ref = ref_run_campaign(str(tmp_path / "ref"), RefSpec(**spec),
                           progress=lambda m: None)
    cid = "smollm-135m__7nm__high_perf"
    got, want = ours.load_summary(cid), ref.load_summary(cid)
    assert set(got) == set(want)
    for k in SCEN_KEYS:
        assert k not in got


# ------------------------------------------- scenario campaign end-to-end
def _reduced_run(root, spec, runner=runner_mod, fn=run_campaign, **kw):
    real = runner.get_config
    runner.get_config = get_reduced if runner is runner_mod \
        else ref_get_reduced
    try:
        return fn(root, spec, **kw)
    finally:
        runner.get_config = real


@pytest.fixture(scope="module")
def moe_scenario_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("moescen") / "run")
    return _reduced_run(root, CampaignSpec(**MOE_SPEC), **QUIET)


def test_scenario_campaign_adapts_across_phase_axis(moe_scenario_run):
    store = moe_scenario_run
    dec = store.load_summary("mixtral-8x7b__7nm__high_perf")
    pre = store.load_summary("mixtral-8x7b__7nm__high_perf__native-prefill")
    assert dec["ppa_score"] is not None and pre["ppa_score"] is not None
    assert "phase" not in dec and pre["phase"] == "prefill"
    for s in (dec, pre):
        assert s["ttft_ms"] > 0 and isinstance(s["slo_ok"], bool)


def test_scenario_slo_pick_is_the_reference_objective_argmin(
        moe_scenario_run):
    """Each cell's pick, ``ttft_ms`` and ``slo_ok`` recomputed from its
    stored frontier by the reference's ``evaluate_batch`` (prefill
    workload), ``ttft_ms`` and ``slo_objective``."""
    store = moe_scenario_run
    rcfg = ref_get_reduced("mixtral-8x7b")
    node = jnp.asarray(ref_an.node_vector(ref_node_params(7)))
    aux = ref_ex.extract(rcfg, seq_len=128, batch=1, phase="prefill")
    slo = ref_rw.resolve_slo(DEFAULT_SLOS, "high_perf")
    for phase in ("decode", "prefill"):
        cid = "mixtral-8x7b__7nm__high_perf" + scenario_suffix("native",
                                                               phase)
        summ = store.load_summary(cid)
        ents = store.load_archive(cid).entries
        assert ents
        pre = np.asarray(ref_an.evaluate_batch(
            ref_cs.project(jnp.asarray(np.stack([e.cfg for e in ents]))),
            jnp.asarray(aux.features), node))
        ttfts = [ref_rw.ttft_ms(pre[i, ref_an.M_IDX["tok_s"]], 128, 1)
                 for i in range(len(ents))]
        objs = [ref_rw.slo_objective(e.ppa_score, e.tok_s, t, slo)
                for e, t in zip(ents, ttfts)]
        pick = int(np.argmin(objs))
        assert summ["ttft_ms"] == pytest.approx(ttfts[pick], rel=1e-5)
        assert summ["slo_ok"] == bool(ents[pick].tok_s >= slo["tok_s"]
                                      and ttfts[pick] <= slo["ttft_ms"])
        # the summary's design is the pick, re-evaluated on its workload
        wl = ref_ex.extract(rcfg, seq_len=128, batch=1, phase=phase)
        m = np.asarray(ref_an.evaluate_batch(
            ref_cs.project(jnp.asarray(ents[pick].cfg[None])),
            jnp.asarray(wl.features), node))[0]
        assert summ["ppa_score"] == pytest.approx(
            float(m[ref_an.M_IDX["ppa_score"]]), rel=1e-5)
        c = lambda n: float(ents[pick].cfg[ref_cs.IDX[n]])
        assert summ["mesh"] == (f"{int(round(c('mesh_w')))}x"
                                f"{int(round(c('mesh_h')))}")
        assert summ["vlen"] == int(round(c("vlen")))


def test_scenario_report_groups_by_axis(moe_scenario_run, tmp_path):
    store = moe_scenario_run
    with open(os.path.join(store.root, "report", "adaptation.json")) as f:
        adapt = json.load(f)
    assert "mixtral-8x7b__high_perf" in adapt
    assert "mixtral-8x7b__high_perf__native-prefill" in adapt
    ref = _reduced_run(str(tmp_path / "ref"), RefSpec(**MOE_SPEC),
                       runner=ref_runner_mod, fn=ref_run_campaign,
                       progress=lambda m: None)
    with open(os.path.join(ref.root, "report", "adaptation.json")) as f:
        assert set(json.load(f)) == set(adapt)
    for cid in ref.manifest["cells"]:
        assert set(ref.load_summary(cid)) == set(store.load_summary(cid))


def test_scenario_campaign_kill_resume_is_bitwise(moe_scenario_run,
                                                  tmp_path, monkeypatch):
    spec = CampaignSpec(**dict(MOE_SPEC, name="moe-kill",
                               checkpoint_every=1))
    full = _reduced_run(str(tmp_path / "full"), spec, **QUIET)
    real_save = search_mod._save_search_ckpt
    saves = []

    def killing_save(*args, **kw):
        out = real_save(*args, **kw)
        saves.append(args[1])
        if len(saves) == 5:        # the second batch, after 2 checkpoints
            raise KeyboardInterrupt("simulated kill")
        return out

    monkeypatch.setattr(search_mod, "_save_search_ckpt", killing_save)
    root = str(tmp_path / "killed")
    with pytest.raises(KeyboardInterrupt):
        _reduced_run(root, spec, **QUIET)
    monkeypatch.setattr(search_mod, "_save_search_ckpt", real_save)
    store = CampaignStore.open(root)
    assert not store.all_done()
    assert store.manifest["cells"]["mixtral-8x7b__7nm__high_perf"][
        "status"] == "done"
    real = runner_mod.get_config
    monkeypatch.setattr(runner_mod, "get_config", get_reduced)
    store = run_campaign(root, resume=True, **QUIET)
    monkeypatch.setattr(runner_mod, "get_config", real)
    assert store.all_done()
    for cid in full.manifest["cells"]:
        a, b = full.load_summary(cid), store.load_summary(cid)
        a.pop("wall_s"), b.pop("wall_s")
        assert a == b and "ttft_ms" in a
        fa, fb = (s.load_archive(cid).frontier() for s in (full, store))
        for k in fa:
            np.testing.assert_array_equal(np.sort(fa[k]), np.sort(fb[k]))


def test_scenario_recommend_exact_with_ttft_cap(moe_scenario_run):
    """Scenario queries answered from the suffixed cells: a prefill query
    under a loose TTFT cap is the prefill cell's archive pick (bitwise the
    reference recommender's on the same run directory), an impossible cap
    falls through to the surrogate."""
    from repro.launch.recommend import Query as RefQuery
    from repro.launch.recommend import Recommender as RefRecommender
    from repro_torch.launch.recommend import Query, Recommender
    store = moe_scenario_run
    rec = Recommender.build([store.root], fit_steps=10,
                              device="cpu")
    a_dec = rec.recommend(Query(node_nm=7, arch="mixtral-8x7b"))
    a_pre = rec.recommend(Query(node_nm=7, arch="mixtral-8x7b",
                                phase="prefill", max_ttft_ms=1e9))
    assert a_dec.source == "archive"
    assert a_dec.cell_id == "mixtral-8x7b__7nm__high_perf"
    assert a_pre.source == "archive"
    assert a_pre.cell_id == "mixtral-8x7b__7nm__high_perf__native-prefill"
    a_miss = rec.recommend(Query(node_nm=7, arch="mixtral-8x7b",
                                 phase="prefill", max_ttft_ms=1e-6))
    assert a_miss.source == "surrogate"
    ref = RefRecommender.build([store.root], fit_steps=10).recommend(
        RefQuery(node_nm=7, arch="mixtral-8x7b", phase="prefill",
                 max_ttft_ms=1e9))
    assert np.array_equal(a_pre.cfg, ref.cfg)
    assert (a_pre.power_mw, a_pre.tok_s, a_pre.ppa_score) == (
        ref.power_mw, ref.tok_s, ref.ppa_score)


# --------------------------------------------------------------- DSE CLI
def test_dse_cli_scenario_flags(tmp_path, capsys):
    flags = ["--arch", "smollm-135m", "--nodes", "7", "--method", "random",
             "--episodes", "64", "--seq-len", "128", "--batch", "1",
             "--phase", "prefill", "--dtype", "fp8"]
    dse.main(flags + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    ref_dse.main(flags + ["--out", str(tmp_path / "ref")])
    name = "smollm-135m__random_summary.json"
    rows = json.load(open(os.path.join(tmp_path / "port", name)))
    want = json.load(open(os.path.join(tmp_path / "ref", name)))
    assert rows and rows[0]["node_nm"] == 7
    for k in ("mesh", "episodes", "feasible", "unique"):
        assert rows[0][k] == want[0][k], k
    for k in ("ppa_score", "tok_s", "power_mw", "area_mm2"):
        assert rows[0][k] == pytest.approx(want[0][k], rel=1e-5,
                                           nan_ok=True)


def test_dse_cli_rejects_scenario_flags_with_campaign(tmp_path):
    grid = tmp_path / "g.json"
    grid.write_text(json.dumps(dict(name="x", workloads=["smollm-135m"])))
    with pytest.raises(SystemExit):
        dse.main(["--campaign", str(grid), "--phase", "prefill",
                  "--device", "cpu"])


def test_scenario_smoke_grid_runs_through_the_cli(tmp_path, capsys):
    grid = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "grids",
        "scenario_smoke.json")
    root = str(tmp_path / "runs")
    dse.main(["--campaign", grid, "--campaign-root", root,
              "--device", "cpu"])
    store = CampaignStore.open(os.path.join(root, "scenario-smoke"))
    assert store.all_done() and len(store.summaries()) == 4
    ids = sorted(store.manifest["cells"])
    assert ids == sorted("smollm-135m__7nm__high_perf"
                         + scenario_suffix(dt, ph)
                         for dt in ("native", "fp8")
                         for ph in ("decode", "prefill"))
    assert "[campaign] scenario-smoke: 4 cells run" in capsys.readouterr().out
