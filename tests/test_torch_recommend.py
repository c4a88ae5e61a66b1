"""The ported recommendation path (``repro_torch.launch.recommend``, the
index surrogate of ``repro_torch.ppa.surrogate`` and the server of
``repro_torch.launch.serve``) on the CPU, over a campaign run directory
the JAX reference wrote.

Each case of ``tests/test_recommend.py`` and the two server cases of
``tests/test_obs.py`` are mirrored; the cross-package cases hold the port
against the reference on the same index: ``training_set`` and
``cand_matrix`` bitwise, ``fit_index_surrogate`` from the reference's
injected init (1e-6 after one step, 1e-2 after 400),
``score_query_batch`` on the same parameters (same picks and budget flags,
predictions within rtol 1e-5, atol 1e-6) and exact answers bitwise."""
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ppa.surrogate as ref_sur
from repro.campaign import CampaignSpec as RefSpec
from repro.campaign import run_campaign as ref_run_campaign
from repro.campaign.report import write_index_report as ref_index_report
from repro.launch.recommend import ArchiveIndex as RefIndex
from repro.launch.recommend import Query as RefQuery
from repro.launch.recommend import Recommender as RefRecommender
from repro_torch import convert
from repro_torch.campaign import CampaignStore
from repro_torch.launch.recommend import (MODE_WEIGHTS, ArchiveIndex, Query,
                                          Recommender, main as recommend_main,
                                          split_cell_id)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.ppa import surrogate as sur_mod

ARCH = "smollm-135m"
IN_NODE, IN_NODE2, OUT_NODE = 3, 7, 14
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def campaign_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("recsvc") / "camp")
    spec = RefSpec(name="recsvc", workloads=[ARCH],
                   nodes=[IN_NODE, IN_NODE2], modes=["high_perf"],
                   episodes=32, lanes=4, max_envs=8, seed=0,
                   seq_len=256, batch=1, checkpoint_every=2)
    ref_run_campaign(root, spec, progress=lambda m: None)
    return root


@pytest.fixture(scope="module")
def rec(campaign_root):
    return Recommender.build([campaign_root], **CPU)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------- queries
def test_query_validation():
    with pytest.raises(ValueError, match="exactly one"):
        Query(node_nm=IN_NODE)
    with pytest.raises(ValueError, match="exactly one"):
        Query(node_nm=IN_NODE, arch=ARCH, features=np.zeros(30))
    with pytest.raises(ValueError, match="unknown arch"):
        Query(node_nm=IN_NODE, arch="not-a-model")
    with pytest.raises(ValueError, match="process node"):
        Query(node_nm=4, arch=ARCH)
    with pytest.raises(ValueError, match="unknown mode"):
        Query(node_nm=IN_NODE, arch=ARCH, mode="turbo")
    with pytest.raises(ValueError, match="unknown query key"):
        Query.from_dict({"node_nm": IN_NODE, "arch": ARCH, "speed": 9})
    with pytest.raises(ValueError, match="node_nm"):
        Query.from_dict({"arch": ARCH})
    with pytest.raises(ValueError, match="unknown workload feature"):
        Query(node_nm=IN_NODE, features={"not_a_field": 1.0})
    q = Query.from_dict({"node_nm": IN_NODE, "arch": ARCH})
    assert q.weights == MODE_WEIGHTS["high_perf"]
    q2 = Query(node_nm=IN_NODE, arch=ARCH, w_perf=1.0, w_power=0.5,
               w_area=0.25)
    assert q2.weights == (1.0, 0.5, 0.25)


def test_split_cell_id_roundtrips_double_underscore_arch():
    assert split_cell_id("a__b__5nm__low_power") == ("a__b", 5, "low_power")


# ---------------------------------------------------------- exact path
def test_in_grid_answer_bitwise_matches_archive_select(campaign_root, rec):
    store = CampaignStore.open(campaign_root)
    for node in (IN_NODE, IN_NODE2):
        cid = f"{ARCH}__{node}nm__high_perf"
        ref = store.load_archive(cid).select(*MODE_WEIGHTS["high_perf"])
        ans = rec.recommend(Query(arch=ARCH, node_nm=node))
        assert ans.source == "archive" and ans.cell_id == cid
        assert np.array_equal(ans.cfg, ref.cfg)
        assert ans.power_mw == ref.power_mw
        assert ans.perf_gops == ref.perf_gops
        assert ans.area_mm2 == ref.area_mm2
        assert ans.tok_s == ref.tok_s
        assert ans.ppa_score == ref.ppa_score
        assert ans.within_budget


def test_budget_filters_archive_answer(rec):
    ar = rec.index.cells[f"{ARCH}__{IN_NODE}nm__high_perf"]
    powers = sorted(e.power_mw for e in ar.entries)
    assert len(powers) > 1
    budget = (powers[0] + powers[1]) / 2.0  # admits exactly the frugalest
    ans = rec.recommend(Query(arch=ARCH, node_nm=IN_NODE,
                              power_budget_mw=budget))
    assert ans.source == "archive"
    assert ans.power_mw == powers[0] and ans.power_mw <= budget


def test_impossible_budget_falls_back_to_surrogate(rec):
    ar = rec.index.cells[f"{ARCH}__{IN_NODE}nm__high_perf"]
    floor = min(e.power_mw for e in ar.entries)
    ans = rec.recommend(Query(arch=ARCH, node_nm=IN_NODE,
                              power_budget_mw=floor * 1e-6))
    assert ans.source == "surrogate"


# ------------------------------------------------------ surrogate path
def test_out_of_grid_node_uses_surrogate(rec):
    ans = rec.recommend(Query(arch=ARCH, node_nm=OUT_NODE))
    assert ans.source == "surrogate"
    assert ans.cell_id in rec.index.cells
    assert np.isfinite([ans.power_mw, ans.perf_gops, ans.area_mm2]).all()
    assert ans.power_mw > 0 and ans.perf_gops > 0 and ans.area_mm2 > 0
    assert ans.tok_s is None and ans.ppa_score is None
    cfgs = [c.entry.cfg for c in rec.index.candidates]
    assert any(np.array_equal(ans.cfg, c) for c in cfgs)


def test_raw_feature_query_uses_surrogate(rec):
    ans = rec.recommend(Query(node_nm=IN_NODE,
                              features={"flops_per_token": 3e8,
                                        "weight_mb": 64.0, "seq_len": 512,
                                        "batch": 1, "d_model": 512}))
    assert ans.source == "surrogate"
    assert np.isfinite([ans.power_mw, ans.perf_gops, ans.area_mm2]).all()


def test_mixed_batch_is_one_fused_dispatch(rec, monkeypatch):
    """Three surrogate fallbacks and one exact hit cost exactly one
    ``score_query_batch`` call (counted by the recommender and by a wrapper
    around the function), at the batch's (Q, C) shape."""
    calls = []
    real = sur_mod.score_query_batch

    def counting(params, q, cand, *rest):
        calls.append((tuple(q.shape), tuple(cand.shape)))
        return real(params, q, cand, *rest)

    monkeypatch.setattr(sur_mod, "score_query_batch", counting)
    before = rec.n_dispatches
    queries = [Query(arch=ARCH, node_nm=IN_NODE),
               Query(arch=ARCH, node_nm=OUT_NODE),
               Query(arch=ARCH, node_nm=OUT_NODE, mode="low_power"),
               Query(node_nm=IN_NODE, features={"weight_mb": 8.0})]
    answers = rec.recommend_batch(queries)
    assert [a.source for a in answers] == [
        "archive", "surrogate", "surrogate", "surrogate"]
    assert rec.n_dispatches - before == 1
    assert calls == [((3, 52), (len(rec.index.candidates), 30))]


def test_all_exact_batch_costs_zero_dispatches(rec, monkeypatch):
    monkeypatch.setattr(sur_mod, "score_query_batch", None)   # never called
    before = rec.n_dispatches
    answers = rec.recommend_batch(
        [Query(arch=ARCH, node_nm=IN_NODE),
         Query(arch=ARCH, node_nm=IN_NODE2)])
    assert all(a.source == "archive" for a in answers)
    assert rec.n_dispatches == before


# ------------------------------------------------------------ index
def test_archive_index_build_and_candidates(campaign_root):
    idx = ArchiveIndex.build([campaign_root])
    assert sorted(idx.cells) == [f"{ARCH}__{IN_NODE}nm__high_perf",
                                 f"{ARCH}__{IN_NODE2}nm__high_perf"]
    total = sum(len(a) for a in idx.cells.values())
    assert 0 < len(idx.candidates) <= total
    x, y = idx.training_set()
    assert x.shape == (total, idx.query_context(
        idx.wl_features(ARCH), IN_NODE, "high_perf").shape[0]
        + idx.cand_matrix().shape[1])
    assert y.shape == (total, 3)
    assert np.isfinite(x).all() and np.isfinite(y).all()


def test_index_requires_campaign(tmp_path):
    with pytest.raises((ValueError, OSError)):
        ArchiveIndex.build([str(tmp_path / "nope")])
    with pytest.raises(ValueError):
        ArchiveIndex.build([])


def test_answer_to_dict_is_json_ready(rec):
    ans = rec.recommend(Query(arch=ARCH, node_nm=OUT_NODE))
    d = json.loads(json.dumps(ans.to_dict()))
    assert d["source"] == "surrogate" and isinstance(d["cfg"], list)


# --------------------------------------------------------- CLI + report
def test_cli_answers_and_writes_index_report(campaign_root, capsys,
                                             tmp_path):
    recommend_main(["--root", campaign_root, "--node", str(IN_NODE),
                    "--arch", ARCH, "--report", "--device", "cpu"])
    out = capsys.readouterr().out
    ans = json.loads(out.strip().splitlines()[-1])
    assert ans["source"] == "archive"
    assert ans["query"] == {"arch": ARCH, "node_nm": IN_NODE,
                            "mode": "high_perf"}
    report = json.load(open(f"{campaign_root}/report/index.json"))
    assert [r["cell_id"] for r in report] == sorted(
        f"{ARCH}__{n}nm__high_perf" for n in (IN_NODE, IN_NODE2))
    assert all(r["frontier"] > 0 and np.isfinite(r["power_mw"])
               for r in report)
    # the reference's report of the same index, byte for byte
    ref_paths = ref_index_report(CampaignStore.open(campaign_root),
                                 RefIndex.build([campaign_root]).cells,
                                 out_dir=str(tmp_path))
    for name in ("index_json", "index_md"):
        with open(ref_paths[name], "rb") as f:
            want = f.read()
        with open(f"{campaign_root}/report/{name.replace('_', '.')}",
                  "rb") as f:
            assert f.read() == want


def test_cli_refuses_a_cuda_request_without_a_card(campaign_root):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recommend_main(["--root", campaign_root, "--node", str(IN_NODE)])


# -------------------------------------------------------- HTTP endpoint
def _serve_once(campaign_root, rec, box, ready):
    from repro_torch.launch.serve import recommend_server
    recommend_server([campaign_root], port=0, recommender=rec, poll=True,
                     on_ready=lambda s: (box.update(port=s.server_port),
                                         ready.set()))


def test_http_server_serves_fused_batch(campaign_root, rec):
    ready, box = threading.Event(), {}
    t = threading.Thread(target=_serve_once,
                         args=(campaign_root, rec, box, ready), daemon=True)
    t.start()
    assert ready.wait(30)
    req = urllib.request.Request(
        f"http://127.0.0.1:{box['port']}/recommend",
        data=json.dumps({"queries": [
            {"arch": ARCH, "node_nm": IN_NODE},
            {"arch": ARCH, "node_nm": OUT_NODE},
        ]}).encode(), headers={"Content-Type": "application/json"})
    r = json.load(urllib.request.urlopen(req, timeout=30))
    t.join(30)
    assert [a["source"] for a in r["answers"]] == ["archive", "surrogate"]
    assert r["dispatches"] == 1
    store = CampaignStore.open(campaign_root)
    ref = store.load_archive(f"{ARCH}__{IN_NODE}nm__high_perf").select(
        *MODE_WEIGHTS["high_perf"])
    assert r["answers"][0]["power_mw"] == ref.power_mw
    assert r["answers"][0]["cfg"] == np.asarray(
        ref.cfg, np.float64).tolist()


def test_http_healthz_and_bad_query(campaign_root, rec):
    ready, box = threading.Event(), {}
    t = threading.Thread(target=_serve_once,
                         args=(campaign_root, rec, box, ready), daemon=True)
    t.start()
    assert ready.wait(30)
    h = json.load(urllib.request.urlopen(
        f"http://127.0.0.1:{box['port']}/healthz", timeout=30))
    t.join(30)
    assert h["status"] == "ok" and h["cells"] == 2 and h["candidates"] > 0


# ------------------------------------------- /metrics and the 400 path
class _StubIndex:
    cells, candidates, seq_len, batch = {}, [], 2048, 3


class _StubRec:
    index = _StubIndex()
    n_dispatches = n_exact = n_surrogate = 0

    def recommend_batch(self, queries):
        raise AssertionError("malformed requests must not reach the "
                             "recommender")


@pytest.fixture()
def srv_port():
    from repro_torch.launch.serve import recommend_server

    obs_metrics.global_registry().clear()
    ready, box = threading.Event(), {}

    def _up(s):
        box["srv"] = s
        ready.set()

    t = threading.Thread(
        target=lambda: recommend_server([], port=0, recommender=_StubRec(),
                                        on_ready=_up),
        daemon=True)
    t.start()
    assert ready.wait(30)
    yield box["srv"].server_port
    box["srv"].shutdown()
    t.join(30)


def _post(port, body: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/recommend", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_malformed_recommend_is_structured_400(srv_port):
    for body in (b"{not json", b"[1, 2]", b'{"queries": 5}',
                 b'{"queries": [7]}', b'{"queries": []}'):
        code, payload = _post(srv_port, body)
        assert code == 400, body
        assert payload["error"]["type"] and payload["error"]["message"]


def test_metrics_endpoint_prometheus_text(srv_port):
    _post(srv_port, b"{not json")        # one bad request on the books
    health = json.load(urllib.request.urlopen(
        f"http://127.0.0.1:{srv_port}/healthz", timeout=30))
    assert health["uptime_s"] >= 0
    assert health["index"]["seq_len"] == 2048
    assert health["index"]["answered_exact"] == 0
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv_port}/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    assert "# TYPE repro_serve_bad_requests_total counter" in text
    assert "repro_serve_bad_requests_total 1" in text
    assert 'repro_serve_requests_total{route="/recommend"} 1' in text
    assert 'repro_serve_requests_total{route="/healthz"} 1' in text
    assert 'repro_serve_request_seconds_bucket{le="+Inf"}' in text


# ----------------------------------------------- against the reference
def test_training_set_and_cand_matrix_bitwise_the_reference(campaign_root):
    ours, ref = ArchiveIndex.build([campaign_root]), RefIndex.build(
        [campaign_root])
    for a, b in zip(ours.training_set(), ref.training_set()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(ours.cand_matrix(), ref.cand_matrix())
    assert [c.cell_id for c in ours.candidates] == [
        c.cell_id for c in ref.candidates]


def test_fit_index_surrogate_from_the_reference_init(campaign_root):
    """Adam steps from the reference's initial parameters (a
    ``jax.random`` init, injected).  One step lands within 1e-6 of the
    reference's.  After 400 the parameters are within atol 1e-2: an Adam
    step moves a weight by about lr = 1.5e-4 whatever the size of its
    gradient, so where a gradient is near 0 float noise flips the step's
    sign, and that compounds over the steps.  The fits' predictions on
    the index stay within 5e-3 and ``resid_var`` within 5e-3 relative;
    the calibration of the port's fit through ``predict`` (the
    ``fused_mlp`` path) matches the reference's ``_calib_errors_log`` on
    the same parameters within rtol 1e-5."""
    x, y = RefIndex.build([campaign_root]).training_set()
    init = np_tree(ref_sur.init_params(jax.random.PRNGKey(0), x.shape[1],
                                       hidden=ref_sur.SERVE_HIDDEN))
    for steps, atol in ((1, 1e-6), (400, 1e-2)):
        ref = ref_sur.fit_index_surrogate(x, y, steps=steps, seed=0)
        ours = sur_mod.fit_index_surrogate(x, y, steps=steps, seed=0,
                                           params=init, **CPU)
        want = np_tree(ref.params)
        for layer in ("l1", "l2", "head"):
            for k in ("w", "b"):
                np.testing.assert_allclose(ours.params[layer][k].numpy(),
                                           want[layer][k], rtol=0,
                                           atol=atol)
        assert ours.n_updates == ref.n_updates == steps
    np.testing.assert_allclose(
        sur_mod.predict(ours.params, torch.as_tensor(x)).numpy(),
        np.asarray(ref_sur.predict(ref.params, x)), rtol=0, atol=5e-3)
    assert ours.resid_var == pytest.approx(ref.resid_var, rel=5e-3)
    errs = sur_mod._calib_errors_log(ours.params, torch.as_tensor(x),
                                     torch.as_tensor(y)).numpy()
    want_errs = np.asarray(ref_sur._calib_errors_log(
        jax.tree_util.tree_map(jnp.asarray, {
            k: {kk: v.numpy() for kk, v in d.items()}
            for k, d in ours.params.items()}), x, y))
    np.testing.assert_allclose(errs, want_errs, rtol=1e-5, atol=1e-7)


def test_fit_index_surrogate_is_bitwise_repeatable(campaign_root):
    x, y = ArchiveIndex.build([campaign_root]).training_set()
    a = sur_mod.fit_index_surrogate(x, y, steps=60, seed=3, minibatch=8,
                                    **CPU)
    b = sur_mod.fit_index_surrogate(x, y, steps=60, seed=3, minibatch=8,
                                    **CPU)
    for layer in ("l1", "l2", "head"):
        for k in ("w", "b"):
            assert torch.equal(a.params[layer][k], b.params[layer][k])
    assert a.resid_var == b.resid_var


def test_score_query_batch_matches_the_reference(campaign_root):
    """On the same parameters and queries: the same picks and budget flags,
    predictions within rtol 1e-5.  Budgets are set between the candidates'
    predicted powers so that masking and the unmasked fallback both
    happen."""
    ref_rec = RefRecommender.build([campaign_root], fit_steps=120)
    params = convert.surrogate_params(np_tree(ref_rec.surrogate.params))
    rng = np.random.default_rng(0)
    q = rng.normal(1.0, 1.0, size=(64, 52)).clip(0).astype(np.float32)
    cand = ref_rec.index.cand_matrix()
    w = rng.random((64, 3)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    budget = np.where(rng.random(64) < 0.3, np.inf,
                      10 ** rng.uniform(-1, 4, 64)).astype(np.float32)
    perf = np.where(rng.random(64) < 0.5, 0.0,
                    10 ** rng.uniform(-1, 3, 64)).astype(np.float32)
    want = [np.asarray(v) for v in ref_sur.score_query_batch(
        ref_rec.surrogate.params, q, jnp.asarray(cand), w, budget, perf)]
    T = torch.as_tensor
    got = [v.numpy() for v in sur_mod.score_query_batch(
        params, T(q), T(cand), T(w), T(budget), T(perf))]
    assert want[2].any() and not want[2].all()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    # atol for predictions near 0 (expm1 of a log1p value near 0), where
    # the float32 products' absolute error of ~1e-7 dominates
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


def test_answers_match_the_reference_recommender(campaign_root):
    """Exact answers bitwise the reference's; surrogate answers, with the
    reference's fitted parameters given to the port, the same candidate
    and predictions within rtol 1e-5."""
    ref_rec = RefRecommender.build([campaign_root], fit_steps=120)
    ours = Recommender.build([campaign_root], fit_steps=0, params=np_tree(
        ref_rec.surrogate.params), **CPU)
    specs = [dict(arch=ARCH, node_nm=n, mode=m)
             for n in (3, 5, 7, 10, 14, 22, 28)
             for m in ("high_perf", "low_power")]
    specs += [dict(arch=ARCH, node_nm=IN_NODE, power_budget_mw=1e-3),
              dict(arch=ARCH, node_nm=IN_NODE2, min_perf_gops=1e9),
              dict(features={"weight_mb": 8.0, "seq_len": 512},
                   node_nm=IN_NODE)]
    got = ours.recommend_batch([Query(**d) for d in specs])
    want = ref_rec.recommend_batch([RefQuery(**d) for d in specs])
    assert ours.n_dispatches == ref_rec.n_dispatches == 1
    for g, w in zip(got, want):
        assert (g.source, g.cell_id, g.within_budget) == (
            w.source, w.cell_id, w.within_budget)
        assert np.array_equal(g.cfg, w.cfg)
        if w.source == "archive":
            assert (g.power_mw, g.perf_gops, g.area_mm2, g.tok_s,
                    g.ppa_score) == (w.power_mw, w.perf_gops, w.area_mm2,
                                     w.tok_s, w.ppa_score)
        else:
            np.testing.assert_allclose(
                [g.power_mw, g.perf_gops, g.area_mm2],
                [w.power_mw, w.perf_gops, w.area_mm2], rtol=1e-5)
    assert sum(a.source == "archive" for a in got) == 2
