"""The ported search as a whole, on the CPU at a small size: the reference
re-evaluates every design the port archived and chose; same-seed runs are
bitwise identical; a gate that never opens is bitwise the ungated engine;
the CLI writes the reference's four artifacts."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from repro.ppa import analytic as ref_an
from repro.ppa import config_space as ref_cs
from repro_torch.configs import get_config
from repro_torch.core.search import SearchConfig, run_search
from repro_torch.kernels import ops
from repro_torch.launch import dse
from repro_torch.ppa import analytic as an
from repro_torch.ppa.nodes import node_params
from repro_torch.workload.extract import extract

N_ENVS = 16


def _search(arch="llama3.1-8b", **kw):
    """30 dispatches of 16 envs on node 3, learning from the 2nd dispatch on
    at a small batch, so every stage of Algorithm 1 runs.  (Seed 3 is one
    whose short Llama run reaches feasible designs: at this budget most
    Llama runs find none.)"""
    wl = extract(get_config(arch), seq_len=2048, batch=3)
    sc = SearchConfig(**{**dict(episodes=30 * N_ENVS, seed=3, batch_size=32,
                                warmup=32, wm_batch=64,
                                updates_per_dispatch=2), **kw})
    return wl, run_search(wl, 3, search=sc, n_envs=N_ENVS, device="cpu")


def _fingerprint(res):
    return dict(
        best_cfg=None if res.best_cfg is None else res.best_cfg.tolist(),
        best_metrics=(None if res.best_metrics is None
                      else res.best_metrics.tolist()),
        archive=[e.to_dict() for e in res.archive.entries],
        trace=[t.__dict__ for t in res.trace],
        counts=(res.episodes_run, res.feasible_count, res.unique_configs))


@pytest.mark.parametrize("arch", ["llama3.1-8b", "smolvlm"])
def test_reference_reevaluates_the_ports_designs(arch):
    wl, res = _search(arch, gate_threshold=1e9)
    assert res.episodes_run == 30 * N_ENVS
    assert res.gate_open_episode is not None and res.screened > res.evaluated
    assert len(res.archive) > 0 and res.best_cfg is not None
    node = an.node_vector(node_params(3), high_perf=True)
    cfgs = np.stack([e.cfg for e in res.archive.entries] + [res.best_cfg])
    want = np.asarray(ref_an.evaluate_batch(
        ref_cs.project(jnp.asarray(cfgs)), jnp.asarray(wl.features),
        jnp.asarray(node)))
    stored = np.array([[e.power_mw, e.perf_gops, e.area_mm2, e.tok_s,
                        e.ppa_score] for e in res.archive.entries])
    cols = [an.M_IDX[n] for n in ("power_mw", "perf_gops", "area_mm2",
                                  "tok_s", "ppa_score")]
    np.testing.assert_allclose(stored, want[:-1, cols], rtol=1e-5)
    assert (want[:-1, an.M_IDX["feasible"]] == 1.0).all()
    keep = np.arange(an.M_DIM) != an.M_IDX["mem_overuse_mb"]
    np.testing.assert_allclose(res.best_metrics[keep], want[-1, keep],
                               rtol=1e-5, atol=1e-6)
    assert res.hetero is not None and res.hetero.mesh_w == int(
        round(res.best_cfg[0]))


def test_same_seed_runs_are_bitwise_identical():
    _, a = _search(gate_threshold=1e9)
    _, b = _search(gate_threshold=1e9)
    assert json.dumps(_fingerprint(a)) == json.dumps(_fingerprint(b))
    _, c = _search(seed=2, gate_threshold=1e9)
    assert json.dumps(_fingerprint(c)) != json.dumps(_fingerprint(a))


def test_closed_gate_is_bitwise_the_ungated_engine():
    _, closed = _search(gate_threshold=0.0)     # never opens
    _, ungated = _search(surrogate_gate=False)
    assert closed.gate_open_episode is None
    assert closed.screened == closed.evaluated == ungated.evaluated
    assert json.dumps(_fingerprint(closed)) == json.dumps(
        _fingerprint(ungated))


def test_cpu_run_launches_no_kernel():
    ops.reset_launch_counts()
    _search(episodes=4 * N_ENVS, gate_threshold=1e9)
    assert ops.launch_counts() == {"actor_moe": 0, "screen_score": 0}


def test_cli_writes_the_four_artifacts(tmp_path, capsys):
    out = str(tmp_path / "dse")
    dse.main(["--arch", "smolvlm", "--nodes", "3", "--episodes", "480",
              "--n-envs", "16", "--engine", "vec", "--device", "cpu",
              "--out", out])
    tag = "smolvlm__3nm__sac"
    names = sorted(os.listdir(out))
    assert names == sorted([tag + "_tcc.json", tag + "_trace.json",
                            tag + "_pareto.json", "smolvlm__sac_summary.json"])
    rows = json.load(open(os.path.join(out, "smolvlm__sac_summary.json")))
    assert rows[0]["node_nm"] == 3 and rows[0]["mesh"] != "-"
    assert np.isfinite(rows[0]["ppa_score"])
    assert "[dse] smolvlm 3nm [sac]" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dse.main(["--method", "random", "--device", "cpu"])


@pytest.mark.parametrize("flags", [["--update-every", "4"], ["--devices", "2"],
                                   ["--engine", "scalar"]])
def test_cli_rejects_what_is_not_ported(flags, capsys):
    """Flags the vec engine does not read are refused, not ignored."""
    with pytest.raises(SystemExit) as exc:
        dse.main(flags + ["--device", "cpu"])
    assert exc.value.code == 2
    assert flags[0] in capsys.readouterr().err
