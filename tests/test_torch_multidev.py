"""The ported devices slice on the CPU (mirrors ``tests/test_multidev.py``
without its Pallas interpret test): ``batch_mesh`` and ``shard_keys``, the
env's error for a batch that the device count does not divide, and the
chunked env step, search, campaign and CLI bitwise the ``devices=None``
run for 1, 2 and 4 devices (on the CPU, n chunks on the one device stand
in for n devices, as the reference's tests emulate host devices).  The
card tests (``tests/test_torch_cuda.py``) hold ``devices=1`` on the H100."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.campaign import CampaignSpec, fingerprint, run_campaign
from repro_torch.configs import get_config
from repro_torch.core import actions as act
from repro_torch.core.env import VecDSEEnv
from repro_torch.core.search import SearchConfig, run_search_cells
from repro_torch.distributed.sharding import (batch_mesh, shard_call,
                                              shard_keys)
from repro_torch.launch import dse
from repro_torch.workload.extract import extract


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def wl():
    return extract(get_config("smollm-135m"), seq_len=2048, batch=3)


# ----------------------------------------------------------------- mesh --
def test_batch_mesh_degenerate_and_oversubscribed(monkeypatch):
    assert batch_mesh(1, device="cpu") == [torch.device("cpu")]
    assert batch_mesh(None, device="cpu") == [torch.device("cpu")]
    assert batch_mesh(4, device="cpu") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError):
        batch_mesh(0, device="cpu")
    # CUDA: the first n cards, and no more than the visible ones
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert batch_mesh(2) == [torch.device("cuda", 0),
                             torch.device("cuda", 1)]
    assert batch_mesh(None) == batch_mesh(2)
    with pytest.raises(ValueError, match="visible"):
        batch_mesh(3)


def test_shard_keys_independent_and_deterministic():
    ks = shard_keys(123, 8)
    assert ks.shape == (8,) and ks.dtype == np.uint64
    assert len(set(ks.tolist())) == 8
    np.testing.assert_array_equal(ks, shard_keys(123, 8))
    np.testing.assert_array_equal(ks, shard_keys(123, 16)[:8])
    assert set(ks.tolist()).isdisjoint(shard_keys(124, 8).tolist())
    draws = [torch.randn(4, generator=torch.Generator().manual_seed(int(k)))
             for k in ks]
    assert len({tuple(d.tolist()) for d in draws}) == 8
    with pytest.raises(ValueError):
        shard_keys(0, 0)


def test_shard_call_gathers_in_batch_order():
    x = torch.arange(12.0).reshape(6, 2)
    w = torch.tensor([10.0, 20.0])
    fn = lambda a, b: (a * b, {"s": a.sum(dim=1)})
    got = shard_call(fn, batch_mesh(3, device="cpu"), (x, w),
                     replicated=(1,))
    want = fn(x, w)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1]["s"], want[1]["s"])


def test_env_rejects_indivisible_batch(wl):
    with pytest.raises(ValueError, match="divide evenly"):
        VecDSEEnv(wl, 7, batch=15, seed=0, devices=4, device="cpu")
    with pytest.raises(ValueError):
        VecDSEEnv(wl, 7, batch=16, seed=0, devices=0, device="cpu")


# ------------------------------------------------------- env step parity --
def _rollout(wl, devices, mode="analytic", batch=16, steps=5):
    env = VecDSEEnv(wl, [3, 7, 14, 28] * (batch // 4), batch=batch, seed=0,
                    devices=devices, partition_mode=mode, device="cpu")
    obs = [env.reset()]
    rng = np.random.default_rng(0)
    rs, mets, cfgs = [], [], []
    for _ in range(steps):
        a_c, a_d = act.random_action_batch(rng, batch)
        o, r, info = env.step(a_c, a_d)
        obs.append(o)
        rs.append(r)
        mets.append(info.metrics)
        cfgs.append(info.cfg)
    return np.stack(obs), np.stack(rs), np.stack(mets), np.stack(cfgs)


@pytest.mark.parametrize("mode", ["analytic", "exact"])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_env_step_bitwise_vs_single_device(wl, n_dev, mode):
    base = _rollout(wl, None, mode)
    shard = _rollout(wl, n_dev, mode)
    for name, a, b in zip(("obs", "reward", "metrics", "cfg"), base, shard):
        np.testing.assert_array_equal(a, b, err_msg=name)


# --------------------------------------------------- search loop parity --
def _search(wl, devices):
    sc = SearchConfig(episodes=64, warmup=24, batch_size=32, seed=0,
                      gate_threshold=1e9, screen_k=3)
    return run_search_cells(wl, [7, 7], search=sc, lanes_per_cell=4,
                            devices=devices, device="cpu")


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_search_cells_bitwise_vs_single_device(wl, n_dev):
    base = _search(wl, None)
    shard = _search(wl, n_dev)
    assert len(base) == len(shard)
    assert base[0].gate_open_episode is not None   # screening ran too
    for rb, rs in zip(base, shard):
        assert rb.episodes_run == rs.episodes_run
        assert rb.feasible_count == rs.feasible_count
        assert rb.unique_configs == rs.unique_configs
        assert (rb.screened, rb.evaluated) == (rs.screened, rs.evaluated)
        assert rb.best_score == rs.best_score
        if rb.best_cfg is None:
            assert rs.best_cfg is None
        else:
            np.testing.assert_array_equal(rb.best_cfg, rs.best_cfg)
        assert [t.__dict__ for t in rb.trace] == [t.__dict__
                                                  for t in rs.trace]
        fb, fs = rb.archive.frontier(), rs.archive.frontier()
        assert sorted(fb) == sorted(fs)
        for k in fb:
            np.testing.assert_array_equal(fb[k], fs[k])


# ------------------------------------------------ campaign + CLI parity --
def test_campaign_devices_fingerprint_as_none(tmp_path):
    """``CampaignSpec.devices`` is an execution layout: a campaign chunked
    over 2 devices fingerprints as the plain one (checkpointed and
    resumed batches included: spec devices only reach the env step)."""
    d = dict(name="d", workloads=["smollm-135m"], nodes=[3, 7],
             modes=["high_perf"], episodes=32, lanes=4, max_envs=8, seed=0,
             seq_len=256, batch=1, checkpoint_every=2)
    plain = run_campaign(str(tmp_path / "plain"), CampaignSpec(**d),
                         progress=lambda m: None, device="cpu")
    two = run_campaign(str(tmp_path / "two"), CampaignSpec(**d, devices=2),
                       progress=lambda m: None, device="cpu")
    assert two.spec.devices == 2
    assert fingerprint(two) == fingerprint(plain)


def test_cli_devices_single_search_and_errors(tmp_path, capsys,
                                             monkeypatch):
    """``--devices 2`` / ``--mesh 2`` on the CPU run the chunked engine and
    write the plain run's rows; ``--devices`` beyond the visible cards,
    an indivisible ``--n-envs`` and malformed values are one-line errors."""
    rows = {}
    for tag, extra in (("plain", []), ("dev", ["--devices", "2"]),
                       ("mesh", ["--mesh", "2"])):
        out = str(tmp_path / tag)
        dse.main(["--arch", "smollm-135m", "--nodes", "7", "--episodes",
                  "64", "--n-envs", "8", "--device", "cpu", "--out", out]
                 + extra)
        r = json.load(open(os.path.join(out, "smollm-135m__sac_summary.json")))
        rows[tag] = [{k: v for k, v in row.items() if k != "wall_s"}
                     for row in r]
    assert rows["dev"] == rows["plain"] == rows["mesh"]

    def err_of(argv):
        with pytest.raises(SystemExit) as exc:
            dse.main(argv)
        assert exc.value.code == 2
        return capsys.readouterr().err

    capsys.readouterr()
    # one card: --devices 2 is refused before any work
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    err = err_of(["--devices", "2", "--device", "cuda"])
    assert "--devices 2:" in err and "only 1 visible" in err
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert "only 0 visible" in err_of(["--mesh", "auto", "--device",
                                       "cuda"])
    assert "must divide evenly" in err_of(["--devices", "3", "--n-envs",
                                           "8", "--device", "cpu"])
    assert "aliases" in err_of(["--devices", "2", "--mesh", "2",
                                "--device", "cpu"])
    assert "--mesh must be 'auto'" in err_of(["--mesh", "x", "--device",
                                              "cpu"])
    assert "--devices must be >= 1" in err_of(["--devices", "0",
                                               "--device", "cpu"])
    assert "--engine vec or --campaign" in err_of(
        ["--devices", "1", "--engine", "scalar", "--device", "cpu"])
