"""The port's device-resident PER (on the CPU) against the reference's host
``PERBuffer``, its vectorised tree descent against ``SumTree.sample``, and
checkpoints across the two packages: the port's checkpoint manager writes
the reference's layout and leaf names, each package reads the other's
checkpoints, and a reference search checkpoint's PER state carries into
the port."""
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.core import replay as ref_replay
from repro.core import search as ref_search
from repro.workload.extract import extract as ref_extract
from repro_torch import convert
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config
from repro_torch.core import replay
from repro_torch.core import search
from repro_torch.kernels import sumtree_sample
from repro_torch.workload.extract import extract

S, C, D = 52, 30, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny searches spend their time in per-op overhead; one intra-op
    thread keeps them from contending with the other test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _transitions(rng, n):
    return (rng.normal(size=(n, S)).astype(np.float32),
            rng.uniform(-1, 1, (n, C)).astype(np.float32),
            rng.integers(0, 5, (n, D)).astype(np.int32),
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=(n, S)).astype(np.float32),
            np.zeros(n, np.float32))


@pytest.mark.parametrize("capacity,n_add,batch", [
    (replay.CAPACITY, 448, 256),   # the campaign's insert and refresh sizes
    (1000, 300, 64),               # wraps around a non-power-of-two ring
])
def test_device_per_matches_reference_buffer(capacity, n_add, batch):
    """Same seed, same add_batch / update_priorities calls over several
    rounds: identical sampled indices, trees, transitions, scalars and
    importance weights (both compute (N * p)^-beta in float64 and cast to
    float32; on the CPU torch's pow gives numpy's bits)."""
    rng = np.random.default_rng(7)
    ref = ref_replay.PERBuffer(S, C, D, capacity=capacity, seed=3)
    port = replay.PERBuffer(S, C, D, capacity=capacity, seed=3,
                            device="cpu")
    for _ in range(5):
        tr = _transitions(rng, n_add)
        ref.add_batch(*tr)
        port.add_batch(*tr)
        for _ in range(4):
            out_r, idx_r = ref.sample(batch)
            out_p, idx_p = port.sample(batch)
            np.testing.assert_array_equal(idx_p.numpy(), idx_r)
            for k in ("s", "a_cont", "a_disc", "r", "s2", "done"):
                np.testing.assert_array_equal(out_p[k].numpy(), out_r[k])
            np.testing.assert_array_equal(out_p["is_w"].numpy(),
                                          out_r["is_w"])
            td = np.abs(rng.normal(size=batch)).astype(np.float32) * 3
            ref.update_priorities(idx_r, td)
            port.update_priorities(idx_p, torch.as_tensor(td))
        np.testing.assert_array_equal(port.tree.numpy(), ref.tree.tree)
        assert (port.pos, port.size, port.max_priority, port.beta) == (
            ref.pos, ref.size, ref.max_priority, ref.beta)
        recent_r, recent_p = ref.recent(64), port.recent(64)
        for k in recent_r:
            np.testing.assert_array_equal(recent_p[k].numpy(), recent_r[k])


@pytest.mark.parametrize("cap", [1, 8, 100, 257, 100_000])
def test_descent_matches_host_sample(cap):
    """The vectorised descent picks the host ``SumTree.sample`` leaf for
    every uniform, including both leaf levels of a non-power-of-two tree
    and prefix sums that land exactly on a boundary."""
    rng = np.random.default_rng(cap)
    st = ref_replay.SumTree(cap)
    st.set_many(np.arange(cap), rng.integers(0, 4, cap).astype(np.float64))
    total = st.total()
    u = np.concatenate([rng.random(500) * total,
                        np.cumsum(st.tree[cap:])[:50], [0.0, total]])
    got = sumtree_sample.descend(torch.as_tensor(st.tree),
                                 torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(),
                                  [st.sample(float(x)) for x in u])
    # the sampler's stratified prefix sums and clamp, as the reference's
    # PERBuffer.sample forms them
    for n, size in ((1, cap), (64, max(1, cap // 2))):
        uni = rng.random(n)
        want = np.minimum([st.sample(float(x)) for x in
                           (np.arange(n) + uni) * (total / n)], size - 1)
        got = sumtree_sample.sumtree_sample(torch.as_tensor(st.tree),
                                            torch.as_tensor(uni), size)
        np.testing.assert_array_equal(got.numpy(), want)


def test_checkpoints_cross_the_packages(tmp_path):
    """A tree saved by each package reads back through the other's
    ``restore_flat`` with the same names, dtypes and arrays (NamedTuple
    fields as ``.name``, dict keys sorted, float64 kept)."""
    from repro_torch.core import sac
    state = sac.create(0, "cpu")
    tree = dict(sac=state, host=dict(per_tree=np.arange(6, dtype=np.float64),
                                     n=np.int64(3)))
    ckpt.save(tree, str(tmp_path / "port"), 5, extra=dict(x=float("inf")))
    flat_r, man_r = ref_ckpt.restore_flat(str(tmp_path / "port"))
    flat_p, man_p = ckpt.restore_flat(str(tmp_path / "port"))
    assert man_r == man_p and man_p["step"] == 5
    assert man_p["extra"] == {"x": "inf"}
    assert list(flat_p) == ckpt.leaf_names(tree)
    assert "sac/.params/.actor/l1/w" in flat_p
    for k in flat_p:
        assert flat_r[k].dtype == flat_p[k].dtype
        np.testing.assert_array_equal(flat_r[k], flat_p[k])
    back = ckpt.unflatten_from(flat_p, "sac", state)
    assert torch.equal(back.params.actor["l1"]["w"],
                       state.params.actor["l1"]["w"])
    assert back.step.dtype == torch.int32
    ref_ckpt.save(dict(a=np.ones(3, np.float32),
                       b=dict(c=np.zeros(2, np.float64))),
                  str(tmp_path / "ref"), 2, keep=1)
    flat, man = ckpt.restore_flat(str(tmp_path / "ref"))
    assert man["names"] == ["a", "b/c"] and flat["b/c"].dtype == np.float64
    assert ckpt.latest_step(str(tmp_path / "ref")) == 2
    assert ckpt.all_steps(str(tmp_path / "port")) == [5]
    assert ckpt.manifest_of(str(tmp_path / "ref"))["step"] == 2


def test_search_checkpoints_share_leaf_names_and_per_state(tmp_path):
    """A tiny search checkpointed by each package: the same leaf names,
    shapes and dtypes apart from the generator states (the reference's
    ``device/key``s, the port's ``device/gen``s), and the reference
    checkpoint's PER state carried into the port samples the reference's
    indices."""
    kw = dict(episodes=48, seed=0, batch_size=16, warmup=16, wm_batch=16)
    ref_search.run_search_cells(
        ref_extract(ref_get_config("smolvlm"), seq_len=256, batch=1),
        [3, 7], search=ref_search.SearchConfig(**kw), lanes_per_cell=4,
        checkpoint_dir=str(tmp_path / "ref"), checkpoint_every=4)
    search.run_search_cells(
        extract(get_config("smolvlm"), seq_len=256, batch=1), [3, 7],
        search=search.SearchConfig(**kw), lanes_per_cell=4,
        checkpoint_dir=str(tmp_path / "port"), checkpoint_every=4,
        device="cpu")
    fr, mr = ref_ckpt.restore_flat(str(tmp_path / "ref"))
    fp, mp = ckpt.restore_flat(str(tmp_path / "port"))
    assert set(fr) - set(fp) == {"device/key", "device/screen_key"}
    assert set(fp) - set(fr) == {"device/gen", "device/screen_gen"}
    for k in set(fr) & set(fp):
        assert (fr[k].shape, fr[k].dtype) == (fp[k].shape, fp[k].dtype), k
    assert fp["host/per_tree"].dtype == np.float64
    assert set(mr["extra"]) <= set(mp["extra"])
    # the reference's PER, carried into the port, samples as the reference
    ref_buf = ref_replay.PERBuffer(S, C, D, seed=0)
    for name in ("s", "a_cont", "a_disc", "r", "s2", "done"):
        getattr(ref_buf, name)[...] = fr[f"host/per_{name}"]
    ref_buf.tree.tree[...] = fr["host/per_tree"]
    ex = mr["extra"]
    ref_buf.pos, ref_buf.size = ex["buf_pos"], ex["buf_size"]
    ref_buf.max_priority, ref_buf.beta = ex["buf_max_priority"], ex["buf_beta"]
    ref_buf.rng.bit_generator.state = ex["buf_rng"]
    port_buf = convert.per_buffer_from_flat(fr, ex, device="cpu")
    _, idx_r = ref_buf.sample(32)
    _, idx_p = port_buf.sample(32)
    np.testing.assert_array_equal(idx_p.numpy(), idx_r)
    assert os.path.isdir(str(tmp_path / "port"))
