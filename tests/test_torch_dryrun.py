"""The port's dry-run pieces (``repro_torch.launch.hlo_analysis``,
``shapes``, ``steps``, ``dryrun``) on fake process groups, against the
JAX reference where it has a counterpart: the collective accounting's
case of ``test_hlo_collective_analysis_scan_correction`` (12 all-reduces
of f32[8] over a group of 4: count 12, 576 wire bytes, exact), the input
stand-ins' shapes and dtypes for every arch and shape (exact), and
``cell_supported``; then mini dry-runs of reduced configs on a fake 2x2
group at the reference mini test's (4, 16) batch, whose record is OK,
whose argument bytes a device equal the local shards' bytes the rules
give (exact); and at 1,024 tokens a row an extrapolation from 2 and 3
periods equal to the whole trace's memory and flops (exact).  Fake tensors on the CPU: a torch
built without CUDA cannot run every operator on fake CUDA tensors."""
import dataclasses
import math

import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_config
from repro.launch import shapes as ref_shapes
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ARCH_IDS
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, hlo_analysis, shapes, steps

MINI = {"train_mini": dict(seq_len=16, global_batch=4, kind="train"),
        "train_1k": dict(seq_len=1024, global_batch=8, kind="train"),
        "decode_mini": dict(seq_len=64, global_batch=4, kind="decode")}
_DT = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
       jnp.float16: torch.float16, jnp.float32: torch.float32}


@pytest.fixture(autouse=True, scope="module")
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_all_reduces_in_a_loop_count_and_bytes():
    import torch.distributed._functional_collectives as funcol
    dryrun.init_fake_group(4)
    with hlo_analysis.record_collectives() as rec:
        for _ in range(12):
            funcol.wait_tensor(funcol.all_reduce(torch.ones(8), "sum",
                                                 dist.group.WORLD))
    stats = hlo_analysis.analyze_collectives(rec.events, n_devices=4)
    assert stats.per_kind_count == {"all-reduce": 12}
    assert stats.per_kind_bytes["all-reduce"] == 2 * (3 / 4) * 32 * 12 == 576
    assert stats.total_wire_bytes == 576
    assert stats.summary()["n_while_loops"] == 0


@pytest.mark.parametrize("kind,n,nbytes,wire", [
    ("all-gather", 4, 64, 48.0), ("reduce-scatter", 4, 64, 48.0),
    ("all-to-all", 2, 64, 32.0), ("collective-permute", 8, 64, 64.0),
    ("all-reduce", 1, 64, 0.0)])
def test_ring_factors(kind, n, nbytes, wire):
    ev = hlo_analysis.Collective(kind, nbytes, n)
    assert hlo_analysis.analyze_collectives([ev]).total_wire_bytes == wire


@pytest.mark.parametrize("shape", list(shapes.SHAPES))
def test_input_specs_match_reference(shape):
    assert shapes.SHAPES == ref_shapes.SHAPES
    for arch in ARCH_IDS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        assert shapes.cell_supported(cfg, shape) == \
            ref_shapes.cell_supported(rcfg, shape)
        got = shapes.input_specs(cfg, shape)
        want = ref_shapes.input_specs(rcfg, shape)
        assert set(got) == set(want), arch
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), (arch, k)
            assert got[k].dtype == _DT[v.dtype.type], (arch, k)
            assert got[k].is_meta


def _local_bytes(tree_shapes, place_tree, mesh):
    """Bytes of rank 0's chunk of each leaf, from the placements."""
    total = 0
    for (name, t), (_, place) in zip(sh.leaf_paths(tree_shapes),
                                     _placement_leaves(place_tree)):
        shape = list(t.shape)
        for i, p in enumerate(place):
            if p.is_shard():
                shape[p.dim] = -(-shape[p.dim] // mesh.size(i))
        total += math.prod(shape) * t.element_size()
    return total


def _placement_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _placement_leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.fixture
def mini(monkeypatch):
    monkeypatch.setattr(shapes, "SHAPES", dict(shapes.SHAPES, **MINI))


def test_mini_dryrun_smollm_ok_and_argument_bytes(mini, tmp_path):
    cfg = get_reduced("smollm-135m")
    rec = dryrun.run_cell("smollm-135m", "train_mini", False, str(tmp_path),
                          device="cpu", cfg=cfg, mesh_shape=(2, 2))
    assert rec["status"] == "OK", rec.get("traceback")
    assert (tmp_path / "smollm-135m__train_mini__test2x2.json").exists()
    assert rec["n_devices"] == 4
    mesh = dryrun.make_test_mesh(2, 2, device="cpu")
    params = steps.abstract_params(cfg)
    p_bytes = _local_bytes(params, sh.param_shardings(params, mesh), mesh)
    moments = 2 * _local_bytes(
        {k: v.float() for k, v in sh.leaf_paths(params)},
        dict(sh.leaf_paths(sh.param_shardings(params, mesh))), mesh)
    batch = 2 * (4 // 2) * 16 * 4                     # tokens, labels
    scalars = 2 * 4                                   # step, Adam's t
    assert rec["memory"]["argument_bytes"] == p_bytes + moments + batch \
        + scalars
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["collectives"]["per_kind_count"]
    assert rec["analytic"]["tokens"] == 64
    assert not {"lower_s", "compile_s", "hlo_chars"} & set(rec)


def test_mini_dryrun_decode_ok(mini, tmp_path):
    rec = dryrun.run_cell("mixtral-8x7b", "decode_mini", False,
                          str(tmp_path), device="cpu",
                          cfg=get_reduced("mixtral-8x7b"), mesh_shape=(2, 2))
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["memory"]["output_bytes"] > 0


def test_extrapolated_depth_equals_whole_trace(mini, tmp_path):
    """At a training shape of 1,024 tokens a row (where the saved
    activations hold the peak at every depth; at 16 tokens another phase
    holds it and the peak is not linear in depth) memory and flops carried
    from 2 and 3 periods to 5 equal the whole 5-layer trace's; the
    collective counts too."""
    cfg = dataclasses.replace(get_reduced("smollm-135m"), n_layers=5)
    whole = dryrun.run_cell("smollm-135m", "train_1k", False,
                            str(tmp_path / "w"), device="cpu", cfg=cfg,
                            mesh_shape=(2, 2))
    ext = dryrun.run_cell("smollm-135m", "train_1k", False,
                          str(tmp_path / "e"), device="cpu", cfg=cfg,
                          mesh_shape=(2, 2), extrapolate=True)
    assert ext["extrapolated_from_periods"] == [2, 3]
    assert ext["memory"] == whole["memory"]
    assert ext["cost"] == whole["cost"]
    assert ext["collectives"]["per_kind_count"] == \
        whole["collectives"]["per_kind_count"]


def test_cli_writes_ok_records_for_reduced_cells(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on the fake 256-rank pod:
    reduced SmolLM's decode_32k and long_500k cells (a record each: OK,
    and the reference's SKIP for a full-attention arch at 500k)."""
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                     "--mesh", "pod", "--reduced", "--device", "cpu",
                     "--out", str(tmp_path)])
    assert ex.value.code == 0
    import json
    with open(tmp_path / "smollm-135m__decode_32k__pod16x16.json") as f:
        rec = json.load(f)
    assert rec["status"] == "OK" and rec["n_devices"] == 256
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k",
                     "--mesh", "pod", "--reduced", "--device", "cpu",
                     "--out", str(tmp_path)])
    with open(tmp_path / "smollm-135m__long_500k__pod16x16.json") as f:
        assert json.load(f)["status"] == "SKIP"


def test_skip_record(tmp_path):
    rec = dryrun.run_cell("llama3.1-8b", "long_500k", False, str(tmp_path),
                          device="cpu")
    assert rec["status"] == "SKIP" and rec["reason"].startswith("SKIP")


@pytest.mark.slow
def test_mini_dryrun_jamba(mini, tmp_path):
    rec = dryrun.run_cell("jamba-v0.1-52b", "train_mini", False,
                          str(tmp_path), device="cpu",
                          cfg=get_reduced("jamba-v0.1-52b"),
                          mesh_shape=(2, 2))
    assert rec["status"] == "OK", rec.get("traceback")
