"""The port's LM sharding rules against the JAX reference's: ``param_spec``
for every parameter leaf of all twelve full configs (the reference's
``jax.eval_shape`` tree against the port's parameters made on the meta
device, leaf names and shapes equal), and ``cache_spec`` for every cache
leaf of ``init_caches``, each equal to the reference's ``PartitionSpec``
on duck-typed meshes 1x1, 2x2, 16x16 and 2x16x16, for training and
serving (the rules read only the axis sizes, so no devices are needed);
``placements`` of plain and compound axes on a ``DeviceMesh`` of a fake
process group; and ``_fit``'s divisibility guard.  Exact equality
throughout."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_config
from repro.distributed import sharding as ref_sh
from repro.models import lm as ref_lm
from repro_torch.configs import get_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.distributed import sharding as sh
from repro_torch.launch import steps

MESHES = {"1x1": {"data": 1, "model": 1}, "2x2": {"data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _mesh(name):
    shape = MESHES[name]
    return SimpleNamespace(shape=dict(shape), mesh_dim_names=tuple(shape),
                           axis_names=tuple(shape))


def _ref_leaves(tree):
    return [("/".join(str(getattr(k, "key", k)) for k in kp), leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _norm(spec, ndim: int):
    """A spec (a PartitionSpec or the port's tuple) with one entry a
    dimension, a one-axis tuple as its axis name (``P(("data",))`` and
    ``P("data")`` shard alike)."""
    out = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    one = lambda a: a[0] if len(a) == 1 else tuple(a)
    return tuple(one(a) if isinstance(a, (list, tuple)) else a for a in out)


def _want(spec: P, ndim: int):
    return _norm(spec, ndim)


def _fsdp(arch, mesh):
    return ("pod", "data") if "pod" in mesh.shape \
        and steps._params_bytes(get_config(arch)) >= 40e9 else "data"


@pytest.fixture(scope="module")
def trees():
    """(reference param leaves, port param leaves) a config, both
    shape-only (``eval_shape``; meta)."""
    out = {}
    for arch in ARCH_IDS:
        rcfg = ref_config(arch)
        ref = jax.eval_shape(lambda k: ref_lm.init_params(k, rcfg),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
        out[arch] = (_ref_leaves(ref),
                     sh.leaf_paths(steps.abstract_params(get_config(arch))))
    return out


@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_equal_reference_every_leaf(trees, mesh_name, serve):
    mesh = _mesh(mesh_name)
    n = 0
    for arch, (ref, port) in trees.items():
        assert sorted(p for p, _ in port) == sorted(p for p, _ in ref), arch
        shapes = dict(ref)
        fsdp = _fsdp(arch, mesh)
        for path, leaf in port:
            assert tuple(leaf.shape) == tuple(shapes[path].shape), path
            want = ref_sh.param_spec(path, tuple(leaf.shape), mesh, fsdp,
                                     "model", serve=serve)
            got = sh.param_spec(path, tuple(leaf.shape), mesh, fsdp, "model",
                                serve=serve)
            assert _norm(got, leaf.dim()) == _want(want, leaf.dim()), \
                (arch, path, got, want)
            n += 1
    assert n >= 370


@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_specs_equal_reference_every_leaf(mesh_name, serve):
    """``cache_spec`` of every cache leaf: the serving layout (batch over
    the data axes, sequence over model) and, for ``serve``, the long
    single-request layout (no batch axis, sequence over both)."""
    mesh = _mesh(mesh_name)
    dp = ("pod", "data") if "pod" in mesh.shape else ("data",)
    dp, tp = (None, ("data", "model")) if serve else (dp, "model")
    for arch in ARCH_IDS:
        rcfg = ref_config(arch)
        ref = dict(_ref_leaves(jax.eval_shape(
            lambda: ref_lm.init_caches(rcfg, 4, 64))))
        port = sh.leaf_paths(steps.abstract_caches(get_config(arch), 4, 64))
        assert sorted(p for p, _ in port) == sorted(ref), arch
        for path, leaf in port:
            assert tuple(leaf.shape) == tuple(ref[path].shape), path
            want = ref_sh.cache_spec(path, tuple(leaf.shape), mesh, dp, tp)
            got = sh.cache_spec(path, tuple(leaf.shape), mesh, dp, tp)
            assert _norm(got, leaf.dim()) == _want(want, leaf.dim()), \
                (arch, path)


@pytest.mark.parametrize("dims,dim,want", [
    (("model", 64), 64, ("model",)), (("model", 16), 63, (None,)),
    (("model", 16), 0, (None,)), ((("data", "model"), 256), 512,
                                  (("data", "model"),))],
    ids=["divides", "indivisible", "empty", "compound"])
def test_fit_divisibility_guard(dims, dim, want):
    mesh = _mesh("16x16")
    got = sh._fit(mesh, (dims[0],), (dim,))
    assert got == want == _want(ref_sh._fit(mesh, (dims[0],), (dim,)), 1)


@pytest.fixture(scope="module")
def fake_mesh():
    """A 2x4x2 (pod, data, model) DeviceMesh on a fake process group."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from torch.distributed.device_mesh import DeviceMesh
    dryrun.init_fake_group(16)
    yield DeviceMesh("cpu", torch.arange(16).reshape(2, 4, 2),
                     mesh_dim_names=("pod", "data", "model"))
    dist.destroy_process_group()


@pytest.mark.parametrize("spec,want", [
    ((), ("R", "R", "R")),
    (("model", None), ("R", "R", "S0")),
    ((("pod", "data"), "model"), ("S0", "S0", "S1")),
    ((None, ("data", "model")), ("R", "S1", "S1")),
    ((("pod", "data"), None, "model"), ("S0", "S0", "S2"))],
    ids=["replicated", "tp", "compound-fsdp", "compound-seq", "dp-tp"])
def test_placements_of_specs(fake_mesh, spec, want):
    from torch.distributed.tensor import Replicate, Shard
    got = sh.placements(spec, fake_mesh)
    assert got == tuple(Replicate() if w == "R" else Shard(int(w[1:]))
                        for w in want)


@pytest.mark.parametrize("spec", [(("data", "pod"),), ("data", "data"),
                                  ("nope",)],
                         ids=["out-of-order", "axis-twice", "unknown"])
def test_placements_refuse_what_a_dtensor_cannot_hold(fake_mesh, spec):
    with pytest.raises(ValueError):
        sh.placements(spec, fake_mesh)


def test_local_shard_deals_chunks_as_dtensor(fake_mesh):
    """``local_shard`` keeps rank 0's chunk of each sharded dimension (as
    ``torch.chunk`` deals them) and the global shape."""
    t = torch.arange(10 * 6, dtype=torch.float32).reshape(10, 6)
    d = sh.local_shard(t, fake_mesh, sh.placements((("pod", "data"),
                                                    "model"), fake_mesh))
    assert tuple(d.shape) == (10, 6)
    assert torch.equal(d.to_local(), t[:2, :3])      # 10 over 8: 2 rows
