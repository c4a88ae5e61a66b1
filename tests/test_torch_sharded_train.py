"""Sharded LM training on CPU meshes (gloo, one torch thread a rank)
against the JAX reference's: ``repro_torch.launch.train(mesh=...)`` on a
2x2 (data, model) mesh of four processes against
``repro.launch.train.train(mesh=make_test_mesh(2, 2))`` on four host
devices (a subprocess with ``XLA_FLAGS``), both from the reference's
initial weights, for reduced SmolLM and reduced Jamba in float32 (the
bf16 configs' parameters differ by bf16 ulps, which ``_hold_params``' bound
is not made for).  Also: a 1x1 mesh against the one-device path, a 2x2
checkpoint restored onto 1x1 and 4x1 (the counterpart of
``test_elastic_restore_other_mesh``), ``shard_hint``'s rules and the
placements the model's hint sites give, and serving (prefill, decode
steps with a tail flush) on sharded parameters and caches.

Tolerances: losses rtol 1e-4 against the reference, parameters within
``_hold_params``' bound (``tests/test_torch_train.py``: 1e-4 of each
leaf's largest magnitude, at least 10 lr); the 1x1 mesh within rtol 1e-5
of the one-device path (and bitwise); restores bitwise; sharded serving within 1e-5 of
the largest logit of the plain run."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
ARCHS = ("smollm-135m", "jamba-v0.1-52b")
LR = 3e-4

REFERENCE = r"""
import dataclasses, os, sys
import jax, numpy as np
from repro.launch import train as rt
from repro.launch.mesh import make_test_mesh
from repro.models import lm
arch, out = sys.argv[1], sys.argv[2]
orig = rt.get_reduced
rt.get_reduced = lambda a: dataclasses.replace(orig(a), param_dtype="float32")
cfg = rt.get_reduced(arch)
def flat(tree, prefix):
    return {prefix + "/".join(str(getattr(k, "key", k)) for k in kp):
            np.asarray(v, np.float32)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
init = lm.init_params(jax.random.PRNGKey(0), cfg)
state, losses = rt.train(arch, reduced=True, steps=3, global_batch=8,
                         seq_len=16, mesh=make_test_mesh(2, 2), log_every=100)
np.savez(os.path.join(out, arch + ".npz"), **flat(init, "init/"),
         **flat(state.params, "final/"), losses=np.asarray(losses))
"""


def _env(**kw):
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1", **kw)


def run_ranks(job, world, store, out, *args, timeout=600):
    """Run ``job`` of the worker on ``world`` gloo ranks; raise with the
    ranks' output if any fails."""
    procs = [subprocess.Popen(
        [sys.executable, WORKER, job, str(r), str(world), store, str(out),
         *map(str, args)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise AssertionError(f"{job}: ranks failed\n" + "\n".join(
            log[-3000:] for log in logs))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's 2x2 runs (in parallel), then the port's 2x2 job
    (training, 4x1 restore, hints, serving) and its world-1 job."""
    ref = tmp_path_factory.mktemp("ref")
    out = tmp_path_factory.mktemp("port")
    refs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, arch, str(ref)],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch in ARCHS]
    for p in refs:
        log = p.communicate(timeout=600)[0]
        assert p.returncode == 0, log[-3000:]
    run_ranks("mesh2x2", 4, str(out / "store4"), out, ref)
    run_ranks("one", 1, str(out / "store1"), out, ref)
    with open(out / "hint.json") as f:
        hint = json.load(f)
    with open(out / "serve.json") as f:
        serve = json.load(f)
    return dict(ref={a: dict(np.load(ref / f"{a}.npz")) for a in ARCHS},
                port=dict(np.load(out / "train.npz")),
                one=dict(np.load(out / "one.npz")), hint=hint, serve=serve)


def _hold_params(got, want, lr, names):
    for name in names:
        a_, b_ = got[name], want[name]
        scale = max(float(np.abs(b_).max()), 10 * lr)
        assert float(np.abs(a_ - b_).max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_losses_match_reference(runs, arch):
    got = runs["port"][f"{arch}/losses"]
    want = runs["ref"][arch]["losses"]
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_params_match_reference(runs, arch):
    ref = runs["ref"][arch]
    names = [k[len("final/"):] for k in ref if k.startswith("final/")]
    got = {n: runs["port"][f"{arch}/params/{n}"] for n in names}
    want = {n: ref["final/" + n] for n in names}
    assert set(k[len(arch) + 8:] for k in runs["port"]
               if k.startswith(arch + "/params/")) == set(names)
    _hold_params(got, want, LR, names)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_params_placed_by_the_rules(runs, arch):
    """Every trained parameter carries the placements of its rule on the
    2x2 mesh (FSDP over data, TP over model)."""
    from types import SimpleNamespace
    from repro_torch.distributed import sharding as sh
    mesh = SimpleNamespace(shape={"data": 2, "model": 2},
                           mesh_dim_names=("data", "model"))
    placed = json.loads(str(runs["port"][f"{arch}/placements"]))
    for name, p in placed.items():
        shape = runs["port"][f"{arch}/params/{name}"].shape
        want = sh.placements(sh.param_spec(name, shape, mesh, "data",
                                           "model"), mesh)
        assert p == str(tuple(want)), name


def test_one_by_one_mesh_matches_one_device(runs):
    """Within rtol 1e-5, and in fact bitwise: a 1x1 mesh replicates every
    axis (a size-1 axis splits nothing), so its local operators are the
    one-device run's."""
    one = runs["one"]
    np.testing.assert_allclose(one["mesh/losses"], one["plain/losses"],
                               rtol=1e-5)
    np.testing.assert_array_equal(one["mesh/losses"], one["plain/losses"])
    for k in one:
        if k.startswith("mesh/params/"):
            plain = one["plain/" + k[len("mesh/"):]]
            scale = max(float(np.abs(plain).max()), 10 * LR)
            assert float(np.abs(one[k] - plain).max()) <= 1e-5 * scale, k


@pytest.mark.parametrize("target", ["1x1", "4x1"])
def test_elastic_restore_onto_other_meshes(runs, target):
    """A checkpoint written by the 2x2 run restores onto 1x1 and 4x1
    meshes bit for bit, each parameter placed by the rules there."""
    src = runs["one"] if target == "1x1" else runs["port"]
    assert bool(src[f"restore_{target}_bitwise"])


def test_shard_hint_rules(runs):
    h = runs["hint"]
    assert h["dp_model"] == "(Shard(dim=0), Shard(dim=1))"
    assert h["indivisible"] == "(Replicate(), Shard(dim=2))"
    assert h["odd"] == "(Replicate(), Replicate())"
    assert h["missing_axis"] == "(Replicate(), Replicate())"
    assert h["plain_untouched"] and h["no_mesh_untouched"]


def test_shard_hint_sites_in_the_model(runs):
    """The reference's sites: each period's input [B,S,d] batch over data
    and sequence over model, the logits [B,S,V] batch over data and
    vocabulary over model (the forward's head and the loss's)."""
    sites = runs["hint"]["sites"]
    want_x = [["__dp__", "model", None], "(Shard(dim=0), Shard(dim=1))"]
    want_logits = [["__dp__", None, "model"], "(Shard(dim=0), Shard(dim=2))"]
    assert sites.count(want_x) == 2 * 2          # two layers, two passes
    assert sites.count(want_logits) == 2         # the loss and the forward
    assert all(s in (want_x, want_logits) for s in sites)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches_plain(runs, arch):
    assert runs["serve"][arch] <= 1e-5


def test_cuda_mesh_without_a_card_raises():
    """Without a card, a CUDA mesh's process group refuses to start (no
    gloo fallback, no CPU); on a machine with a card the NCCL start is
    held by ``tests/test_torch_cuda.py``."""
    import torch
    from repro_torch.launch import mesh as mesh_mod
    if torch.cuda.is_available():
        pytest.skip("a card is present: see tests/test_torch_cuda.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_mod.init_distributed("cuda", init_method="tcp://127.0.0.1:1",
                                  rank=0, world_size=1)
