"""One rank of a CPU mesh job for the port's sharding tests (gloo, one
torch thread).  Run by ``tests/test_torch_sharded_train.py`` and
``tests/test_torch_compression.py`` as

    python tests/torch_mesh_worker.py JOB RANK WORLD STORE OUT [ARGS...]

with ``STORE`` a file for the ``file://`` rendezvous and ``OUT`` a
directory; rank 0 writes the job's results there (``<job>.npz`` or
``.json``).  Imports nothing of JAX."""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.adam import tree_map  # noqa: E402

TRAIN = dict(steps=3, global_batch=8, seq_len=16, log_every=100)


def f32(arch):
    return dataclasses.replace(get_reduced(arch), param_dtype="float32")


def tree_from(flat, prefix):
    """Nested dict of float32 tensors from ``prefix``-named npz arrays."""
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            node = out
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(np.array(v, np.float32))
    return out


def whole(tree):
    """name -> numpy array of every leaf, DTensors gathered."""
    return {name: (t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().float().numpy()
            for name, t in zip(ckpt.leaf_names(tree),
                               [x for _, x in ckpt._leaves_with_names(tree)])}


def job_train(rank, mesh, out, ref_dir):
    """2x2 training of reduced SmolLM and Jamba (float32 copies) from the
    reference's initial weights; SmolLM checkpoints at its end, then the
    checkpoint is restored onto a 4x1 mesh."""
    res = {}
    for arch in ("smollm-135m", "jamba-v0.1-52b"):
        flat = dict(np.load(os.path.join(ref_dir, f"{arch}.npz")))
        ck = os.path.join(out, "ckpt") if arch == "smollm-135m" else None
        state, losses = train_mod.train(
            arch, cfg=f32(arch), device="cpu", mesh=mesh, ckpt_dir=ck,
            params=tree_from(flat, "init/"), **TRAIN)
        res[f"{arch}/losses"] = np.asarray(losses)
        for name, arr in whole(state.params).items():
            res[f"{arch}/params/{name}"] = arr
        placed = {name: str(t.placements) for name, t in
                  ckpt._leaves_with_names(state.params)}
        res[f"{arch}/placements"] = np.asarray(json.dumps(placed))
    # elastic: the 2x2 checkpoint onto 4x1 (every rank of the group)
    mesh41 = mesh_mod.make_test_mesh(4, 1, device="cpu")
    ok = restore_bitwise(os.path.join(out, "ckpt"), mesh41)
    res["restore_4x1_bitwise"] = np.asarray(ok)
    if rank == 0:
        np.savez(os.path.join(out, "train.npz"), **res)


def restore_bitwise(ck_dir, mesh):
    """Restore the SmolLM checkpoint's TrainState onto ``mesh`` by the
    training rules; whether every leaf equals the saved array bit for bit
    and carries the rules' placements."""
    from repro_torch.optim.trainer import create_state
    tmpl = create_state(lm.init_params(f32("smollm-135m"), seed=0,
                                       device="cpu"))
    p_sh = sh.param_shardings(tmpl.params, mesh, fsdp="data", tp="model")
    shardings = type(tmpl)(params=p_sh, opt=type(tmpl.opt)(
        m=p_sh, v=p_sh, t=None), step=None)
    back = ckpt.restore(tmpl, ck_dir, shardings=shardings, mesh=mesh)
    flat, _ = ckpt.restore_flat(ck_dir)
    ok = True
    for name, t in ckpt._leaves_with_names(back):
        got = t.full_tensor() if hasattr(t, "full_tensor") else t
        ok &= np.array_equal(got.numpy(), flat[name])
    for name, t in ckpt._leaves_with_names(back.params):
        ok &= tuple(t.placements) == tuple(
            sh.placements(sh.param_spec(name, tuple(t.shape), mesh, "data",
                                        "model"), mesh))
    return bool(ok)


def job_hint(rank, mesh, out):
    """shard_hint's rules on a 2x2 mesh, and the hints the model's sites
    give (recorded through a wrapper)."""
    x = sh.local_shard(torch.arange(4 * 16 * 6, dtype=torch.float32)
                       .reshape(4, 16, 6), mesh, sh.replicated(mesh))
    got = {}
    with mesh_mod.mesh_context(mesh):
        got["dp_model"] = str(L.shard_hint(x, "__dp__", "model", None)
                              .placements)
        got["indivisible"] = str(L.shard_hint(x, None, None, "model")
                                 .placements)        # 6 % 2 == 0: sharded
        got["odd"] = str(L.shard_hint(x[:, :, :3], None, None, "model")
                         .placements)                # 3 % 2: replicated
        got["missing_axis"] = str(L.shard_hint(x, "pod", None, None)
                                  .placements)
        plain = torch.ones(4, 16, 6)
        got["plain_untouched"] = L.shard_hint(plain, "__dp__") is plain
        # the model's sites: record each hint's result
        seen = []
        orig = L.shard_hint

        def rec(t, *axes):
            r = orig(t, *axes)
            seen.append([list(axes), str(r.placements)])
            return r
        L.shard_hint = rec
        try:
            cfg = f32("smollm-135m")
            params = lm.init_params(cfg, seed=1, device="cpu")
            dp = convert.lm_params(tree_map(lambda t: t.numpy(), params),
                                   mesh=mesh)
            tok = sh.local_shard(torch.randint(0, cfg.vocab, (4, 16),
                                               generator=torch.Generator()
                                               .manual_seed(0)),
                                 mesh, sh.batch_sharding(mesh, "data"))
            lm.loss_fn(dp, cfg, tok, tok)
            lm.forward(dp, cfg, tok)
        finally:
            L.shard_hint = orig
        got["sites"] = seen
    got["no_mesh_untouched"] = L.shard_hint(x, "__dp__", "model") is x
    if rank == 0:
        with open(os.path.join(out, "hint.json"), "w") as f:
            json.dump(got, f)


def job_serve(rank, mesh, out):
    """prefill, extend_caches, decode steps (a tail flush among them) on
    sharded parameters and caches against the same on plain tensors."""
    res = {}
    for arch in ("smollm-135m", "jamba-v0.1-52b"):
        cfg = f32(arch)
        params = lm.init_params(cfg, seed=2, device="cpu")
        g = torch.Generator().manual_seed(3)
        tok = torch.randint(0, cfg.vocab, (4, 12), generator=g)
        steps = torch.randint(0, cfg.vocab, (4, 3), generator=g)

        def run(p, t, put):
            logits, caches = lm.prefill(p, cfg, t)
            caches = lm.extend_caches(caches, cfg, 80)
            outs = [logits]
            for i in range(steps.shape[1]):
                if i == 2:
                    caches = lm.flush_tails(caches, cfg)
                lg, caches = lm.decode_step(p, cfg, put(steps[:, i:i + 1]),
                                            caches, 12 + i)
                outs.append(lg)
            return outs
        want = run(params, tok, lambda t: t)
        with mesh_mod.mesh_context(mesh):
            dp = sh.distribute(params, mesh, sh.param_shardings(
                params, mesh, serve=True))
            put = lambda t: sh.local_shard(t, mesh,
                                           sh.batch_sharding(mesh, "data"))
            got = run(dp, put(tok), put)
        res[arch] = max(float((g_.full_tensor() - w_).abs().max()
                              / w_.abs().max()) for g_, w_ in zip(got, want))
    if rank == 0:
        with open(os.path.join(out, "serve.json"), "w") as f:
            json.dump(res, f)


def job_one(rank, out, ref_dir):
    """World 1: a 1x1 mesh against the one-device path, and the 2x2
    checkpoint restored onto 1x1."""
    mesh = mesh_mod.make_test_mesh(1, 1, device="cpu")
    res = {}
    arch = "smollm-135m"
    flat = dict(np.load(os.path.join(ref_dir, f"{arch}.npz")))
    for name, m in (("mesh", mesh), ("plain", None)):
        state, losses = train_mod.train(arch, cfg=f32(arch), device="cpu",
                                        mesh=m,
                                        params=tree_from(flat, "init/"),
                                        **TRAIN)
        res[f"{name}/losses"] = np.asarray(losses)
        for k, v in whole(state.params).items():
            res[f"{name}/params/{k}"] = v
    res["restore_1x1_bitwise"] = np.asarray(
        restore_bitwise(os.path.join(out, "ckpt"), mesh))
    np.savez(os.path.join(out, "one.npz"), **res)


def job_psum(rank, world, out):
    """compressed_psum over the world: rank r's gradient is row r of a
    seeded [world, 37] array (and a [world, 4, 5] one), residuals zero,
    then again with the residuals the first call left."""
    from repro_torch.distributed import compression as comp
    rng = np.random.default_rng(11)
    ga = rng.normal(0, 1, (world, 37)).astype(np.float32)
    gb = (rng.normal(0, 1, (world, 4, 5)) * 100).astype(np.float32)
    grads = dict(a=torch.from_numpy(ga[rank]), b=torch.from_numpy(gb[rank]))
    r = comp.init_residuals(grads)
    out1, r1 = comp.compressed_psum(grads, r)
    out2, r2 = comp.compressed_psum(grads, r1)
    if rank == 0:
        np.savez(os.path.join(out, f"psum{world}.npz"),
                 **{f"out1/{k}": v.numpy() for k, v in out1.items()},
                 **{f"out2/{k}": v.numpy() for k, v in out2.items()},
                 **{f"r1/{k}": v.numpy() for k, v in r1.items()})


def main():
    job, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    mesh_mod.init_distributed("cpu", init_method="file://" + store,
                              rank=rank, world_size=world)
    try:
        if job == "mesh2x2":
            mesh = mesh_mod.make_test_mesh(2, 2, device="cpu")
            job_train(rank, mesh, out, sys.argv[6])
            job_hint(rank, mesh, out)
            job_serve(rank, mesh, out)
        elif job == "one":
            job_one(rank, out, sys.argv[6])
        elif job == "psum":
            job_psum(rank, world, out)
        else:
            raise ValueError(job)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
