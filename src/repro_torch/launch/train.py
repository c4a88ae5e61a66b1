"""Training driver (port of ``repro.launch.train``): real steps on one
device or on a mesh, with checkpointing, auto-resume, preemption
tolerance and elastic restore.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
      --resume auto --device cuda|cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch smollm-135m --reduced --steps 20 --device cpu

Without a mesh (and with no process group) ``train`` runs on the one
device it is given.  With a ``mesh`` (``repro_torch.launch.mesh``; under
``torchrun`` the CLI builds ``make_test_mesh()`` over the world, gloo on
the CPU, NCCL on cards) the parameters and the Adam state are DTensors
placed by ``param_shardings`` (FSDP over "data", TP over "model"), and
every rank draws the global ``batch_at(step)`` and keeps its ``Shard(0)``
rows over the data axes, as the reference's ``device_put`` with
``P(dp, None)`` does (not the pipeline's ``n_shards`` streams, which
differ).  A config
that reads context (Whisper's frames, a VLM's image embeddings) gets stub
embeddings drawn from the seed and the step, as ``serve`` gives it; the
reference's driver passes none, which Whisper's encoder cannot run
without.  On CUDA the
attention and Mamba layers run the ``flash_attention`` and ``ssm_scan``
kernels forward and their backward kernels for the gradients; on the CPU
their plain versions, differentiated by autograd.  Checkpoints carry the
reference's leaf names, so either package resumes the other's.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import device as device_mod
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim.trainer import TrainConfig, create_state, make_train_step


def context_at(cfg, seed: int, step: int, batch: int):
    """Stub context embeddings [batch, n, d] * 0.1 for ``step`` (None for
    a config without context), a pure function of (seed, step)."""
    if not (cfg.n_context_tokens or cfg.is_encdec):
        return None
    n = cfg.n_audio_frames if cfg.is_encdec else cfg.n_context_tokens
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 0xC7C7]))
    return (rng.standard_normal((batch, n, cfg.d_model), np.float32) * 0.1)


def train(arch: str, *, reduced: bool = True, steps: int = 100,
          global_batch: int = 8, seq_len: int = 128, lr: float = 3e-4,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          resume: str = "no", seed: int = 0, microbatches: int = 1,
          log_every: int = 10, stop_after: Optional[int] = None,
          device="cuda", cfg=None, mesh=None, params=None):
    """Train ``arch`` (or ``cfg``, a config given whole, e.g. cut in depth)
    from random weights of ``seed`` (or from ``params``, a tree of whole
    tensors on ``device``, which the trainer updates in place when there
    is no mesh); returns (state, losses).  The batches are the data
    pipeline's ``batch_at(step)``, so a resumed run sees the batches an
    unbroken one would.  ``mesh``: train sharded on it (see the module
    docstring); ``device`` is then this rank's."""
    dev = device_mod.resolve(device)
    cfg = cfg or (get_reduced(arch) if reduced else get_config(arch))
    tc = TrainConfig(lr=lr, warmup_steps=max(10, steps // 10),
                     total_steps=steps, microbatches=microbatches)
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                    global_batch=global_batch, seed=seed)
    say = print if not dist.is_initialized() or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    with (contextlib.nullcontext() if mesh is None
          else mesh_mod.mesh_context(mesh)):
        if params is None:
            params = lm.init_params(cfg, seed=seed, device=dev)
        if mesh is not None:
            params = sh.distribute(params, mesh, sh.param_shardings(
                params, mesh, fsdp="data", tp="model"))
        state = create_state(params)
        start = 0
        if resume == "auto" and ckpt_dir \
                and ckpt.latest_step(ckpt_dir) is not None:
            state = ckpt.restore(state, ckpt_dir)
            start = int(state.step)
            say(f"[train] resumed from step {start}")
        step_fn = make_train_step(cfg, tc)

        losses = []
        t0 = time.time()
        for step in range(start, steps):
            batch = {k: torch.as_tensor(v, device=dev).long()
                     for k, v in batch_at(dc, step).items()}
            ctx = context_at(cfg, seed, step, global_batch)
            if ctx is not None:
                batch["ctx"] = torch.as_tensor(ctx, device=dev).to(
                    L.dtype_of(cfg.param_dtype))
            if mesh is not None:
                dp = mesh_mod.dp_axes(mesh)
                batch = {k: sh.local_shard(v, mesh, sh.batch_sharding(
                    mesh, dp, extra_dims=v.dim() - 1))
                    for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            losses.append(_scalar(metrics["loss"]))
            if step % log_every == 0 or step == steps - 1:
                say(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                    f"lr {_scalar(metrics['lr']):.2e} "
                    f"({(time.time() - t0):.1f}s)")
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                ckpt.save(state, ckpt_dir, step + 1)
            if stop_after is not None and step + 1 - start >= stop_after:
                say(f"[train] simulated preemption after {stop_after} steps")
                break
        if ckpt_dir:
            ckpt.save(state, ckpt_dir, int(state.step))
    return state, losses


def _scalar(t) -> float:
    """A metric as a Python float (a DTensor's whole value)."""
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="no", choices=["no", "auto"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    mesh, device = None, a.device
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        device = mesh_mod.init_distributed(a.device)
        mesh = mesh_mod.make_test_mesh(device=a.device)
    try:
        train(a.arch, reduced=a.reduced, steps=a.steps, global_batch=a.batch,
              seq_len=a.seq, lr=a.lr, ckpt_dir=a.ckpt_dir,
              ckpt_every=a.ckpt_every, resume=a.resume, seed=a.seed,
              microbatches=a.microbatches, device=device, mesh=mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
