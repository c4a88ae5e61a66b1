"""Batch-axis device meshes for the batched DSE engine (port of the batch
part of ``repro.distributed.sharding``).

The reference shards the fused env step's batch axis with ``shard_map``
over a 1-D ``jax.sharding.Mesh``.  Here a mesh is the list of devices the
batch's contiguous chunks run on, and :func:`shard_call` is the
``shard_map``: it splits every batched operand into equal chunks, runs the
function on each chunk's device, and gathers the outputs in batch order.
The env step is element-wise over the batch, so the gathered result is
the unchunked one, bit for bit (``tests/test_torch_multidev.py``).

On the CPU the mesh holds the one CPU device n times: n chunks on one
device stand in for n devices, as the reference's tests emulate host
devices with ``XLA_FLAGS``.  The reference's LM parameter and KV-cache
rules (``param_spec``, ``cache_spec`` and their helpers) are not ported
(ROADMAP A11).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

BATCH_AXIS = "batch"


def batch_mesh(devices: Optional[int] = None, *,
               device="cuda") -> List[torch.device]:
    """The devices of a 1-D mesh over the env batch axis.

    On CUDA, ``devices=n`` takes the first ``n`` cards and ``None`` every
    visible one; more than ``torch.cuda.device_count()`` raises
    ``ValueError`` (the CLI surfaces that as one line before any work).  On
    the CPU the mesh is ``n`` entries of the CPU device (``None``: one)."""
    dev = torch.device(device)
    avail = torch.cuda.device_count() if dev.type == "cuda" else None
    n = (avail or 1) if devices is None else int(devices)
    if n < 1:
        raise ValueError(f"batch_mesh needs >= 1 device (got {n})")
    if avail is not None and n > avail:
        raise ValueError(f"batch_mesh: {n} devices requested but only "
                         f"{avail} visible (torch.cuda.device_count())")
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def shard_keys(seed: int, n_shards: int) -> np.ndarray:
    """(n_shards,) uint64 per-shard generator seeds from one global seed.

    Shard ``i``'s seed is numpy's ``SeedSequence(seed, spawn_key=(i,))``
    state: independent streams that are a pure function of the global seed
    and the shard's position, so re-sharding re-derives identical streams
    and a deal of n shards is a prefix of a larger one."""
    if n_shards < 1:
        raise ValueError(f"shard_keys needs >= 1 shard (got {n_shards})")
    return np.array([
        np.random.SeedSequence(int(seed), spawn_key=(i,))
        .generate_state(1, np.uint64)[0] for i in range(n_shards)],
        np.uint64)


def shard_call(fn: Callable, mesh: Sequence[torch.device], args: Sequence,
               *, replicated: Sequence[int] = (),
               out_device=None):
    """``fn(*args)`` with every operand but those at ``replicated``
    positions split into ``len(mesh)`` contiguous chunks along dim 0, chunk
    ``j`` run on ``mesh[j]``; tensor outputs (also inside tuples and dicts)
    are concatenated back in chunk order on ``out_device``."""
    n = len(mesh)
    pieces = [None if i in replicated else a.tensor_split(n)
              for i, a in enumerate(args)]
    outs = [fn(*(a.to(d) if p is None else p[j].to(d)
                 for a, p in zip(args, pieces)))
            for j, d in enumerate(mesh)]
    return _gather(outs, out_device)


def _gather(outs: list, dev):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(dev) if dev is not None else o for o in outs])
    if isinstance(first, dict):
        return {k: _gather([o[k] for o in outs], dev) for k in first}
    return type(first)(_gather(list(g), dev) for g in zip(*outs))
