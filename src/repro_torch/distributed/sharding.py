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
devices with ``XLA_FLAGS``.

The LM rules (the reference's ``:28-192``): FSDP (+pod) x TP layouts for
every architecture family, by parameter name; every rule degrades to
replication when a dimension does not divide by its mesh axis, so one rule
set serves the 16x16 pod, the 2x16x16 two-pod mesh and the small test
meshes.  Conventions, as in the reference:

  * fsdp axes: ("data",) on one pod, ("pod", "data") on two for the
    largest models: weights fully sharded, gathered a layer at a time;
  * tp axis: "model": attention heads, FFN inner width, vocabulary;
  * the leading period axis of the stacked blocks is never sharded;
  * KV caches shard the sequence over "model" and the batch over the data
    axes; recurrent states shard their channels.

A spec is a tuple with one entry a dimension: None, an axis name or a
tuple of axis names (a compound axis), the counterpart of a
``PartitionSpec``.  :func:`placements` turns it into DTensor placements on
a ``DeviceMesh``; a compound axis shards its dimension over each of its
mesh dimensions, major to minor, as JAX orders it.  The rules read only
the axis sizes, so they also take any object with a ``shape`` mapping of
axis name to size (a mesh too large to build).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

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


# ------------------------------------------------------------ the LM rules
Axis = Any  # str | tuple[str, ...] | None
Spec = Tuple[Axis, ...]


def mesh_shape(mesh) -> dict:
    """Axis name -> size, of a DeviceMesh or of a duck-typed mesh with a
    ``shape`` mapping."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axsize(mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, str):
        return shape[axis]
    return int(np.prod([shape[a] for a in axis]))


def _flat(*axes) -> Tuple[str, ...]:
    """Flatten possibly-tuple axis specs into one compound tuple."""
    out = []
    for a in axes:
        if a is None:
            continue
        if isinstance(a, str):
            out.append(a)
        else:
            out.extend(a)
    return tuple(out)


def _fit(mesh, spec_axes, shape) -> Spec:
    """Drop axes that don't divide the corresponding dim."""
    fixed = []
    for dim, ax in zip(shape, spec_axes):
        if ax is not None and dim % _axsize(mesh, ax) == 0 and dim > 0:
            fixed.append(ax)
        else:
            fixed.append(None)
    return tuple(fixed)


# parameter-name classes
_COL = ("wq", "wk", "wv", "wuq", "wukv", "x_wq", "x_wk", "x_wv", "w_gate",
        "w_up", "in_proj", "up", "qkv", "s_gate", "s_up", "gates", "wx")
_ROW = ("wo", "x_wo", "w_down", "out_proj", "down", "s_down")
_REP = ("norm1", "norm2", "x_norm", "q_norm", "kv_norm", "ln", "norm",
        "final_norm", "dt_bias", "d_skip", "x_gate", "conv_b", "pos",
        "dt_w", "router", "wdq", "wdkv")


def param_spec(path: str, shape: Tuple[int, ...], mesh, fsdp: Axis,
               tp: Axis, *, serve: bool = False) -> Spec:
    """The rule for one parameter leaf (path: '/'-joined keys).

    serve=False (training): FSDP x TP, every matrix sharded on both of its
    dimensions and gathered a layer at a time.  serve=True (decode):
    Megatron column/row TP over ``tp`` only, the weights stationary
    (replicated over the data axes)."""
    parts = path.split("/")
    name = parts[-2] if parts[-1] in ("w", "b") else parts[-1]
    stacked = parts[0] == "blocks" or (len(parts) > 1 and parts[1] == "blocks")
    lead = (None,) if stacked else ()
    row_in = fsdp if not serve else None     # contracting-dim shard (train)

    def spec(*axes):
        return _fit(mesh, lead + axes, shape)

    if name == "embed" or (len(parts) >= 2 and parts[-2] == "embed"):
        return _fit(mesh, (tp, None if serve else fsdp), shape)
    if name == "lm_head":
        return _fit(mesh, (None if serve else fsdp, tp), shape)
    if parts[-1] == "b":  # bias: follows the out dim of its matrix
        if name in _COL:
            return spec(tp)
        return spec(None)
    if name in _REP:
        return spec(*([None] * (len(shape) - len(lead))))
    if name in _COL:
        return spec(row_in, tp)
    if name in _ROW:
        return spec(tp, row_in)
    if name == "conv_w":
        return spec(None, tp)
    if name in ("a_log", "x_proj"):
        return spec(tp, None)
    if name == "wr":  # sLSTM recurrent matrix
        return spec(None, tp)
    if name in ("e_gate", "e_up"):       # [E, d, f]
        E = shape[len(lead)]
        if E % _axsize(mesh, tp) == 0:
            return spec(tp, row_in, None)   # expert-parallel
        return spec(None, row_in, tp)       # small E: d over fsdp, f over tp
    if name == "e_down":                  # [E, f, d]
        E = shape[len(lead)]
        if E % _axsize(mesh, tp) == 0:
            return spec(tp, None, row_in)
        return spec(None, tp, row_in)
    return spec(*([None] * (len(shape) - len(lead))))


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, paths '/'-joined as the
    reference's ``_path_str`` joins a key path."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in leaf_paths(v, f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]


def _map_paths(tree, fn, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def is_placements(x: Any) -> bool:
    """Whether ``x`` is a tuple of DTensor placements (a leaf of a tree of
    shardings)."""
    return isinstance(x, tuple) and bool(x) \
        and all(isinstance(p, Placement) for p in x)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: mesh dimension i gets
    ``Shard(d)`` when its axis name is in dimension d's entry and its size
    is above 1, else ``Replicate()`` (the same layout: a size-1 axis
    splits nothing).  A compound entry must list its axes in the mesh's
    order (major to minor), the only order a DTensor shards in."""
    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_shape(mesh)
    out = [Replicate()] * len(names)
    used = set()
    for d, ax in enumerate(spec):
        axes = _flat(ax)
        idx = [names.index(a) for a in axes if a in names]
        if len(idx) != len(axes):
            raise ValueError(f"spec {spec}: axis not in mesh {names}")
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: compound axis {axes} is not in "
                             f"the mesh's order {names}")
        for i in idx:
            if i in used:
                raise ValueError(f"spec {spec}: mesh axis {names[i]} used "
                                 "twice")
            used.add(i)
            if sizes[names[i]] > 1:     # a size-1 axis shards nothing
                out[i] = Shard(d)
    return tuple(out)


def param_shardings(params, mesh, *, fsdp: Axis = "data", tp: Axis = "model",
                    serve: bool = False):
    """Tree of placements matching ``params`` (tensors of any kind: real,
    meta, fake), each leaf's by :func:`param_spec` of its path."""
    return _map_paths(params, lambda path, leaf: placements(param_spec(
        path, tuple(leaf.shape), mesh, fsdp, tp, serve=serve), mesh))


# ------------------------------------------------------------------ caches
def cache_spec(path: str, shape, mesh, dp: Axis, tp: Axis,
               *, shard_seq: bool = True) -> Spec:
    """KV/state cache rule.  Stacked layout [n_periods, B, ...]."""
    name = path.split("/")[-1]
    if name in ("k_tail", "v_tail", "ckv_tail", "krope_tail"):
        # ring tail: small, batch-sharded only
        rest = [None] * (len(shape) - 2)
        return _fit(mesh, (None, dp, *rest), shape)
    if name == "plen":
        return _fit(mesh, tuple([None] * len(shape)), shape)
    if name in ("k", "v", "ckv", "krope", "xk", "xv"):
        # [P, B, S, ...]: batch over dp, seq over tp (flash-decode)
        seq_ax = tp if shard_seq else None
        rest = [None] * (len(shape) - 3)
        return _fit(mesh, (None, dp, seq_ax, *rest), shape)
    if name == "ssm":      # [P, B, di, N]
        return _fit(mesh, (None, dp, tp, None), shape)
    if name == "conv":     # [P, B, dc-1, di]
        return _fit(mesh, (None, dp, None, tp), shape)
    if name == "C":        # [P, B, H, dqk, dv]
        return _fit(mesh, (None, dp, None, None, tp), shape)
    if name in ("h", "c", "n", "m"):   # [P, B, di]
        return _fit(mesh, (None, dp, tp), shape)
    return _fit(mesh, tuple([None] * len(shape)), shape)


def cache_shardings(caches, mesh, *, dp: Axis = "data", tp: Axis = "model",
                    shard_seq: bool = True):
    return _map_paths(caches, lambda path, leaf: placements(cache_spec(
        path, tuple(leaf.shape), mesh, dp, tp, shard_seq=shard_seq), mesh))


def batch_sharding(mesh, dp: Axis, *, extra_dims: int = 1) -> tuple:
    return placements((dp,) + (None,) * extra_dims, mesh)


def replicated(mesh) -> tuple:
    return placements((), mesh)


def distribute(tree, mesh, shardings):
    """Each leaf of ``tree`` as a DTensor on ``mesh`` with the placements
    of the matching leaf of ``shardings``.  Every rank holds the whole
    tensor (the same on all: drawn from one seed, or restored), and keeps
    its own shard of it: no collective runs."""
    if isinstance(tree, dict):
        return {k: distribute(v, mesh, shardings[k]) for k, v in tree.items()}
    return local_shard(tree, mesh, shardings)


def local_shard(t: torch.Tensor, mesh, place) -> DTensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor with
    ``place``: this rank's chunk of each sharded dimension, as
    ``torch.chunk`` deals it (the DTensor layout)."""
    if isinstance(t, DTensor):
        return t.redistribute(mesh, place)
    local = t
    coord = mesh.get_coordinate()
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            local = _chunk(local, p.dim, mesh.size(i), coord[i])
    # a tensor that holds no data (meta, or fake: the dry-run's) gets a new
    # one of the chunk's shape; copying its chunk would run a real kernel
    from torch._subclasses.fake_tensor import FakeTensor
    local = t.new_empty(local.shape) if t.is_meta \
        or isinstance(t, FakeTensor) else local.contiguous()
    return DTensor.from_local(local, mesh, place,
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape,
                                                 device="meta").stride())


def _chunk(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Chunk ``i`` of ``n`` along ``dim`` as ``torch.chunk`` deals them
    (empty past the last chunk), the DTensor ``Shard`` layout."""
    size = -(-t.shape[dim] // n)
    lo = min(i * size, t.shape[dim])
    return t.narrow(dim, lo, min(size, t.shape[dim] - lo))
