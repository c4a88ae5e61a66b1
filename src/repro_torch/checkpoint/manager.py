"""Checkpointing: atomic, versioned, restorable by leaf name (port of
``repro.checkpoint.manager``).

Layout:  <dir>/step_<N>/arrays.npz + manifest.json, written to a tmp dir
and atomically renamed, so a preempted writer never leaves a torn
checkpoint; retention keeps the most recent ``keep`` steps.

Leaf names follow the reference's: ``/``-joined dict keys in sorted key
order, NamedTuple fields prefixed with ``.`` in field order, sequence
items by index.  A tree of tensors saved here therefore carries the same
names, shapes and dtypes as the reference's tree of the same structure,
and each package reads the other's checkpoints (``restore_flat``, and
``restore`` into a template tree such as the trainer's ``TrainState``).
Tensors are copied to host numpy arrays; a bfloat16 leaf is stored as its
2-byte bits (uint16) under a ``bfloat16`` dtype tag, as the reference
stores its own.

Sharded trees: a DTensor leaf is saved whole (``full_tensor()``, a
collective every rank of the process group joins), and rank 0 alone
writes; every rank returns after the write.  :func:`restore` takes
``shardings`` (a tree of placements matching the template, as
``repro_torch.distributed.sharding.param_shardings`` gives) and a
``mesh``, and deals each whole array onto any mesh, whatever mesh wrote it
(the reference's elastic restore); a DTensor template leaf without them
keeps its own mesh and placements.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.fsutil import fsync_dir, fsync_file
from repro_torch.distributed.sharding import is_placements, local_shard


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves_with_names(tree: Any, prefix: str = ""
                       ) -> List[Tuple[str, Any]]:
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves_with_names(tree[k], join(k))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _leaves_with_names(getattr(tree, f), join("." + f))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves_with_names(v, join(i))]
    return [(prefix, tree)]


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """(name -> host array, name -> dtype tag): bfloat16 for a bf16
    tensor, whose array holds its bits."""
    arrays, dtypes = {}, {}
    for name, leaf in _leaves_with_names(tree):
        arrays[name] = _to_numpy(leaf)
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        dtypes[name] = "bfloat16" if bf16 else str(arrays[name].dtype)
    return arrays, dtypes


def _to_tensor(arr: np.ndarray, dtype_tag: str, device) -> torch.Tensor:
    """A restored array as a tensor on ``device``: a ``bfloat16`` leaf's
    bits back to bfloat16."""
    arr = np.array(arr, order="C")       # a copy, 0-d arrays kept 0-d
    if dtype_tag == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def leaf_names(tree: Any) -> List[str]:
    """Flat leaf names in tree order — the keys ``save`` writes arrays
    under.  Lets callers pair ``restore_flat`` arrays with a template."""
    return [name for name, _ in _leaves_with_names(tree)]


def unflatten_from(flat: Dict[str, np.ndarray], prefix: str,
                   template: Any) -> Any:
    """Rebuild a tree shaped like ``template`` from ``flat`` leaves named
    ``<prefix>/<leaf name>``; each tensor leaf lands on the template leaf's
    device with its dtype."""
    def build(node, name):
        if isinstance(node, dict):
            return {k: build(v, f"{name}/{k}") for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f), f"{name}/.{f}")
                                for f in node._fields))
        arr = np.asarray(flat[name])
        if isinstance(node, torch.Tensor):
            return torch.as_tensor(arr.copy(), device=node.device).to(
                node.dtype)
        return arr.copy()
    return build(template, prefix)


def _json_safe(obj: Any) -> Any:
    """Recursively coerce numpy scalars/arrays so ``extra`` always
    serializes.  Non-finite floats become strings ("inf"/"nan") so the
    manifest stays strict JSON; ``float()`` parses them back."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _json_safe(obj.tolist())
    if isinstance(obj, np.generic):
        return _json_safe(obj.item())
    if isinstance(obj, float) and not np.isfinite(obj):
        return str(obj)
    return obj


def save(tree: Any, ckpt_dir: str, step: int, *, keep: int = 3,
         extra: Optional[Dict] = None) -> str:
    flat, dtypes = _flatten(tree)
    if dist.is_initialized():
        final = os.path.join(ckpt_dir, f"step_{int(step):08d}")
        if dist.get_rank() == 0:
            _write(flat, dtypes, ckpt_dir, step, keep, extra)
        dist.barrier()
        return final
    return _write(flat, dtypes, ckpt_dir, step, keep, extra)


def _write(flat, dtypes, ckpt_dir: str, step: int, keep: int,
           extra: Optional[Dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    manifest = dict(step=int(step),
                    names=list(flat.keys()),
                    dtypes=dtypes,
                    shapes={k: list(v.shape) for k, v in flat.items()},
                    extra=_json_safe(extra or {}))
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # durable BEFORE the rename publishes the step dir: a power loss
        # must never leave a visible step_N with truncated contents
        fsync_file(os.path.join(tmp, "arrays.npz"))
        fsync_dir(tmp)
        final = os.path.join(ckpt_dir, f"step_{int(step):08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        fsync_dir(ckpt_dir)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_flat(ckpt_dir: str, step: Optional[int] = None
                 ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Raw host-side restore: (flat name -> np.ndarray, manifest), float64
    leaves (the PER sum-tree) included as written, and a leaf the manifest
    tags ``bfloat16`` as its uint16 bits (numpy has no bfloat16;
    :func:`restore` makes the tensor)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{int(step):08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        out = {name: data[name] for name in manifest["names"]}
    return out, manifest


def _map_named(tree: Any, fn, prefix: str = "") -> Any:
    """``tree`` with each leaf replaced by fn(name, leaf), the names those
    of :func:`_leaves_with_names` (a tuple of placements is a leaf)."""
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, join(k)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_named(getattr(tree, f), fn, join("." + f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)) and not is_placements(tree):
        return type(tree)(_map_named(v, fn, join(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def restore(template: Any, ckpt_dir: str, step: Optional[int] = None, *,
            shardings: Any = None, mesh=None) -> Any:
    """Restore into the template's structure (port of the reference's
    ``restore``): each leaf taken by its name, in the checkpoint's dtype
    (bfloat16 kept), on the template leaf's device.  ``shardings`` (a
    tree of placements, or None for a leaf to keep whole) with ``mesh``
    re-targets any mesh, the elastic path; without them a DTensor template
    leaf is dealt onto its own mesh and placements."""
    flat, manifest = restore_flat(ckpt_dir, step)
    place = {}
    if shardings is not None:
        _map_named(shardings, lambda name, p: place.__setitem__(name, p))

    def one(name, leaf):
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        if place.get(name) is not None:
            dev = mesh.device_type
        t = _to_tensor(flat[name], manifest["dtypes"][name], dev)
        if place.get(name) is not None:
            return local_shard(t, mesh, place[name])
        if isinstance(leaf, DTensor):
            return local_shard(t, leaf.device_mesh, leaf.placements)
        return t
    return _map_named(template, one)


def manifest_of(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    step = step if step is not None else latest_step(ckpt_dir)
    with open(os.path.join(ckpt_dir, f"step_{int(step):08d}",
                           "manifest.json")) as f:
        return json.load(f)
