"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions, the counterpart of a ``jax.sharding.Mesh``; a sharded tensor
is a ``DTensor`` whose placements the rules of
``repro_torch.distributed.sharding`` give (the counterpart of a
``NamedSharding``).

* :func:`init_distributed` starts the process group: ``torchrun``'s
  environment when it is set, else a ``file://`` or ``tcp://`` address and
  a rank and world size the caller gives.  It takes gloo for the CPU and
  NCCL for CUDA, and a CUDA request without a card, or a failed NCCL
  start, raises (there is no gloo fallback for CUDA tensors).
* :func:`make_test_mesh` builds a (data, model) mesh over the initialised
  group with the reference's clamping to the world size;
  :func:`make_production_mesh` the 16 x 16 pod or the 2 x 16 x 16 two-pod
  mesh, which needs a world of 256 or 512 ranks: only the dry-run
  (``repro_torch.launch.dryrun``) makes one, on a fake process group.
* :func:`mesh_context` sets the ambient mesh that
  ``repro_torch.models.layers.shard_hint`` reads; :func:`current_mesh`
  reads it.

The reference's jax-version shims (``jax.set_mesh`` against a ``Mesh`` used
as its own context manager, ``AxisType`` for explicit axis types) have no
counterpart: a DeviceMesh has one kind of dimension, and the ambient mesh
is this module's own.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import device as device_mod

_AMBIENT: list = []


def init_distributed(device="cuda", *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout: Optional[float] = None) -> torch.device:
    """Start the default process group (once) and return this rank's
    device.  Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) the
    environment gives the rank, the world and the address; otherwise the
    caller gives ``init_method`` (``file://...`` or ``tcp://host:port``),
    ``rank`` and ``world_size``.  CPU: gloo; CUDA: NCCL on card
    ``LOCAL_RANK`` (or the rank), and no card or a failed NCCL start
    raises.  ``timeout``: seconds to wait for the other ranks."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {local} has no card: "
                               f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this torch "
                               "build lacks")
    if dist.is_initialized():
        return dev
    kw = dict(backend="nccl" if dev.type == "cuda" else "gloo")
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if dev.type == "cuda":
        kw["device_id"] = dev
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ \
            and init_method is None:
        dist.init_process_group(init_method="env://", **kw)
    else:
        if init_method is None or rank is None or world_size is None:
            raise ValueError("init_distributed: outside torchrun, give "
                             "init_method, rank and world_size")
        dist.init_process_group(init_method=init_method, rank=rank,
                                world_size=world_size, **kw)
    if dev.type == "cuda":
        # NCCL connects lazily: one collective here makes a failed start
        # raise now, not at the first training step
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
        torch.cuda.synchronize(dev)
    return dev


def _mesh(device, shape: Tuple[int, ...], names: Tuple[str, ...]
          ) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    dev = torch.device(device)
    n = 1
    for s in shape:
        n *= s
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"
                         ) -> DeviceMesh:
    """16x16 (one 256-device pod) or 2x16x16 (two pods, 512 devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_test_mesh(n_data: int = 2, n_model: int = 2, *, device="cuda"
                   ) -> DeviceMesh:
    """A (data, model) mesh over the group's first ranks, clamped to the
    world size as the reference clamps to ``jax.devices()``."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    n_data = min(n_data, n)
    n_model = max(1, min(n_model, n // n_data))
    return _mesh(device, (n_data, n_model), ("data", "model"))


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    return mesh.size(axis_names(mesh).index(name))


def dp_axes(mesh):
    """The data-parallel axes of a mesh (with 'pod' when there is one)."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def fsdp_axes(mesh, *, params_bytes: float = 0.0):
    """FSDP sharding axes: the pod axis folds in for models of 40 GB of
    parameters or more, so the optimizer state fits a device."""
    if "pod" in axis_names(mesh) and params_bytes >= 40e9:
        return ("pod", "data")
    return ("data",)


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the ambient mesh (``shard_hint`` reads it).  Inside,
    a plain tensor met beside a DTensor (positions, masks, constants, the
    schedule's scalars: the same on every rank) counts as replicated
    (``implicit_replication``), as an unsharded array does under a jax
    mesh."""
    from torch.distributed.tensor.experimental import implicit_replication
    _AMBIENT.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh():
    """The ambient mesh, or None."""
    return _AMBIENT[-1] if _AMBIENT else None
