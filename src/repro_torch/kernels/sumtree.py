"""PER sum-tree multi-leaf set (the replay buffer's write path): plain
version and the wrapper of the CUDA kernel ``csrc/sumtree.cu``.

Replaces the TPU kernel ``repro/kernels/sumtree.py``
(``_set_many_kernel``).  Computes ``SumTree.set_many`` of
``repro_torch.core.replay`` on a float64 tree held as a tensor, in place:
the leaves ``cap + idx`` take ``values`` (a scalar broadcasts), duplicate
indices are last-write-wins, and every ancestor of a written leaf becomes
the sum of its two final children.  Each node is one float64 addition of
final children, so kernel, plain version and host oracle agree bitwise.
The TPU kernel kept a float32 tree (JAX's default type); the search's
tree is the host's float64, and so is this one.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels import build

MAX_N = 1024   # writes per kernel launch; the wrapper splits larger ones

launches = 0   # CUDA launches of the kernel (one per launch on CUDA)

Values = Union[float, torch.Tensor]


def sumtree_set_many_plain(tree: torch.Tensor, idx: torch.Tensor,
                           values: Values) -> torch.Tensor:
    """The plain PyTorch version: the host ``SumTree.set_many`` band loop
    in torch ops, in place on ``tree`` [2 * cap] float64; returns ``tree``.
    ``idx`` [N] int; ``values`` a scalar or [N]."""
    cap = tree.shape[0] // 2
    idx = idx.to(device=tree.device, dtype=torch.int64)
    vals = torch.as_tensor(values, dtype=tree.dtype, device=tree.device)
    vals = vals.expand(idx.shape)
    # last write wins: keep each index's last position
    uniq, inv = torch.unique(idx, return_inverse=True)
    last = torch.full(uniq.shape, -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, inv, torch.arange(idx.numel(),
                                                    device=idx.device),
                               reduce="amax")
    tree[uniq + cap] = vals[last]
    i = torch.unique(torch.div(uniq + cap, 2, rounding_mode="floor"))
    i = i[i >= 1]
    while i.numel():
        tree[i] = tree[2 * i] + tree[2 * i + 1]
        i = torch.unique(torch.div(i, 2, rounding_mode="floor"))
        i = i[i >= 1]
    return tree


def sumtree_set_many_cuda(tree: torch.Tensor, idx: torch.Tensor,
                          values: Values) -> torch.Tensor:
    """Launch the CUDA kernel on ``tree``'s device and current stream, in
    place; returns ``tree``."""
    global launches
    dev = tree.device
    if tree.dtype != torch.float64 or tree.dim() != 1 \
            or tree.shape[0] % 2 or not tree.is_contiguous():
        raise ValueError(f"sumtree: tree must be a contiguous float64 "
                         f"[2 * cap] tensor, got {tree.dtype} "
                         f"{tuple(tree.shape)}")
    if idx.device != dev or idx.dtype != torch.int64 or idx.dim() != 1 \
            or not idx.is_contiguous():
        raise ValueError(f"sumtree: idx must be a contiguous int64 [N] "
                         f"tensor on {dev}, got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")
    vals = None
    scalar = 0.0
    if isinstance(values, torch.Tensor) and values.dim() > 0:
        if values.device != dev or values.dtype != torch.float64 \
                or tuple(values.shape) != tuple(idx.shape) \
                or not values.is_contiguous():
            raise ValueError(
                f"sumtree: values must be a scalar or a contiguous float64 "
                f"{tuple(idx.shape)} tensor on {dev}, got {values.dtype} "
                f"{tuple(values.shape)} on {values.device}")
        vals = values
    else:
        scalar = float(values)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cap = tree.shape[0] // 2
    for lo in range(0, idx.shape[0], MAX_N):
        hi = min(lo + MAX_N, idx.shape[0])
        rc = lib.sumtree_set_many(
            tree.data_ptr(), idx[lo:hi].data_ptr(),
            None if vals is None else vals[lo:hi].data_ptr(), scalar,
            hi - lo, cap, stream)
        build.check(rc, "sumtree_set_many")
        launches += 1
    return tree


def sumtree_set_many(tree: torch.Tensor, idx: torch.Tensor,
                     values: Values) -> torch.Tensor:
    """Dispatch on the tree's device: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor (no fallback between the two)."""
    if tree.device.type == "cpu":
        return sumtree_set_many_plain(tree, idx, values)
    if tree.device.type == "cuda":
        return sumtree_set_many_cuda(tree, idx, values)
    raise ValueError(f"sumtree: unsupported device {tree.device}")
