"""PER sum-tree descent (the replay buffer's stratified sample): plain
version and the wrapper of the CUDA kernel ``csrc/sumtree_sample.cu``.

No TPU kernel is replaced: the reference walks its host tree once per
uniform in Python (``SumTree.sample``).  For ``n`` uniforms ``u`` in
[0, 1), sample ``j`` looks up the prefix sum ``(j + u[j]) * tree[1] / n``
and returns its leaf, clamped to ``size - 1``.  The walk compares and
subtracts in float64 in the host's order, so the indices are the host's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0   # CUDA launches of the kernel (one per wrapper call on CUDA)


def descend(tree: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``SumTree.sample`` for every prefix sum in ``v`` [N] float64 at once:
    the leaf index whose prefix sum reaches ``v``, walked level by level
    (at most ``log2(2 * cap)`` steps; a lane that reached a leaf of the
    shallower leaf level stays put)."""
    cap = tree.shape[0] // 2
    i = torch.ones(v.shape, dtype=torch.int64, device=tree.device)
    for _ in range(max(2 * cap - 1, 1).bit_length() - 1):
        inner = i < cap
        two_i = 2 * i
        left = tree[torch.where(inner, two_i, 1)]
        right = inner & (v > left)
        v = torch.where(right, v - left, v)
        i = torch.where(inner, two_i + right, i)
    return i - cap


def sumtree_sample_plain(tree: torch.Tensor, u: torch.Tensor,
                         size: int) -> torch.Tensor:
    """The plain PyTorch version: ``tree`` [2 * cap] float64, ``u`` [N]
    float64; returns the leaf indices [N] int64."""
    n = u.shape[0]
    v = (torch.arange(n, dtype=torch.float64, device=tree.device) + u) \
        * (tree[1] / n)
    return torch.clamp_max(descend(tree, v), size - 1)


def sumtree_sample_cuda(tree: torch.Tensor, u: torch.Tensor,
                        size: int) -> torch.Tensor:
    """Launch the CUDA kernel on ``tree``'s device and current stream."""
    global launches
    dev = tree.device
    if tree.dtype != torch.float64 or tree.dim() != 1 \
            or tree.shape[0] % 2 or not tree.is_contiguous():
        raise ValueError(f"sumtree_sample: tree must be a contiguous float64 "
                         f"[2 * cap] tensor, got {tree.dtype} "
                         f"{tuple(tree.shape)}")
    if u.device != dev or u.dtype != torch.float64 or u.dim() != 1 \
            or not u.is_contiguous():
        raise ValueError(f"sumtree_sample: u must be a contiguous float64 "
                         f"[N] tensor on {dev}, got {u.dtype} "
                         f"{tuple(u.shape)} on {u.device}")
    idx = torch.empty(u.shape, dtype=torch.int64, device=dev)
    if not u.shape[0]:
        return idx
    rc = build.library().sumtree_sample(
        tree.data_ptr(), u.data_ptr(), idx.data_ptr(), u.shape[0],
        tree.shape[0] // 2, int(size),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "sumtree_sample")
    launches += 1
    return idx


def sumtree_sample(tree: torch.Tensor, u: torch.Tensor,
                   size: int) -> torch.Tensor:
    """Dispatch on the tree's device: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor (no fallback between the two)."""
    if tree.device.type == "cpu":
        return sumtree_sample_plain(tree, u, size)
    if tree.device.type == "cuda":
        return sumtree_sample_cuda(tree, u, size)
    raise ValueError(f"sumtree_sample: unsupported device {tree.device}")
