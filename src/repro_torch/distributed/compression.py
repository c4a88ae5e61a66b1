"""Gradient compression for the data-parallel all-reduce (port of
``repro.distributed.compression``).

Int8 uniform quantization with error feedback (EF-SGD style): each rank
quantizes (grad + residual) to int8 with a per-tensor scale, all-reduces
the int8 payload (8/32 of the float32 bytes on the wire, summed as int32),
dequantizes, and keeps the quantization error as the next step's
residual: unbiased in the limit and convergent under the standard EF
assumptions.

``compress``/``decompress`` are the array-level pieces, bitwise the
reference's (round half to even, float32 throughout);
``compressed_psum`` is the collective, over a ``torch.distributed`` group
where the reference runs ``psum``/``pmax`` inside ``shard_map``: a MAX
``all_reduce`` of the scale, a SUM ``all_reduce`` of the int32 payload,
then division by the group's size.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adam import tree_map


def _scale(xf: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(xf.abs().max(), 1e-12) / 127.0


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def compress(x: torch.Tensor, residual: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (int8 payload, scale, new residual)."""
    xf = x.float() + residual
    scale = _scale(xf)
    q = _quantize(xf, scale)
    return q, scale, xf - q.float() * scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads: Any, residuals: Any, group=None
                    ) -> Tuple[Any, Any]:
    """Error-feedback int8 all-reduce over ``group`` (None: the default
    group).  Returns (mean-reduced grads in their own types, new float32
    residuals).  Wire bytes: a quarter of float32's for the payload (int8;
    summed as int32 here, the reference's ``psum`` of its int32 cast) and
    one scalar scale a tensor."""
    n = dist.get_world_size(group)

    def one(g, r):
        xf = g.float() + r
        # one scale across ranks (a MAX all-reduce), so that the int8
        # payloads are commensurable before the integer sum
        scale = _scale(xf)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = _quantize(xf, scale)
        new_r = xf - q.float() * scale
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return (total.float() * scale / n).to(g.dtype), new_r

    out = tree_map(one, grads, residuals)
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), pick(1)


def init_residuals(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
