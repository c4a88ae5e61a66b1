"""Fused 3-layer tanh-GELU MLP (the surrogate and world-model stacks):
plain version and the wrapper of the CUDA kernel ``csrc/policy_mlp.cu``.

Replaces the TPU kernel ``repro/kernels/policy_mlp.py`` (``_mlp_kernel``):
``y = gelu(gelu(x @ w1 + b1) @ w2 + b2) @ w3 + b3`` on [B, d_in] rows, x in
float32 or bfloat16, float32 arithmetic, y in x's type.  The search calls
it for inference only (surrogate calibration and MPC rollouts, under
``torch.no_grad()``); training keeps autograd over the plain ops, since
the reference has no backward kernel for this MLP.  A CUDA call that
would need a gradient raises instead of detaching silently.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

MAX_WIDTH = 128   # h1, h2 and d_out the CUDA kernel takes (16 n-tiles of 8)
MAX_D_IN = 256    # d_in the CUDA kernel takes (rows of W1's tensor-map box)

launches = 0   # CUDA launches of the kernel (one per wrapper call on CUDA)

_DTYPES = (torch.float32, torch.bfloat16)


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def fused_mlp_plain(x: torch.Tensor, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """The plain PyTorch version (differentiable, any device)."""
    h = _gelu(x.float() @ w1.float() + b1)
    h = _gelu(h @ w2.float() + b2)
    return (h @ w3.float() + b3).to(x.dtype)


def fused_mlp_cuda(x: torch.Tensor, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Launch the CUDA kernel on ``x``'s device and current stream."""
    global launches
    ws = (w1, b1, w2, b2, w3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x,) + ws):
        raise RuntimeError("fused_mlp: the CUDA kernel has no backward; "
                           "call it under torch.no_grad() or train through "
                           "fused_mlp_plain")
    if x.dim() != 2 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"fused_mlp: x must be a contiguous 2-D float32 or "
                         f"bfloat16 tensor, got {x.dtype} {tuple(x.shape)}")
    b, d_in = x.shape
    h1, h2, d_out = w1.shape[-1], w2.shape[-1], w3.shape[-1]
    if max(h1, h2, d_out) > MAX_WIDTH or d_in > MAX_D_IN:
        raise ValueError(f"fused_mlp: widths {(d_in, h1, h2, d_out)} exceed "
                         f"the kernel's d_in <= {MAX_D_IN}, h1, h2, d_out "
                         f"<= {MAX_WIDTH}")
    if h1 % 4 or h2 % 4:
        raise ValueError(f"fused_mlp: h1 and h2 must be multiples of 4 "
                         f"(16-byte rows of W1 and W2), got {(h1, h2)}")
    shapes = ((d_in, h1), (h1,), (h1, h2), (h2,), (h2, d_out), (d_out,))
    for t, shape in zip(ws, shapes):
        if t.device != x.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fused_mlp: expected contiguous float32 {shape} on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if w1.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("fused_mlp: w1 and w2 must be 16-byte aligned (the "
                         "kernel copies them with tensor copies)")
    if x.dtype == torch.bfloat16 and (d_in % 2 or x.data_ptr() % 4):
        raise ValueError("fused_mlp: a bfloat16 x must be 4-byte aligned "
                         "with an even d_in (the kernel copies bf16 pairs)")
    y = torch.empty((b, d_out), dtype=x.dtype, device=x.device)
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fused_mlp_forward(
        x.data_ptr(), *(t.data_ptr() for t in ws), y.data_ptr(), b, d_in,
        h1, h2, d_out, int(x.dtype == torch.bfloat16), stream)
    build.check(rc, "fused_mlp_forward")
    launches += 1
    return y


def fused_mlp(x: torch.Tensor, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Dispatch on the tensor's device: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor (no fallback between the two)."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cuda":
        return fused_mlp_cuda(x, w1, b1, w2, b2, w3, b3)
    raise ValueError(f"fused_mlp: unsupported device {x.device}")


def mlp(params, x: torch.Tensor, out: str) -> torch.Tensor:
    """The 3-layer stack of a parameter dict with layers ``l1``, ``l2`` and
    ``out`` (``"head"`` for the surrogate, ``"out"`` for the world model)
    over x [..., d_in] -> [..., d_out], through :func:`fused_mlp`."""
    lead = x.shape[:-1]
    y = fused_mlp(x.reshape(-1, x.shape[-1]).contiguous(),
                  params["l1"]["w"], params["l1"]["b"],
                  params["l2"]["w"], params["l2"]["b"],
                  params[out]["w"], params[out]["b"])
    return y.reshape(*lead, y.shape[-1])
