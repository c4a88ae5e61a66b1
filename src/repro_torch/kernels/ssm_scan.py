"""Mamba selective scan: plain version and the wrapper of the CUDA kernel
``csrc/ssm_scan.cu``.

Replaces the TPU kernel ``repro/kernels/ssm_scan.py`` (``_ssm_kernel``)
and computes its oracle's function (``ref.ssm_scan_reference``)::

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = C_t . h_t

dt/x [B,S,D], B/C [B,S,N], A [D,N] and the initial state h0 [B,D,N] (zeros
when omitted) -> (y [B,S,D], h_final [B,D,N]), all float32.  The Pallas
kernel returns y only; the Mamba prefill also needs the final state for its
decode cache, so the port's kernel returns both.  Any S; N <= 16.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_STATE = 16   # N the CUDA kernel keeps in registers

launches = 0   # CUDA launches of the kernel (one per wrapper call on CUDA)


def ssm_scan_plain(dt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
                   x: torch.Tensor, a: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: a loop over S, any device."""
    B, S, D = x.shape
    h = torch.zeros((B, D, a.shape[1]), dtype=torch.float32,
                    device=x.device) if h0 is None else h0.float()
    dt, b_in, c_in, x = dt.float(), b_in.float(), c_in.float(), x.float()
    ys = []
    for t in range(S):
        dt_t = dt[:, t]
        decay = torch.exp(dt_t[..., None] * a)
        h = decay * h + (dt_t * x[:, t])[..., None] * b_in[:, t, None, :]
        ys.append((h * c_in[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1), h


def ssm_scan_cuda(dt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
                  x: torch.Tensor, a: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on x's device and current stream."""
    global launches
    ins = (dt, b_in, c_in, x, a) + (() if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise RuntimeError("ssm_scan: the CUDA kernel has no backward")
    if x.dim() != 3:
        raise ValueError(f"ssm_scan: x must be [B,S,D], got {tuple(x.shape)}")
    B, S, D = x.shape
    N = a.shape[-1]
    shapes = [(B, S, D), (B, S, N), (B, S, N), (B, S, D), (D, N)] \
        + ([] if h0 is None else [(B, D, N)])
    for t, shape in zip(ins, shapes):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"ssm_scan: expected contiguous float32 {shape} on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssm_scan: N = {N}; the kernel takes 1..{MAX_STATE}")
    y = torch.empty((B, S, D), dtype=torch.float32, device=x.device)
    h_out = torch.empty((B, D, N), dtype=torch.float32, device=x.device)
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ssm_scan_forward(
        dt.data_ptr(), b_in.data_ptr(), c_in.data_ptr(), x.data_ptr(),
        a.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_out.data_ptr(), B, S, D, N, stream)
    build.check(rc, "ssm_scan_forward")
    launches += 1
    return y, h_out


def ssm_scan(dt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
             x: torch.Tensor, a: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on the tensor's device: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor (no fallback between the two)."""
    if x.device.type == "cpu":
        return ssm_scan_plain(dt, b_in, c_in, x, a, h0)
    if x.device.type == "cuda":
        return ssm_scan_cuda(dt, b_in, c_in, x, a, h0)
    raise ValueError(f"ssm_scan: unsupported device {x.device}")
