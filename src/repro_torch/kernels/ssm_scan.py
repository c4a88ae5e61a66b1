"""Mamba selective scan: plain version and the wrapper of the CUDA kernel
``csrc/ssm_scan.cu``.

Replaces the TPU kernel ``repro/kernels/ssm_scan.py`` (``_ssm_kernel``)
and computes its oracle's function (``ref.ssm_scan_reference``)::

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = C_t . h_t

dt/x [B,S,D], B/C [B,S,N], A [D,N] and the initial state h0 [B,D,N] (zeros
when omitted) -> (y [B,S,D], h_final [B,D,N]), all float32.  The Pallas
kernel returns y only; the Mamba prefill also needs the final state for its
decode cache, so the port's kernel returns both.  Any S; N <= 16.

Training runs it too: on CUDA tensors that need a gradient,
:func:`ssm_scan` is a ``torch.autograd.Function`` whose forward is the
kernel saving the state before every ``SAVE_EVERY``-th step (the memory
discipline of the reference's remat-chunked scan, ``MAMBA_CHUNK``) and
whose backward is the kernel of ``csrc/ssm_scan_backward.cu``: it
returns d(dt), dB, dC, dx, dA (and dh0), one warp a (channel, state) with
its lanes taking the time steps, the states recomputed from the saved ones
by warp scans in registers (no state in device memory: the wrapper
allocates only the outputs and the per-block dB/dC and per-row dA
partials, sized by :func:`backward_channels_per_block`), and its sums over
states, channels, batch rows and steps taken in a fixed order (repeatable
bits).  :func:`ssm_scan_backward_plain` (autograd over the plain version)
is what it is held against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_STATE = 16   # N the CUDA kernel keeps in registers
SAVE_EVERY = 128   # steps between the states a forward for training saves

launches = 0   # CUDA launches of the kernel (one per wrapper call on CUDA)
backward_launches = 0   # CUDA launches of the backward kernel


def ssm_scan_plain(dt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
                   x: torch.Tensor, a: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: a loop over S, any device, in float32
    (float64 inputs stay float64: the yardstick of both versions' float32
    rounding)."""
    B, S, D = x.shape
    ft = torch.promote_types(x.dtype, torch.float32)
    h = torch.zeros((B, D, a.shape[1]), dtype=ft, device=x.device) \
        if h0 is None else h0.to(ft)
    dt, b_in, c_in, x = (t.to(ft) for t in (dt, b_in, c_in, x))
    ys = []
    for t in range(S):
        dt_t = dt[:, t]
        decay = torch.exp(dt_t[..., None] * a)
        h = decay * h + (dt_t * x[:, t])[..., None] * b_in[:, t, None, :]
        ys.append((h * c_in[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1), h


def _check(ins, x, name):
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B,S,D], got {tuple(x.shape)}")
    B, S, D = x.shape
    N = ins[4].shape[-1]
    shapes = [(B, S, D), (B, S, N), (B, S, N), (B, S, D), (D, N), (B, D, N),
              (B, D, N)]
    for t, shape in zip(ins, shapes):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous float32 {shape} on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"{name}: N = {N}; the kernel takes 1..{MAX_STATE}")
    return B, S, D, N


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _forward_cuda(dt, b_in, c_in, x, a, h0, save_chunks):
    """Launch the forward kernel; returns (y, h_final, saved states or
    None)."""
    global launches
    B, S, D, N = _check((dt, b_in, c_in, x, a, h0), x, "ssm_scan")
    y = torch.empty((B, S, D), dtype=torch.float32, device=x.device)
    h_out = torch.empty((B, D, N), dtype=torch.float32, device=x.device)
    h_chunks = torch.empty((B, -(-S // SAVE_EVERY), D, N),
                           dtype=torch.float32, device=x.device) \
        if save_chunks else None
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ssm_scan_forward(
        dt.data_ptr(), b_in.data_ptr(), c_in.data_ptr(), x.data_ptr(),
        a.data_ptr(), _ptr(h0), y.data_ptr(), h_out.data_ptr(),
        _ptr(h_chunks), B, S, D, N, stream)
    build.check(rc, "ssm_scan_forward")
    launches += 1
    return y, h_out, h_chunks


def ssm_scan_cuda(dt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
                  x: torch.Tensor, a: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on x's device and current stream.  Inputs
    that need a gradient go through :func:`ssm_scan` (the autograd
    Function); here they raise."""
    ins = (dt, b_in, c_in, x, a) + (() if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise RuntimeError("ssm_scan_cuda: inputs need a gradient; call "
                           "ssm_scan, whose backward is a kernel")
    return _forward_cuda(dt, b_in, c_in, x, a, h0, False)[:2]


def backward_channels_per_block(B: int, D: int, sms: int) -> int:
    """Channels a block of the backward kernel walks: a multiple of 8 (a
    stage's 32-byte rows), as few as give about one block per SM (one
    block of 32 N threads fills an SM), at most 256 (shared memory).  The
    dB/dC partials are B ceil(D / cpb) 2 N S floats."""
    return min(256, 8 * -(-B * D // (8 * sms)))


def ssm_scan_backward_cuda(dt, b_in, c_in, x, a, h_chunks, dy, dh=None,
                           h0_given=False):
    """Launch the backward kernel from the forward's inputs, its saved
    states ``h_chunks`` and the gradients of y (``dy``) and of h_final
    (``dh``, or None); returns (d(dt), dB, dC, dx, dA, dh0 or None)."""
    global backward_launches
    dy = dy.float().contiguous()
    dh = None if dh is None else dh.float().contiguous()
    B, S, D, N = _check((dt, b_in, c_in, x, a, None, dh), x,
                        "ssm_scan_backward")
    if dy.shape != (B, S, D) or h_chunks.shape != (
            B, -(-S // SAVE_EVERY), D, N):
        raise ValueError("ssm_scan_backward: dy or the saved states have "
                         "the wrong shape")
    cpb = backward_channels_per_block(
        B, D, torch.cuda.get_device_properties(x.device).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=x.device)
    part_bc = torch.empty((B, -(-D // cpb), 2, N, S), **f32)
    part_a = torch.empty((B, D, N), **f32)
    ddt, dx = torch.empty((B, S, D), **f32), torch.empty((B, S, D), **f32)
    db, dc = torch.empty((B, S, N), **f32), torch.empty((B, S, N), **f32)
    da = torch.empty((D, N), **f32)
    dh0 = torch.empty((B, D, N), **f32) if h0_given else None
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ssm_scan_backward(
        dt.data_ptr(), b_in.data_ptr(), c_in.data_ptr(), x.data_ptr(),
        a.data_ptr(), h_chunks.data_ptr(), dy.data_ptr(), _ptr(dh),
        part_bc.data_ptr(), part_a.data_ptr(), ddt.data_ptr(), db.data_ptr(),
        dc.data_ptr(), dx.data_ptr(), da.data_ptr(), _ptr(dh0), B, S, D, N,
        cpb, stream)
    build.check(rc, "ssm_scan_backward")
    backward_launches += 1
    return ddt, db, dc, dx, da, dh0


def ssm_scan_backward_plain(dt, b_in, c_in, x, a, h0=None, dy=None,
                            dh=None):
    """The plain version of the backward: autograd over
    :func:`ssm_scan_plain`; returns (d(dt), dB, dC, dx, dA, dh0 or None)
    for the gradients ``dy`` of y and ``dh`` of h_final (None: zero)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (dt, b_in, c_in, x, a)]
        h = None if h0 is None else h0.detach().requires_grad_(True)
        y, h_final = ssm_scan_plain(*leaves, h)
        outs, grads = [y], [dy]
        if dh is not None:
            outs.append(h_final)
            grads.append(dh)
        got = torch.autograd.grad(outs, leaves + ([] if h is None else [h]),
                                  grads)
    return tuple(got) + ((None,) if h is None else ())


class _SSMScan(torch.autograd.Function):
    """The forward kernel, with the chunk-boundary states saved, and the
    backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, dt, b_in, c_in, x, a, h0):
        y, h_final, h_chunks = _forward_cuda(dt, b_in, c_in, x, a, h0, True)
        ctx.save_for_backward(dt, b_in, c_in, x, a, h_chunks)
        ctx.h0_given = h0 is not None
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh):
        dt, b_in, c_in, x, a, h_chunks = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return ssm_scan_backward_cuda(dt, b_in, c_in, x, a, h_chunks, dy, dh,
                                      ctx.h0_given)


def ssm_scan(dt: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
             x: torch.Tensor, a: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on the tensor's device: the plain version for a CPU tensor
    (autograd differentiates it), the CUDA kernel for a CUDA tensor, and
    for CUDA tensors that need a gradient the autograd Function whose
    backward is the backward kernel (no fallback between any of them)."""
    if x.device.type == "cpu":
        return ssm_scan_plain(dt, b_in, c_in, x, a, h0)
    if x.device.type == "cuda":
        ins = (dt, b_in, c_in, x, a) + (() if h0 is None else (h0,))
        if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
            return _SSMScan.apply(dt, b_in, c_in, x, a, h0)
        return ssm_scan_cuda(dt, b_in, c_in, x, a, h0)
    raise ValueError(f"ssm_scan: unsupported device {x.device}")
