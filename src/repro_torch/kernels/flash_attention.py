"""Blocked online-softmax attention with GQA, causal masks and sliding
windows: plain version and the wrapper of the CUDA kernel
``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel``): q [B,H,Sq,hd], k/v [B,Hk,Sk,hd] (query head h reads KV
head h * Hk // H) in float32, float16 or bfloat16; float32 scores and sums;
masked scores are -1e30; the output is in q's type.  Unlike the Pallas
kernel it takes any Sq and Sk.  float16 and bfloat16 run a tensor-core
kernel, which rounds the probabilities to q's type before P @ V (as
PyTorch's fused attention does); float32 runs a kernel on the same tensor
cores in 3xTF32 (each product as three TF32 products, for fp32's
accuracy).  The LM
prefill runs every attention layer through it
(``repro_torch.models.attention.chunked_attention``).

Training runs it too: on a CUDA tensor that needs a gradient,
:func:`flash_attention` is a ``torch.autograd.Function`` whose forward is
the kernel with its base-2 log-sum-exp output and whose backward is the
kernel of ``csrc/flash_attention_backward.cu`` (dq, dk, dv on the same
tensor cores: fp16/bf16 products with fp32 sums, fp32 as 3xTF32; no
atomics: repeatable bits).  The JAX package has no backward
kernel; XLA differentiates its jnp attention, and
:func:`flash_attention_backward_plain` (autograd over the plain version)
is what the backward kernel is held against.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# the kernels' widest zero-padded head
MAX_HEAD_DIM = 128

launches = 0   # CUDA launches of the kernel (one per wrapper call on CUDA)
backward_launches = 0   # CUDA launches of the backward kernel

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0
                          ) -> torch.Tensor:
    """The plain PyTorch version (``ref.attention_reference``): the whole
    [Sq, Sk] score matrix in float32, any device."""
    B, H, Sq, hd = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    k = torch.repeat_interleave(k, H // Hk, dim=1)
    v = torch.repeat_interleave(v, H // Hk, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (hd ** 0.5)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _check(q, k, v, name="flash_attention"):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: expected q [B,H,Sq,hd] and k/v "
                         f"[B,Hk,Sk,hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Hk or not Sq or not Sk \
            or hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)} (need H % Hk == 0, Sq and Sk > 0,"
                         f" hd <= {MAX_HEAD_DIM})")
    for t in (q, k, v):
        if t.dtype not in _DTYPES or t.dtype != q.dtype \
                or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(
                f"{name}: q, k and v must share a float type and a "
                f"device and have a contiguous last dimension, got "
                f"{t.dtype} on {t.device} with strides {t.stride()}")


def _forward_cuda(q, k, v, causal, window, with_lse):
    """Launch the forward kernel; returns (o, lse or None)."""
    global launches
    _check(q, k, v)
    B, H, Sq, hd = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)   # q's layout (a transposed view stays one)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, Hk,
        Sq, Sk, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(causal), int(window), 1.0 / math.sqrt(hd),
        _DTYPES[q.dtype], stream)
    build.check(rc, "flash_attention_forward")
    launches += 1
    return out, lse


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on q's device and current stream.  Inputs may
    be strided views (the innermost dimension contiguous); the output has
    q's layout.  Inputs that need a gradient go through :func:`flash_attention`
    (the autograd Function); here they raise."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_cuda: inputs need a gradient; "
                           "call flash_attention, whose backward is a kernel")
    return _forward_cuda(q, k, v, causal, window, False)[0]


def flash_attention_backward_cuda(q, k, v, o, lse, do, *, causal=True,
                                  window=0):
    """Launch the backward kernel: (dq, dk, dv) in the inputs' type and
    layouts, from the forward's inputs, output and base-2 log-sum-exp
    ``lse`` [B,H,Sq] and the output's gradient ``do``."""
    global backward_launches
    _check(q, k, v, "flash_attention_backward")
    do = do.to(q.dtype)
    if do.stride(-1) != 1:
        do = do.contiguous()
    B, H, Sq, hd = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    for name, t, shape in (("o", o, q.shape), ("do", do, q.shape)):
        if t.shape != shape or t.dtype != q.dtype or t.device != q.device \
                or t.stride(-1) != 1:
            raise ValueError(f"flash_attention_backward: {name} must be "
                             f"{tuple(shape)} {q.dtype} on {q.device} with a "
                             f"contiguous last dimension")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("flash_attention_backward: lse must be a contiguous "
                         f"float32 {(B, H, Sq)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = [s_ for t in (q, k, v, o, do, dq, dk, dv) for s_ in t.stride()[:3]]
    arr = (ctypes.c_longlong * len(strides))(*strides)
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ctypes.addressof(arr), B, H, Hk, Sq, Sk, hd,
        int(causal), int(window), 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
        stream)
    build.check(rc, "flash_attention_backward")
    backward_launches += 1
    return dq, dk, dv


def flash_attention_backward_plain(q, k, v, do, *, causal=True, window=0):
    """The plain version of the backward: autograd over
    :func:`flash_attention_plain`; returns (dq, dk, dv)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention_plain(*leaves, causal=causal, window=window)
        return torch.autograd.grad(o, leaves, do)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, with its log-sum-exp saved, and the backward
    kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = _forward_cuda(q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_cuda(
            q, k, v, o, lse, do, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Dispatch on the tensor's device: the plain version for a CPU tensor
    (autograd differentiates it), the CUDA kernel for a CUDA tensor, and
    for a CUDA tensor that needs a gradient the autograd Function whose
    backward is the backward kernel (no fallback between any of them)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return _FlashAttention.apply(q, k, v, causal, window)
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
