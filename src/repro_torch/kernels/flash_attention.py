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
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# the kernels' widest zero-padded head
MAX_HEAD_DIM = 128

launches = 0   # CUDA launches of the kernel (one per wrapper call on CUDA)

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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on q's device and current stream.  Inputs may
    be strided views (the innermost dimension contiguous); the output has
    q's layout."""
    global launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the CUDA kernel has no backward")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: expected q [B,H,Sq,hd] and k/v "
                         f"[B,Hk,Sk,hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Hk or not Sq or not Sk \
            or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)} (need H % Hk == 0, Sq and Sk > 0,"
                         f" hd <= {MAX_HEAD_DIM})")
    for t in (q, k, v):
        if t.dtype not in _DTYPES or t.dtype != q.dtype \
                or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(
                f"flash_attention: q, k and v must share a float type and a "
                f"device and have a contiguous last dimension, got "
                f"{t.dtype} on {t.device} with strides {t.stride()}")
    out = torch.empty_like(q)   # q's layout (a transposed view stays one)
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hk,
        Sq, Sk, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(causal), int(window), 1.0 / math.sqrt(hd),
        _DTYPES[q.dtype], stream)
    build.check(rc, "flash_attention_forward")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Dispatch on the tensor's device: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor (no fallback between the two)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
