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

:func:`flash_attention` is the operator ``repro_torch::flash_attention``
(``torch.library.custom_op``).  Training runs it too: for inputs that need
a gradient its forward is the kernel with its base-2 log-sum-exp output
and its autograd formula the operator ``repro_torch::flash_attention_
backward``, the kernel of ``csrc/flash_attention_backward.cu`` (dq, dk, dv
on the same tensor cores: fp16/bf16 products with fp32 sums, fp32 as
3xTF32; no atomics: repeatable bits).  Both operators have fake
implementations (shapes only) and DTensor sharding rules (batch split, or
heads split alike for q and k/v when the KV heads divide), so a sharded
model runs the kernels on its local shards and the dry-run traces them.
The JAX package has no backward kernel; XLA differentiates its jnp
attention, and :func:`flash_attention_backward_plain` (the plain version's
gradient, written out) is what the backward kernel is held against.
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


def _mask(Sq: int, Sk: int, causal: bool, window: int, device
          ) -> torch.Tensor:
    """[Sq, Sk]: the keys each query sees."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    return mask


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
    s = s.masked_fill(~_mask(Sq, Sk, causal, window, q.device), NEG_INF)
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
    q's layout.  Inputs that need a gradient go through
    :func:`flash_attention` (the operator); here they raise."""
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
    """The plain version of the backward: the gradient of
    :func:`flash_attention_plain` written out in float32 (dV = P^T dO,
    dS = P (dP - rowsum(dP P)) on the unmasked scores, dQ = dS K / sqrt(hd),
    dK = dS^T Q / sqrt(hd), each KV head's summed over its query heads),
    without autograd, so that it also runs inside an operator's
    implementation below DTensor's dispatch; returns (dq, dk, dv)."""
    B, H, Sq, hd = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    r = H // Hk
    kf, vf = (torch.repeat_interleave(t.float(), r, dim=1) for t in (k, v))
    qf, dof = q.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / (hd ** 0.5)
    keep = _mask(Sq, Sk, causal, window, q.device)
    p = torch.softmax(s.masked_fill(~keep, NEG_INF), dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).masked_fill(~keep, 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) / (hd ** 0.5)
    group = lambda t: t.reshape(B, Hk, r, Sk, t.shape[-1]).sum(2)
    dk = group(torch.einsum("bhqk,bhqd->bhkd", ds, qf) / (hd ** 0.5))
    dv = group(torch.einsum("bhqk,bhqd->bhkd", p, dof))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _plain_with_lse(q, k, v, causal, window, with_lse):
    """The plain version, in q's layout as the kernel writes it, and, when
    asked, the base-2 log-sum-exp of the scaled scores the CUDA kernel
    writes; [B,H,0] when not asked."""
    o = torch.empty_like(q).copy_(
        flash_attention_plain(q, k, v, causal=causal, window=window))
    B, H, Sq, hd = q.shape
    if not with_lse:
        return o, q.new_empty((B, H, 0), dtype=torch.float32)
    kk = torch.repeat_interleave(k, H // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) / (hd ** 0.5)
    s = s.masked_fill(~_mask(Sq, k.shape[2], causal, window, q.device),
                      NEG_INF)
    return o, torch.logsumexp(s, dim=-1) / math.log(2.0)


# The kernels as PyTorch operators: the CUDA implementation launches the
# kernel, the CPU one runs the plain version, a fake one gives the shapes
# (FakeTensorMode and the dry-run trace through it), the autograd formula
# is the backward operator (the backward kernel on CUDA, the plain
# version's gradient on the CPU) and the sharding rules say which DTensor
# placements each takes.
@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, window: int, with_lse: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return _plain_with_lse(q, k, v, causal, window, with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    o, lse = _forward_cuda(q, k, v, causal, window, with_lse)
    return o, lse if with_lse else q.new_empty(
        (q.shape[0], q.shape[1], 0), dtype=torch.float32)


@attention_op.register_fake
def _(q, k, v, causal, window, with_lse):
    B, H, Sq, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, Sq if with_lse else 0),
                                            dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=())
def attention_backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, lse: torch.Tensor,
                          do: torch.Tensor, causal: bool, window: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, do, causal=causal,
                                              window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_backward_cuda(q, k, v, o, lse, do, causal=causal,
                                         window=window)


@attention_backward_op.register_fake
def _(q, k, v, o, lse, do, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _save(ctx, inputs, output):
    q, k, v, ctx.causal, ctx.window, _ = inputs
    ctx.save_for_backward(q, k, v, *output)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    return (*attention_backward_op(q, k, v, o, lse, do, ctx.causal,
                                   ctx.window), None, None, None)


attention_op.register_autograd(_backward, setup_context=_save)


def _head_shardable(k, mesh) -> bool:
    """Whether the KV heads may be split over any mesh dimensions that a
    placement could pick: every product of mesh sizes that DTensor would
    not refuse as too many shards must divide Hk, so that local query head
    h still reads local KV head h * Hk // H."""
    hk, sizes = k.shape[1], [s for s in mesh.shape if s > 1]
    prods = {1}
    for s_ in sizes:
        prods |= {p * s_ for p in prods}
    return all(hk % p == 0 for p in prods if p <= hk)


def sharding_strategies(n_out: int, n_tensor_in: int, k_spec, extra: int):
    """One mesh dimension's choices for the attention operators: all
    replicated, the batch split, or (when :func:`_head_shardable`) the
    heads split, alike for q, k, v and every output; ``extra`` trailing
    non-tensor arguments."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in [Replicate(), Shard(0)] + (
            [Shard(1)] if _head_shardable(k_spec.tensor_meta,
                                          k_spec.mesh) else []):
        out.append(([p] * n_out, [p] * n_tensor_in + [None] * extra))
    return out


def _register_sharding():
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _(q, k, v, causal, window, with_lse):
        return sharding_strategies(2, 3, k, 3)

    @register_sharding(torch.ops.repro_torch.flash_attention_backward.default)
    def _(q, k, v, o, lse, do, causal, window):
        return sharding_strategies(3, 6, k, 2)


_register_sharding()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """The ``repro_torch::flash_attention`` operator: the plain version for
    a CPU tensor, the CUDA kernel for a CUDA tensor (no fallback between
    them), the backward kernel (or the plain version's gradient on the
    CPU) for inputs that need a gradient, and on DTensors the local shards
    of whichever placement :func:`sharding_strategies` allows."""
    with_lse = torch.is_grad_enabled() and any(t.requires_grad
                                               for t in (q, k, v))
    return attention_op(q, k, v, bool(causal), int(window), with_lse)[0]
