"""Base layers of the LM model zoo (port of ``repro.models.layers``).

Conventions, as in the reference:
  * parameters are nested dicts of tensors; init functions take a
    ``torch.Generator`` and return the dict, apply functions are plain;
  * ``lead`` is the shape of leading dimensions an init stacks its leaves
    over (the model's periods, see ``repro_torch.models.lm``), drawn as one
    tensor where the reference ``vmap``s one init per period;
  * compute runs in the parameters' type (bf16/fp16/fp32); norms, RoPE and
    the SiLU of SwiGLU run in float32 and cast back.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """N(0, 1) * scale in float32 on the generator's device, cast to dtype."""
    x = torch.randn(shape, generator=gen, device=gen.device)
    return x.mul_(scale).to(dtype)


def linear_init(gen, n_in: int, n_out: int, dtype, *, bias: bool = False,
                scale: Optional[float] = None, lead: Tuple[int, ...] = ()
                ) -> Dict:
    scale = scale if scale is not None else (1.0 / np.sqrt(n_in))
    p = dict(w=normal(gen, lead + (n_in, n_out), scale, dtype))
    if bias:
        p["b"] = torch.zeros(lead + (n_out,), dtype=dtype, device=gen.device)
    return p


def linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)`` with JAX's type promotion (f32 @ bf16 -> f32)."""
    w = p["w"]
    dt = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dt) @ w.to(dt)
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype, device, lead: Tuple[int, ...] = ()) -> Dict:
    return dict(scale=torch.ones(lead + (d,), dtype=dtype, device=device))


def rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def embed_init(gen, vocab: int, d: int, dtype) -> Dict:
    return dict(w=normal(gen, (vocab, d), 0.02, dtype))


def embed(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["w"][tokens]


# ------------------------------------------------------------------- RoPE --
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device
                   ) -> torch.Tensor:
    """:func:`rope_freqs` as float32 on ``device``, copied there once (a
    copy from a numpy array per call would synchronise with the card)."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., T, H, hd]; positions: [..., T] (int)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)
    ang = positions[..., :, None].float() * freqs      # [..., T, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.float()).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form) in float32, cast back."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Einsum with float32 accumulation.  Half-precision operands are cast
    to float32 first: the product of two bf16 or fp16 numbers is exact in
    float32, so only the order of the sum differs from a tensor-core
    product that accumulates in float32."""
    return torch.einsum(eq, a.float(), b.float())


def token_losses(logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """Per-token cross-entropy; logits [..., V] (any float type), labels
    int.  As the reference: float32 logits, logsumexp minus the gold logit
    taken as a masked reduction (iota == label), not a gather."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    onehot = labels[..., None] == torch.arange(logits.shape[-1],
                                               device=logits.device)
    return logz - torch.where(onehot, logits, 0.0).sum(-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy (``repro.models.layers.cross_entropy``)."""
    return torch.mean(token_losses(logits, labels))
