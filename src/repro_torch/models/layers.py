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
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import placements
from repro_torch.launch.mesh import current_mesh

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


def _gather_inner(x: DTensor) -> DTensor:
    """``x`` with every mesh axis that splits one of its inner dimensions
    (neither the first nor the last) gathered."""
    n = x.dim()
    inner = lambda p: p.is_shard() and 0 < p.dim % n < n - 1
    if not any(inner(p) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if inner(p) else p
                                          for p in x.placements])


def _reduce_partial(t: DTensor, place=None) -> DTensor:
    """``t`` with its partial sums reduced: to ``place`` when given (a
    parameter's gradient, reduce-scattered to the parameter's placements),
    else each partial axis replicated."""
    if not any(p.is_partial() for p in t.placements):
        return t
    if place is None:
        place = [Replicate() if p.is_partial() else p for p in t.placements]
    return t.redistribute(t.device_mesh, place)


class _Matmul(torch.autograd.Function):
    """``x @ w`` for a DTensor x [..., d] and w [d, f]: the product's rows
    flattened from x's leading dimensions after :func:`_gather_inner`, and
    its partial sums (a contraction over a split dimension) reduced at
    once, in the product and in its gradient.  Older torch versions can
    neither flatten a split inner dimension nor turn a split tensor into a
    partial one, which an operator meeting both would need."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _reduce_partial(_gather_inner(x) @ w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = _gather_inner(g)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _reduce_partial(g @ w.t())
        if ctx.needs_input_grad[1]:
            d, f = w.shape
            gw = _reduce_partial(
                _gather_inner(x).reshape(-1, d).t() @ g.reshape(-1, f),
                w.placements)
        return gx, gw


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (w a matrix).  For a DTensor ``x`` the product of
    :class:`_Matmul`: inner dimensions of x that are split (the sequence,
    over "model" at each period's start) are gathered first, as a
    column-parallel product after sequence parallelism does, and partial
    sums are reduced where they arise."""
    if isinstance(x, DTensor) and w.dim() == 2:
        return _Matmul.apply(x, w)
    return x @ w


def linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)`` with JAX's type promotion (f32 @ bf16 -> f32)."""
    w = p["w"]
    dt = torch.promote_types(x.dtype, w.dtype)
    y = matmul(x.to(dt), w.to(dt))
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
    if isinstance(tokens, DTensor):
        # the gather's gradient (an indexed accumulate) has a sound DTensor
        # rule only for replicated indices in every torch version
        tokens = tokens.redistribute(tokens.device_mesh,
                                     [Replicate()] * tokens.device_mesh.ndim)
    return p["w"][tokens]


def shard_hint(x: torch.Tensor, *axes) -> torch.Tensor:
    """Redistribute ``x`` to the hinted placements (the reference's
    ``with_sharding_constraint`` hint) when an ambient mesh is set
    (``repro_torch.launch.mesh.mesh_context``) and ``x`` is a DTensor; a
    no-op otherwise (one device, plain tensors).

    Axis tokens: mesh axis names, "__dp__" (("pod", "data") when the mesh
    has a pod axis, else "data"), or None; an axis the mesh lacks, or
    whose size does not divide the dimension, leaves that dimension
    replicated, as in the reference, and so does an axis of size 1."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    # an axis of size 1 shards nothing: left out, as an axis the mesh lacks
    names = {a for i, a in enumerate(mesh.mesh_dim_names) if mesh.size(i) > 1}
    spec = []
    for dim, ax in zip(x.shape, axes):
        if ax == "__dp__":
            ax = tuple(a for a in ("pod", "data") if a in names) or None
        if ax is None:
            spec.append(None)
            continue
        axt = (ax,) if isinstance(ax, str) else tuple(ax)
        if not all(a in names for a in axt):
            spec.append(None)
            continue
        size = 1
        for a in axt:
            size *= mesh.size(mesh.mesh_dim_names.index(a))
        spec.append(ax if dim % size == 0 else None)
    return x.redistribute(x.device_mesh, placements(tuple(spec), mesh))


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A weight with its shards over every mesh axis but "model" gathered
    (the FSDP axes), when an ambient mesh is set and ``w`` is a DTensor: a
    loop that reads it many times then gathers it once, as the reference's
    compiled loop does.  A no-op otherwise."""
    mesh = current_mesh()
    if mesh is None or not isinstance(w, DTensor):
        return w
    keep = [p if name == "model" else Replicate()
            for name, p in zip(mesh.mesh_dim_names, w.placements)]
    return w.redistribute(w.device_mesh, keep)


def remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward (the
    reference's ``jax.checkpoint``): autograd keeps ``args`` and what
    ``fn`` closes over, and runs ``fn`` again where its backward needs a
    saved tensor.  A plain call where autograd records nothing.  Tensors
    ``fn`` should not keep alive across the forward go in ``args``: the
    recomputation of an enclosing ``remat`` makes them again."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def contiguous(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a contiguous layout.  A DTensor's ``contiguous()`` reads
    its global strides, which need not be its local tensor's (a
    redistributed transposed view comes back dense in the view's order), so
    its local tensor is copied into the contiguous layout outright."""
    if isinstance(x, DTensor):
        return x.clone(memory_format=torch.contiguous_format)
    return x.contiguous()


def _reshape_dtensor(x: DTensor, shape) -> DTensor:
    for _ in range(3):
        try:
            return x.reshape(*shape)
        except RuntimeError as e:
            # uneven splits (and, in older torch, any split or flattening
            # of a sharded inner dimension) need the dimensions gathered
            if any(m in str(e) for m in ("unevenly sharded", "flatten multiple",
                                         "split the sharded dimension")):
                keep = [Replicate() if p.is_shard() and tuple(
                    shape[:p.dim + 1]) != tuple(x.shape[:p.dim + 1])
                    else p for p in x.placements]
                x = x.redistribute(x.device_mesh, keep)
            elif "view size is not compatible" in str(e):
                x = contiguous(x)      # a local tensor no view can split
            else:
                raise
    return x.reshape(*shape)


class _Reshape(torch.autograd.Function):
    """:func:`_reshape_dtensor` forward, and on the gradient backward."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape_dtensor(g, ctx.shape), None


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``.  DTensor cannot split a sharded dimension
    unevenly (8 KV heads' columns over a 16-way axis into [8, hd]), in the
    reshape or in its gradient: such a DTensor first gathers each mesh
    axis that shards a dimension the reshape changes, then reshapes.  A
    DTensor's reshape is a view of its local tensor, so one whose local
    layout no view fits is first copied dense."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


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
    # a fake tensor made in a dry-run's trace stays out of the cache, which
    # the real calls that follow in the same process read
    freqs = (_rope_freqs_on if active_fake_mode() is None
             else _rope_freqs_on.__wrapped__)(hd, float(theta), x.device)
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
