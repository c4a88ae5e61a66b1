"""Attention primitives (port of ``repro.models.attention``): prefill
attention through the ``flash_attention`` kernel, and single-token decode
attention against the two-tier cache in torch ops.

The reference's prefill runs the jnp ``chunked_attention``, the oracle of its
Pallas kernel; the port runs the kernel itself (the plain version for CPU
tensors).  The decode functions are not kernels in the reference either.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (contiguous, einsum_f32, reshape,
                                       shard_hint)

NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k: [B, Sk, Hk, hd], v: [B, Sk, Hk, vd] (GQA:
    H % Hk == 0) -> [B, Sq, H, vd].  ``causal`` masks later keys (the
    Whisper encoder and cross-attention call with False); window > 0
    applies sliding-window masking.  The kernel reads the transposed views
    in place and writes q's layout.  A v narrower than q (MLA: 64 against
    96) is zero-padded to q's width for the kernel, which takes one width,
    and the output sliced back: exact, and autograd carries the pad; the
    scale stays 1/sqrt(hd), q's own, as in the reference."""
    vd = v.shape[-1]
    if vd < q.shape[-1]:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (q.shape[-1] - vd,))],
                      dim=-1)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window)
    return contiguous(o.transpose(1, 2)[..., :vd].to(v.dtype))


def scale_of(hd: int) -> float:
    """1 / sqrt(hd) in float32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def valid_positions(S: int, length, device) -> torch.Tensor:
    """[B or 1, S]: positions below ``length`` (a tensor, scalar or [B])."""
    pos = torch.arange(S, device=device)
    return pos[None, :] < torch.as_tensor(length, device=device).reshape(-1, 1)


def _grouped(q: torch.Tensor, Hk: int) -> torch.Tensor:
    """[B, 1, H, hd] -> [B, 1, Hk, H // Hk, hd]: query head h reads KV head
    h // (H // Hk), as the reference's ``jnp.repeat`` of the cache does."""
    B, T, H, hd = q.shape
    return reshape(q, B, T, Hk, H // Hk, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, *, window: int = 0
                     ) -> torch.Tensor:
    """One-token attention against a cache: q [B,1,H,hd], k/v_cache
    [B,S,Hk,hd], ``length`` the valid prefix (scalar or [B]) ->
    [B,1,H,hd] in the cache's type."""
    B, S, Hk, hd = k_cache.shape
    H = q.shape[2]
    s = einsum_f32("bqgrd,bkgd->bgrqk", _grouped(q, Hk), k_cache)
    s = reshape(s, B, H, 1, S) * scale_of(hd)
    valid = valid_positions(S, length, q.device)
    if window and window > 0:
        lo = torch.as_tensor(length, device=q.device).reshape(-1, 1) - window
        valid = valid & (torch.arange(S, device=q.device)[None, :] >= lo)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = reshape(torch.softmax(s, dim=-1), B, Hk, H // Hk, 1, S)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v_cache.float())
    return reshape(o, B, 1, H, -1).to(v_cache.dtype)


def decode_attention_stats(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, length: torch.Tensor):
    """Segment attention returning online-softmax stats for merging:
    (o_unnormalised [B,1,H,dv] f32, m [B,H,1], l [B,H,1]).

    q: [B,1,H,hd]; k/v_cache: [B,S,Hk,hd]; length: valid prefix length
    (a tensor, scalar or [B])."""
    B, S, Hk, hd = k_cache.shape
    H = q.shape[2]
    qg = _grouped(q.to(k_cache.dtype), Hk)
    s = reshape(einsum_f32("bqgrd,bkgd->bgrqk", qg, k_cache), B, H, 1, S)
    # scores split along the cache's sequence, where the cache lies
    s = shard_hint(s * scale_of(q.shape[-1]), "__dp__", None, None, "model")
    valid = valid_positions(S, length, q.device)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = torch.amax(s, dim=-1)                              # [B,H,1]
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)                               # [B,H,1]
    pg = reshape(p.to(v_cache.dtype), B, Hk, H // Hk, 1, S)
    o = reshape(einsum_f32("bgrqk,bkgd->bqgrd", pg, v_cache), B, 1, H, -1)
    return o, m, l


def merge_attention(parts, out_dtype):
    """Combine per-segment (o, m, l) stats into normalised attention."""
    M = parts[0][1]
    for _, m, _ in parts[1:]:
        M = torch.maximum(M, m)
    o_tot = 0.0
    l_tot = 0.0
    for o, m, l in parts:
        w = torch.exp(m - M)                                # [B,H,1]
        o_tot = o_tot + o * w.transpose(1, 2)[..., None]
        l_tot = l_tot + l * w
    l_tot = torch.clamp_min(l_tot, 1e-30)
    return (o_tot / l_tot.transpose(1, 2)[..., None]).to(out_dtype)


def cache_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write [B, 1, ...] new entries (KV heads, or MLA's latent and rotary
    key) at position ``pos`` of axis 1 (a tensor; the caller keeps it in
    range) into copies of the caches: a select against a one-hot mask of
    the position (DTensor has no ``index_copy`` rule in every torch
    version)."""
    at = torch.arange(k_cache.shape[1], device=k_cache.device) \
        == torch.as_tensor(pos, device=k_cache.device).reshape(())

    def put(cache, new):
        mask = at.reshape((1, -1) + (1,) * (cache.dim() - 2))
        return torch.where(mask, new.to(cache.dtype), cache)
    return put(k_cache, k_new), put(v_cache, v_new)
