"""Language-model assembly (port of ``repro.models.lm``) for the whole
zoo: dense GQA models (Llama 3.1 8B, SmolLM with tied embeddings, the
Qwens with QKV bias), MiniCPM3's MLA, prefix VLMs (SmolVLM) and
cross-attention VLMs (Llama 3.2 Vision), MoE models (Mixtral's top-2
experts with a sliding window, Llama 4 Maverick's top-1 with a shared
expert every 2 layers), the Mamba/attention hybrid with MoE (Jamba v0.1),
the Whisper encoder-decoder and xLSTM.

Depth is (n_periods x period), as in the reference: ``period`` is the
smallest repeating block pattern (dense: 1; Jamba: 8 = 1 attn + 7 mamba;
Llama 3.2 Vision: 5 = 4 self + 1 cross; xLSTM: 8 = 7 mLSTM + 1 sLSTM),
and each position-in-period's parameters are stacked over the periods.
The reference's ``lax.scan`` over periods is a loop over the period
index.  Whisper runs an encoder over the (stub) frame embeddings and gives
every decoder layer a cross-attention block ("xattn" kinds).

Entry points:
  init_params(cfg, seed, device)                    -> params
  forward(params, cfg, tokens, ctx=None)            -> logits
  loss_fn(params, cfg, tokens, labels, ctx=None)    -> scalar loss
  prefill(params, cfg, tokens, ctx=None)            -> (last_logits, caches)
  init_caches(cfg, batch, cache_len, device)        -> caches
  extend_caches(caches, cfg, new_len)               -> decode caches
  flush_tails(caches, cfg)                          -> caches
  decode_step(params, cfg, token, caches, pos)      -> (logits, caches)
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_mod
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as blk
from repro_torch.models import layers as L


# --------------------------------------------------------------- structure
def decoder_kinds(cfg: ArchConfig) -> Tuple[str, ...]:
    if cfg.is_encdec:
        return ("xattn",) * cfg.n_layers
    return cfg.layer_kinds()


def period_of(cfg: ArchConfig) -> int:
    if cfg.is_encdec:
        return 1
    if cfg.family == "ssm" and cfg.xlstm is not None:
        p = cfg.xlstm.slstm_every
    elif cfg.attn_period > 0:
        p = cfg.attn_period
    elif cfg.cross_attn_every > 0:
        p = cfg.cross_attn_every
    else:
        p = 1
    if cfg.moe is not None and cfg.moe.every > 1:
        p = p * cfg.moe.every // math.gcd(p, cfg.moe.every)
    return p if cfg.n_layers % p == 0 else cfg.n_layers


def _layout(cfg: ArchConfig) -> Tuple[int, int, List[Tuple[str, bool]]]:
    kinds = decoder_kinds(cfg)
    p = period_of(cfg)
    n_periods = cfg.n_layers // p
    slots = [(kinds[j], cfg.moe_on_layer(j)) for j in range(p)]
    for i in range(cfg.n_layers):   # the pattern really repeats
        assert kinds[i] == slots[i % p][0], (cfg.name, i)
        assert cfg.moe_on_layer(i) == slots[i % p][1], (cfg.name, i)
    return p, n_periods, slots


def _period(tree, i: int):
    """Period i's slice of a tree whose leaves are stacked over periods."""
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    return tree[i]


def _restack(stacked: Dict, views: List[Dict], new: List[Dict]) -> Dict:
    """Stack per-period cache dicts back over periods; a leaf every period
    returned unchanged (the very view it was given) keeps its stack."""
    return {k: stacked[k] if all(n[k] is v[k] for n, v in zip(new, views))
            else torch.stack([n[k] for n in new]) for k in new[0]}


# ------------------------------------------------------------------- init
def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> Dict:
    """Random parameters from a seeded generator on ``device``, each slot's
    leaves stacked over the periods (the reference's layout and keys; the
    numbers differ, since torch's generator is not jax.random)."""
    dev = device_mod.resolve(device)
    dt = L.dtype_of(cfg.param_dtype)
    _, n_periods, slots = _layout(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Dict = dict(embed=L.embed_init(gen, cfg.vocab, cfg.d_model, dt))
    params["blocks"] = {
        f"p{j}": blk.block_init(gen, cfg, kind, moe_on, lead=(n_periods,))
        for j, (kind, moe_on) in enumerate(slots)}
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, dt, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.linear_init(gen, cfg.d_model, cfg.vocab, dt)
    if cfg.is_encdec:
        params["enc"] = dict(
            blocks=blk.block_init(gen, cfg, "attn", False,
                                  lead=(cfg.enc_layers,)),
            norm=L.rmsnorm_init(cfg.d_model, dt, dev),
            pos=L.normal(gen, (cfg.n_audio_frames, cfg.d_model), 0.02, dt))
    return params


# ------------------------------------------------------------------ encoder
def _encode_ctx(params: Dict, cfg: ArchConfig, ctx: torch.Tensor
                ) -> torch.Tensor:
    """The Whisper encoder over stub frame embeddings (bidirectional)."""
    enc = params["enc"]
    x = ctx + enc["pos"][None, :ctx.shape[1]]
    for i in range(cfg.enc_layers):
        y, _ = blk.block_apply(_period(enc["blocks"], i), cfg, "attn", False,
                               x, causal=False)
        x = y.to(x.dtype)
    return L.rmsnorm(enc["norm"], x, cfg.norm_eps)


def _embed_inputs(params, cfg, tokens, ctx):
    x = L.embed(params["embed"], tokens)
    if cfg.family == "vlm" and cfg.cross_attn_every == 0 and ctx is not None:
        # prefix-VLM (SmolVLM): image embeddings replace the first positions
        n = min(cfg.n_context_tokens, ctx.shape[1], x.shape[1])
        x = torch.cat([ctx[:, :n].to(x.dtype), x[:, n:]], dim=1)
    return x


def _head_w(params, cfg) -> torch.Tensor:
    return params["embed"]["w"].T if cfg.tie_embeddings \
        else params["lm_head"]["w"]


def _head(params, cfg, x):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = L.matmul(x, _head_w(params, cfg))
    else:
        logits = L.linear(params["lm_head"], x)
    return L.shard_hint(logits, "__dp__", None, "model")


# ------------------------------------------------------------------ forward
def forward(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
            ctx: Optional[torch.Tensor] = None, *,
            collect_caches: bool = False, return_hidden: bool = False):
    """tokens [B,S] -> logits [B,S,V] (+ caches stacked over periods when
    collecting); ``return_hidden``: the final-normed hidden states
    [B,S,d] in place of the logits."""
    _, n_periods, slots = _layout(cfg)
    dt = L.dtype_of(cfg.param_dtype)
    if cfg.is_encdec:
        assert ctx is not None, "enc-dec needs frame embeddings"
        ctx = _encode_ctx(params, cfg, ctx)
    x = _embed_inputs(params, cfg, tokens, ctx)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    per_period = []
    for i in range(n_periods):
        # batch over the data axes, sequence over "model" at each period's
        # start (the reference's re-pinned scan carry)
        x = L.shard_hint(x, "__dp__", "model", None)
        caches = {}
        for j, (kind, moe_on) in enumerate(slots):
            x, c = blk.block_apply(_period(params["blocks"][f"p{j}"], i), cfg,
                                   kind, moe_on, x, ctx=ctx,
                                   positions=positions,
                                   collect_cache=collect_caches)
            caches[f"p{j}"] = c
        x = x.to(dt)
        per_period.append(caches)
    if return_hidden:
        out = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    else:
        out = _head(params, cfg, x)
    if not collect_caches:
        return out
    caches = {pj: {k: torch.stack([c[pj][k] for c in per_period])
                   for k in per_period[0][pj]} for pj in per_period[0]}
    return out, caches


def _chunk_ce_sum(x: torch.Tensor, labels: torch.Tensor,
                  head_w: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one sequence chunk."""
    logits = L.shard_hint(L.matmul(x, head_w), "__dp__", None, "model")
    return torch.sum(L.token_losses(logits, labels))


def loss_fn(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
            labels: torch.Tensor, ctx: Optional[torch.Tensor] = None,
            ce_chunk: int = 512) -> torch.Tensor:
    """Mean token cross-entropy.  Above ``ce_chunk`` tokens (S a multiple
    of it) the head product and the softmax run chunk by chunk, each chunk
    recomputed in the backward (``torch.utils.checkpoint``, the reference's
    remat'd ``lax.map``), so one [B, chunk, V] block of logits is live at a
    time; the chunk sums over B * S."""
    B, S = tokens.shape
    x = forward(params, cfg, tokens, ctx, return_hidden=True)
    head_w = _head_w(params, cfg)
    if S % ce_chunk or S <= ce_chunk:
        return L.cross_entropy(
            L.shard_hint(L.matmul(x, head_w), "__dp__", None, "model"),
            labels)
    # chunks are slices of the sequence: on a mesh, gathered first
    x = L.shard_hint(x, "__dp__", None, None)
    total = 0.0
    for i in range(S // ce_chunk):
        sl = slice(i * ce_chunk, (i + 1) * ce_chunk)
        total = total + checkpoint(_chunk_ce_sum, x[:, sl], labels[:, sl],
                                   head_w, use_reentrant=False)
    return total / (B * S)


def prefill(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
            ctx: Optional[torch.Tensor] = None):
    """Run the prompt; returns (last-token logits, caches at prompt
    length).  The full [B,S,V] logits are computed, as in the reference."""
    logits, caches = forward(params, cfg, tokens, ctx, collect_caches=True)
    return logits[:, -1:], caches


# ------------------------------------------------------------------- decode
def init_caches(cfg: ArchConfig, batch: int, cache_len: int,
                device="cuda") -> Dict:
    dev = device_mod.resolve(device)
    dt = L.dtype_of(cfg.param_dtype)
    _, n_periods, slots = _layout(cfg)
    return {f"p{j}": {k: v.expand((n_periods,) + v.shape).contiguous()
                      for k, v in blk.init_cache(cfg, kind, batch, cache_len,
                                                 dt, dev).items()}
            for j, (kind, _) in enumerate(slots)}


_SEQ_CACHE_KEYS = ("k", "v", "ckv", "krope")


def extend_caches(caches: Dict, cfg: ArchConfig, new_len: int) -> Dict:
    """Prepare prefill caches for decoding: pad each sequence-indexed
    prefix (``k``/``v``, MLA's ``ckv``/``krope``) to ``new_len`` (for
    sliding-window archs keep the last W), attach empty ring tails and set
    plen to the prompt length (the two-tier decode cache of
    ``repro_torch.models.blocks``).  Cross-attention's ``xk``/``xv`` pass
    as they are.  Leaves are [n_periods, B, S, ...]: the sequence axis is
    2."""
    out = {}
    for pj, c in caches.items():
        nc = dict(c)
        seq = [name for name in _SEQ_CACHE_KEYS if name in c]
        if seq:   # an attention cache: pad, add tails and plen
            prompt_len = c[seq[0]].shape[2]
            cap = min(new_len, cfg.sliding_window) if cfg.sliding_window \
                else new_len
            for name in seq:
                arr = c[name]
                pad = cap - arr.shape[2]
                if pad > 0:
                    arr = torch.cat([arr, arr.new_zeros(
                        arr.shape[:2] + (pad,) + arr.shape[3:])], dim=2)
                elif pad < 0:
                    arr = arr[:, :, arr.shape[2] - cap:]   # SWA: keep last W
                nc[name] = arr
                nc[name + "_tail"] = arr.new_zeros(
                    arr.shape[:2] + (blk.KV_TAIL,) + arr.shape[3:])
            nc["plen"] = torch.full((c[seq[0]].shape[0],), prompt_len,
                                    dtype=torch.int32,
                                    device=c[seq[0]].device)
        out[pj] = nc
    return out


def flush_tails(caches: Dict, cfg: ArchConfig) -> Dict:
    """Merge the full ring tails into the prefix at plen % S and advance
    plen by ``KV_TAIL``.  The serving loop calls this every KV_TAIL decode
    steps.  The write start is clamped so that the tail fits, as
    ``lax.dynamic_update_slice`` does (a prefix capacity that is a multiple
    of KV_TAIL never needs it)."""
    out = {}
    for pj, c in caches.items():
        if "plen" not in c:
            out[pj] = c
            continue
        nc = dict(c)
        for name in (n for n in _SEQ_CACHE_KEYS if n in c):
            pre, tail = c[name], c[name + "_tail"]
            S, n = pre.shape[2], tail.shape[2]
            start = torch.clamp(c["plen"].long() % S, 0, S - n)   # [n_per]
            idx = start[:, None] + torch.arange(n, device=pre.device)
            idx = idx.view(idx.shape[0], 1, n, *([1] * (pre.dim() - 3)))
            nc[name] = pre.scatter(2, idx.expand_as(tail),
                                   tail.to(pre.dtype))
        nc["plen"] = c["plen"] + blk.KV_TAIL
        out[pj] = nc
    return out


def decode_step(params: Dict, cfg: ArchConfig, token: torch.Tensor,
                caches: Dict, pos: int, ctx: Optional[torch.Tensor] = None):
    """token [B,1] int; caches from :func:`extend_caches` (or
    :func:`init_caches`); pos = the current length.  Returns (logits
    [B,1,V], new caches); the given caches are not modified.  ``ctx`` is
    not read: cross-attention's keys and values (the vision context or the
    encoder's memory) were cached at prefill, as in the reference."""
    _, n_periods, slots = _layout(cfg)
    dt = L.dtype_of(cfg.param_dtype)
    x = L.embed(params["embed"], token)
    views = [_period(caches, i) for i in range(n_periods)]
    new = []
    for i in range(n_periods):
        nc = {}
        for j, (kind, moe_on) in enumerate(slots):
            x, nc[f"p{j}"] = blk.block_decode(
                _period(params["blocks"][f"p{j}"], i), cfg, kind, moe_on, x,
                views[i][f"p{j}"], pos)
        x = x.to(dt)
        new.append(nc)
    caches = {pj: _restack(caches[pj], [v[pj] for v in views],
                           [n[pj] for n in new]) for pj in caches}
    return _head(params, cfg, x), caches
