"""Transformer-family blocks (port of ``repro.models.blocks``): GQA
attention with optional sliding windows, dense and MoE FFNs, and Mamba.

Each block kind provides, as in the reference:
  block_init(gen, cfg, kind, moe_on, lead)            -> params
  block_apply(params, cfg, kind, moe_on, x, ...)      full sequence (prefill)
  block_decode(params, cfg, kind, moe_on, x_t, cache, pos)   one token
  init_cache(cfg, kind, batch, cache_len, dtype, device)     -> cache dict

Prefill attention runs the ``flash_attention`` kernel and the Mamba prefill
the ``ssm_scan`` kernel, where the reference runs their jnp oracles.  The
port has the kinds ``attn`` and ``mamba`` without MLA; ``repro_torch.models
.lm`` refuses a config that needs another.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MambaConfig
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

MOE_CAPACITY = 1.25
KV_TAIL = 64   # two-tier decode cache: local ring-tail capacity


# ===========================================================================
# init
# ===========================================================================
def block_init(gen: torch.Generator, cfg: ArchConfig, kind: str,
               moe_on: bool, lead: Tuple[int, ...] = ()) -> Dict:
    """A block's parameters, each leaf stacked over ``lead``."""
    d, dt, dev = cfg.d_model, L.dtype_of(cfg.param_dtype), gen.device
    hd, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    lin = lambda n_in, n_out, **kw: L.linear_init(gen, n_in, n_out, dt,
                                                  lead=lead, **kw)
    p: Dict = dict(norm1=L.rmsnorm_init(d, dt, dev, lead))
    if kind == "attn":
        p.update(wq=lin(d, H * hd, bias=cfg.qkv_bias),
                 wk=lin(d, Hk * hd, bias=cfg.qkv_bias),
                 wv=lin(d, Hk * hd, bias=cfg.qkv_bias),
                 wo=lin(H * hd, d))
    elif kind == "mamba":
        mc = cfg.mamba or MambaConfig()
        di = mc.expand * d
        a_log = torch.log(torch.arange(1, mc.d_state + 1, dtype=torch.float32,
                                       device=dev)).expand(lead + (di, -1))
        p.update(
            in_proj=lin(d, 2 * di),
            conv_w=L.normal(gen, lead + (mc.d_conv, di), 0.1, dt),
            conv_b=torch.zeros(lead + (di,), dtype=dt, device=dev),
            x_proj=lin(di, 2 * mc.d_state + 1),
            dt_bias=torch.zeros(lead + (di,), dtype=torch.float32, device=dev),
            dt_w=lin(1, di),             # broadcast dt -> channels
            a_log=a_log.contiguous(),
            d_skip=torch.ones(lead + (di,), dtype=torch.float32, device=dev),
            out_proj=lin(di, d),
        )
    else:
        raise ValueError(kind)

    # ---- FFN / MoE --------------------------------------------------------
    if cfg.d_ff > 0:
        p["norm2"] = L.rmsnorm_init(d, dt, dev, lead)
        if moe_on:
            m = cfg.moe
            eff = m.d_ff_expert or cfg.d_ff
            p["router"] = lin(d, m.n_experts, scale=0.02)
            sc = 1.0 / np.sqrt(d)
            if cfg.mlp_gated:
                p["e_gate"] = L.normal(gen, lead + (m.n_experts, d, eff), sc,
                                       dt)
            p["e_up"] = L.normal(gen, lead + (m.n_experts, d, eff), sc, dt)
            p["e_down"] = L.normal(gen, lead + (m.n_experts, eff, d),
                                   1.0 / np.sqrt(eff), dt)
            if m.shared_expert:
                p["s_gate"] = lin(d, eff)
                p["s_up"] = lin(d, eff)
                p["s_down"] = lin(eff, d)
        else:
            if cfg.mlp_gated:
                p["w_gate"] = lin(d, cfg.d_ff)
            p["w_up"] = lin(d, cfg.d_ff)
            p["w_down"] = lin(cfg.d_ff, d)
    return p


# ===========================================================================
# FFN / MoE forward
# ===========================================================================
def _ffn(p: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if "router" in p:
        return x + _moe(p, cfg, h)
    if cfg.mlp_gated:
        z = L.swiglu(L.linear(p["w_gate"], h), L.linear(p["w_up"], h))
    else:
        z = L.gelu(L.linear(p["w_up"], h))
    return x + L.linear(p["w_down"], z)


def _shared_expert(p: Dict, ht: torch.Tensor) -> torch.Tensor:
    z = L.swiglu(L.linear(p["s_gate"], ht), L.linear(p["s_up"], ht))
    return L.linear(p["s_down"], z)


def _router_probs(p: Dict, ht: torch.Tensor) -> torch.Tensor:
    """[T, E]: the router's softmax in float32."""
    return torch.softmax(L.linear(p["router"], ht).float(), dim=-1)


def _gates(probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[T, k]: the chosen experts' probabilities renormalised over the k."""
    gv = probs.gather(-1, idx)
    return gv / torch.clamp_min(gv.sum(-1, keepdim=True), 1e-9)


def _route(p: Dict, ht: torch.Tensor, top_k: int):
    """Router softmax, top-k (descending), gates renormalised over the k."""
    probs = _router_probs(p, ht)
    idx = torch.topk(probs, top_k, dim=-1).indices
    return _gates(probs, idx), idx


def _moe(p: Dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Top-k MoE with the reference's three paths: an exact gather of the
    chosen experts for one token per row (decode), a dropless dense-masked
    compute for T <= 512 tokens, and the grouped capacity dispatch
    (GShard-style, tokens past an expert's capacity dropped) above."""
    m = cfg.moe
    B, S, d = h.shape
    T = B * S
    ht = h.reshape(T, d)
    if S == 1:
        gate_vals, idx = _route(p, ht, m.top_k)              # [T, k]
        up_w = p["e_up"][idx]                                # [T,k,d,f]
        dn_w = p["e_down"][idx]                              # [T,k,f,d]
        if "e_gate" in p:
            z = L.swiglu(torch.einsum("td,tkdf->tkf", ht, p["e_gate"][idx]),
                         torch.einsum("td,tkdf->tkf", ht, up_w))
        else:
            z = L.gelu(torch.einsum("td,tkdf->tkf", ht, up_w))
        y = torch.einsum("tkf,tkfd->tkd", z, dn_w)
        out = torch.einsum("tk,tkd->td", gate_vals.to(y.dtype), y)
        if "s_up" in p:
            out = out + _shared_expert(p, ht)
        return out.reshape(B, S, d)
    if T <= 512:
        gate_vals, idx = _route(p, ht, m.top_k)
        w = torch.einsum("tke,tk->te",
                         F.one_hot(idx, m.n_experts).float(), gate_vals)
        if "e_gate" in p:
            z = L.swiglu(torch.einsum("td,edf->tef", ht, p["e_gate"]),
                         torch.einsum("td,edf->tef", ht, p["e_up"]))
        else:
            z = L.gelu(torch.einsum("td,edf->tef", ht, p["e_up"]))
        ye = torch.einsum("tef,efd->ted", z, p["e_down"]).float()
        out = torch.einsum("ted,te->td", ye, w).to(ht.dtype)
        if "s_up" in p:
            out = out + _shared_expert(p, ht)
        return out.reshape(B, S, d)
    # --- grouped capacity dispatch: ~8192-token groups, one at a time -----
    g = max(1, min(S, 8192 // max(1, B)))
    while S % g:
        g -= 1
    n_groups = S // g
    tg = B * g
    cap = max(1, int(MOE_CAPACITY * m.top_k * tg / m.n_experts))
    slots = torch.arange(cap, device=h.device, dtype=torch.float32)

    def group_fn(hgrp):
        """hgrp: [B, g, d] -> [B, g, d] (router recomputed in-group)."""
        ht = hgrp.reshape(tg, d)
        gv, ix = _route(p, ht, m.top_k)
        onehot = F.one_hot(ix, m.n_experts).float()          # [t,k,e]
        load = onehot.sum(1)                                 # [t,e]
        pos = torch.cumsum(load, dim=0) - load
        keep = (pos < cap).float()
        pos_k = torch.einsum("tke,te->tk", onehot, pos)
        keep_k = torch.einsum("tke,te->tk", onehot, keep)
        # one_hot(pos_k, cap) with positions past the capacity as zero rows
        slot = (pos_k[..., None] == slots).float()           # [t,k,c]
        disp = torch.einsum("tke,tkc->tec", onehot * keep_k[..., None], slot)
        xe = torch.einsum("td,tec->ecd", ht.float(), disp).to(ht.dtype)
        if "e_gate" in p:
            z = L.swiglu(torch.einsum("ecd,edf->ecf", xe, p["e_gate"]),
                         torch.einsum("ecd,edf->ecf", xe, p["e_up"]))
        else:
            z = L.gelu(torch.einsum("ecd,edf->ecf", xe, p["e_up"]))
        ye = torch.einsum("ecf,efd->ecd", z, p["e_down"])
        comb = disp * torch.einsum("tk,tke->te", gv, onehot)[..., None]
        out = torch.einsum("ecd,tec->td", ye.float(), comb)
        return out.to(ht.dtype).reshape(B, g, d)

    hg = h.reshape(B, n_groups, g, d)
    out = torch.cat([group_fn(hg[:, i]) for i in range(n_groups)], dim=1)
    if "s_up" in p:
        out = out + _shared_expert(p, ht).reshape(B, S, d)
    return out


# ===========================================================================
# attention block (full sequence)
# ===========================================================================
def _attn_qkv(p: Dict, cfg: ArchConfig, h: torch.Tensor, positions):
    B, S, _ = h.shape
    hd, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = L.linear(p["wq"], h).reshape(B, S, H, hd)
    k = L.linear(p["wk"], h).reshape(B, S, Hk, hd)
    v = L.linear(p["wv"], h).reshape(B, S, Hk, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_apply(p: Dict, cfg: ArchConfig, x: torch.Tensor, positions,
                collect: bool):
    B, S, _ = x.shape
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    q, k, v = _attn_qkv(p, cfg, h, positions)
    o = attn.chunked_attention(q, k, v, window=cfg.sliding_window)
    x = x + L.linear(p["wo"], o.reshape(B, S, -1))
    return x, (dict(k=k, v=v) if collect else None)


# ===========================================================================
# Mamba
# ===========================================================================
def _mamba_apply(p: Dict, cfg: ArchConfig, x: torch.Tensor, collect: bool):
    mc = cfg.mamba or MambaConfig()
    S = x.shape[1]
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    xz = L.linear(p["in_proj"], h)
    xm_raw, z = torch.chunk(xz, 2, dim=-1)               # [B,S,di] each
    # depthwise causal conv1d
    pad = F.pad(xm_raw, (0, 0, mc.d_conv - 1, 0))
    conv = sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(mc.d_conv))
    xm = F.silu((conv + p["conv_b"]).float()).to(x.dtype)
    proj = L.linear(p["x_proj"], xm).float()
    dt_in, B_in, C_in = torch.split(proj, [1, mc.d_state, mc.d_state], -1)
    dt = F.softplus(L.linear(p["dt_w"], dt_in).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])                           # [di,ds]
    xf = xm.float()
    y, h_final = ssm_scan(dt.contiguous(), B_in.contiguous(),
                          C_in.contiguous(), xf.contiguous(), a)
    y = y + p["d_skip"] * xf
    y = (y * F.silu(z.float())).to(x.dtype)
    out = x + L.linear(p["out_proj"], y)
    cache = None
    if collect:
        # conv state = the last (d_conv - 1) PRE-conv inputs
        cache = dict(conv=pad[:, S:S + mc.d_conv - 1].to(x.dtype),
                     ssm=h_final)
    return out, cache


def _mamba_decode(p: Dict, cfg: ArchConfig, x_t: torch.Tensor, cache: Dict):
    mc = cfg.mamba or MambaConfig()
    h = L.rmsnorm(p["norm1"], x_t, cfg.norm_eps)
    xz = L.linear(p["in_proj"], h)[:, 0]                 # [B, 2di]
    xm, z = torch.chunk(xz, 2, dim=-1)
    hist = torch.cat([cache["conv"], xm[:, None]], dim=1)  # [B,dc,di]
    conv = (hist * p["conv_w"][None]).sum(1) + p["conv_b"]
    xc = F.silu(conv.float()).to(x_t.dtype)
    proj = L.linear(p["x_proj"], xc).float()
    dt_in, B_in, C_in = torch.split(proj, [1, mc.d_state, mc.d_state], -1)
    dt = F.softplus(L.linear(p["dt_w"], dt_in).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt[..., None] * a)
    hs = decay * cache["ssm"] + (dt * xc.float())[..., None] \
        * B_in[:, None, :]
    y = (hs * C_in[:, None, :]).sum(-1) + p["d_skip"] * xc.float()
    y = (y * F.silu(z.float())).to(x_t.dtype)
    out = x_t + L.linear(p["out_proj"], y)[:, None]
    return out, dict(conv=hist[:, 1:].to(x_t.dtype), ssm=hs)


# ===========================================================================
# unified block API
# ===========================================================================
def block_apply(params: Dict, cfg: ArchConfig, kind: str, moe_on: bool,
                x: torch.Tensor, *, positions=None,
                collect_cache: bool = False):
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if kind == "attn":
        x, cache = _attn_apply(params, cfg, x, positions, collect_cache)
    elif kind == "mamba":
        x, cache = _mamba_apply(params, cfg, x, collect_cache)
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0:
        x = _ffn(params, cfg, x)
    return x, cache


def block_decode(params: Dict, cfg: ArchConfig, kind: str, moe_on: bool,
                 x_t: torch.Tensor, cache: Dict, pos: int):
    """x_t: [B,1,d]; pos: the current length."""
    B = x_t.shape[0]
    hd, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    if kind == "attn":
        h = L.rmsnorm(params["norm1"], x_t, cfg.norm_eps)
        positions = torch.full((B, 1), pos, device=x_t.device)
        # two-tier cache: `plen` tokens live in the prefix, the newest
        # (pos - plen + 1) in the ring tail; writes touch only the tail
        plen = cache["plen"]
        tpos = torch.clamp_min(pos - plen, 0) % KV_TAIL
        q = L.linear(params["wq"], h).reshape(B, 1, H, hd)
        k = L.linear(params["wk"], h).reshape(B, 1, Hk, hd)
        v = L.linear(params["wv"], h).reshape(B, 1, Hk, hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        S = cache["k"].shape[1]
        kt, vt = attn.cache_update(cache["k_tail"], cache["v_tail"], k, v,
                                   tpos)
        # prefix: a ring of the last <= S tokens (== the window for
        # sliding-window archs); tail: the newest tpos + 1 tokens
        pre = attn.decode_attention_stats(q, cache["k"], cache["v"],
                                          torch.clamp_max(plen, S))
        tail = attn.decode_attention_stats(q, kt, vt, tpos + 1)
        o = attn.merge_attention([pre, tail], x_t.dtype)
        x_t = x_t + L.linear(params["wo"], o.reshape(B, 1, H * hd))
        cache = dict(cache, k_tail=kt, v_tail=vt)
    elif kind == "mamba":
        x_t, cache = _mamba_decode(params, cfg, x_t, cache)
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0:
        x_t = _ffn(params, cfg, x_t)
    return x_t, cache


def init_cache(cfg: ArchConfig, kind: str, batch: int, cache_len: int,
               dtype, device) -> Dict:
    hd, Hk = cfg.head_dim, cfg.n_kv_heads
    z = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    if kind == "attn":
        S = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
            else cache_len
        return dict(k=z((batch, S, Hk, hd)), v=z((batch, S, Hk, hd)),
                    k_tail=z((batch, KV_TAIL, Hk, hd)),
                    v_tail=z((batch, KV_TAIL, Hk, hd)),
                    plen=z((), torch.int32))
    if kind == "mamba":
        mc = cfg.mamba or MambaConfig()
        di = mc.expand * cfg.d_model
        return dict(conv=z((batch, mc.d_conv - 1, di)),
                    ssm=z((batch, di, mc.d_state), torch.float32))
    raise ValueError(kind)
