"""Transformer-family blocks (port of ``repro.models.blocks``): GQA, MLA
and cross-attention with optional sliding windows, dense and MoE FFNs,
Mamba, and the xLSTM blocks (mLSTM in its chunked linear-attention form,
sLSTM as a recurrence).

Each block kind provides, as in the reference:
  block_init(gen, cfg, kind, moe_on, lead)            -> params
  block_apply(params, cfg, kind, moe_on, x, ...)      full sequence
  block_decode(params, cfg, kind, moe_on, x_t, cache, pos)   one token
  init_cache(cfg, kind, batch, cache_len, dtype, device)     -> cache dict

Full-sequence attention (self, cross and the Whisper encoder's) runs the
``flash_attention`` kernel and the Mamba scan the ``ssm_scan`` kernel,
where the reference runs their jnp oracles; with a gradient, their
backward kernels.  The xLSTM blocks are torch ops, as the reference's are
jnp (it has no kernel for them).

Options of the config beyond the reference's, off by default, give the
published Jamba block (``configs/ai21_jamba2_mini.py``): ``rope=False``
(attention without positions), ``MambaConfig.dt_rank`` and
``inner_norms`` (a dt of that rank out of ``x_proj``, RMSNorms on dt, B
and C) and ``MoEConfig.renormalize=False`` (the top-k probabilities as
they are for gates).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import (ArchConfig, MambaConfig, MoEConfig,
                                      XLSTMConfig)
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import serving_span as span

MLSTM_CHUNK = 128
MOE_CAPACITY = 1.25
KV_TAIL = 64   # two-tier decode cache: local ring-tail capacity


def _xlstm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    xc = cfg.xlstm or XLSTMConfig()
    quant = 16 * cfg.n_heads
    di = max(quant, int(cfg.d_model * xc.proj_factor) // quant * quant)
    dqk = max(quant, int(di * xc.d_qk_factor) // quant * quant)
    return di, dqk, cfg.n_heads


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
    if kind in ("attn", "xattn"):
        if cfg.mla is not None:
            m = cfg.mla
            qk_d = m.qk_nope_head_dim + m.qk_rope_head_dim
            p.update(
                wdq=lin(d, m.q_lora_rank),
                q_norm=L.rmsnorm_init(m.q_lora_rank, dt, dev, lead),
                wuq=lin(m.q_lora_rank, H * qk_d),
                wdkv=lin(d, m.kv_lora_rank + m.qk_rope_head_dim),
                kv_norm=L.rmsnorm_init(m.kv_lora_rank, dt, dev, lead),
                wukv=lin(m.kv_lora_rank,
                         H * (m.qk_nope_head_dim + m.v_head_dim)),
                wo=lin(H * m.v_head_dim, d))
        else:
            p.update(wq=lin(d, H * hd, bias=cfg.qkv_bias),
                     wk=lin(d, Hk * hd, bias=cfg.qkv_bias),
                     wv=lin(d, Hk * hd, bias=cfg.qkv_bias),
                     wo=lin(H * hd, d))
        if kind == "xattn":   # cross-attention onto context tokens
            p.update(x_norm=L.rmsnorm_init(d, dt, dev, lead),
                     x_wq=lin(d, H * hd), x_wk=lin(d, Hk * hd),
                     x_wv=lin(d, Hk * hd), x_wo=lin(H * hd, d),
                     x_gate=torch.zeros(lead + (d,), dtype=dt, device=dev))
    elif kind == "mlstm":
        di, dqk, Hx = _xlstm_dims(cfg)
        p.update(up=lin(d, 2 * di), wq=lin(di, dqk), wk=lin(di, dqk),
                 wv=lin(di, di), gates=lin(di, 2 * Hx),   # i, f per head
                 ln=L.rmsnorm_init(di, dt, dev, lead), down=lin(di, d))
    elif kind == "slstm":
        di, _, _ = _xlstm_dims(cfg)
        p.update(up=lin(d, di), wx=lin(di, 4 * di),
                 wr=lin(di, 4 * di, scale=0.02),
                 ln=L.rmsnorm_init(di, dt, dev, lead), down=lin(di, d))
    elif kind == "mamba":
        mc = cfg.mamba or MambaConfig()
        di = mc.expand * d
        a_log = torch.log(torch.arange(1, mc.d_state + 1, dtype=torch.float32,
                                       device=dev)).expand(lead + (di, -1))
        p.update(
            in_proj=lin(d, 2 * di),
            conv_w=L.normal(gen, lead + (mc.d_conv, di), 0.1, dt),
            conv_b=torch.zeros(lead + (di,), dtype=dt, device=dev),
            x_proj=lin(di, mc.dt_rank + 2 * mc.d_state),
            dt_bias=torch.zeros(lead + (di,), dtype=torch.float32, device=dev),
            dt_w=lin(mc.dt_rank, di),    # dt_proj: dt rank -> channels
            a_log=a_log.contiguous(),
            d_skip=torch.ones(lead + (di,), dtype=torch.float32, device=dev),
            out_proj=lin(di, d),
        )
        if mc.inner_norms:
            p.update(dt_norm=L.rmsnorm_init(mc.dt_rank, dt, dev, lead),
                     b_norm=L.rmsnorm_init(mc.d_state, dt, dev, lead),
                     c_norm=L.rmsnorm_init(mc.d_state, dt, dev, lead))
    else:
        raise ValueError(kind)

    # ---- FFN / MoE --------------------------------------------------------
    if cfg.d_ff > 0 and kind not in ("mlstm", "slstm"):
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


def _route(p: Dict, ht: torch.Tensor, top_k: int):
    """Router softmax, top-k (descending): the chosen experts'
    probabilities [T, k] and their indices."""
    probs = _router_probs(p, ht)
    idx = torch.topk(probs, top_k, dim=-1).indices
    return probs.gather(-1, idx), idx


def _route_gates(p: Dict, ht: torch.Tensor, m: MoEConfig):
    """:func:`_route` (looked up at each call, so that a rebinding sees
    every call) and its probabilities as gates: renormalised over the top
    k where the config says so (Mixtral), as they are otherwise (Jamba)."""
    gv, idx = _route(p, ht, m.top_k)
    if m.renormalize:
        gv = gv / torch.clamp_min(gv.sum(-1, keepdim=True), 1e-9)
    return gv, idx


def _per_token(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The decode MoE's per-token products.  On DTensors as broadcast
    matmuls and a sum: einsum flattens the expert and width dimensions
    together, which DTensor refuses while the width is split over a mesh
    axis in some torch versions."""
    if not isinstance(a, DTensor):
        return torch.einsum(eq, a, b)
    if eq == "td,tkdf->tkf":
        return (a[:, None, None, :] @ b).squeeze(-2)
    if eq == "tkf,tkfd->tkd":
        return (a[..., None, :] @ b).squeeze(-2)
    return (a[..., None] * b).sum(1)                         # tk,tkd->td


def _index_dispatch(ht, onehot, ix, pos_k, keep_k, cap):
    """The grouped path's dispatch on plain tensors: a kept (token,
    choice) takes slot ``ix * cap + pos_k``, a dropped one the spare slot
    ``E * cap``; each expert slot then reads its token's row through the
    inverse map, an empty slot the zero row past the last token.  Row
    copies, no atomics, no host sync: the one-hot product's values
    exactly.  -> xe [E, cap, d] in ``ht``'s dtype, and the slots [t, k]."""
    (t, d), E = ht.shape, onehot.shape[-1]
    spare = E * cap
    slot = torch.where(keep_k > 0, ix * cap + pos_k.long(), spare)
    token = torch.arange(t, device=ht.device)[:, None].expand_as(ix)
    src = torch.full((spare + 1,), t, dtype=torch.long, device=ht.device)
    src = src.scatter(0, slot.flatten(), token.flatten())[:spare]
    xe = torch.cat([ht, ht.new_zeros(1, d)])[src]
    return xe.view(E, cap, d), slot


def _index_combine(ye, slot, onehot, gv):
    """The experts' rows gathered back at each (token, choice)'s slot and
    summed under the gates in float32 -> [t, d]; a dropped choice reads
    the last slot's row under a zero gate, as every other row sits under
    a zero in the one-hot product.  A token with one kept choice gets the
    one-hot product's value exactly; one with two gets the sum of the
    same two products, which a GEMM rounds fused or not by where the
    slots fall in its K tiling (within one rounding of each product)."""
    E, cap, d = ye.shape
    rows = ye.reshape(E * cap, d)[slot.clamp(max=E * cap - 1)]   # [t,k,d]
    return (rows * (gv * (slot < E * cap))[..., None]).sum(1)


def _onehot_dispatch(ht, onehot, ix, pos_k, keep_k, cap):
    """The grouped path's dispatch on DTensors, as float32 one-hot
    products: DTensor has no sharding rule for the index operations on
    tokens split over the data axes, and the dry-run's flop counter has
    formulas for einsums.  -> xe [E, cap, d] and the dispatch tensor
    [t, E, cap]."""
    slots = torch.arange(cap, device=ht.device, dtype=torch.float32)
    # one_hot(pos_k, cap) with positions past the capacity as zero rows
    slot = (pos_k[..., None] == slots).float()                   # [t,k,c]
    disp = torch.einsum("tke,tkc->tec", onehot * keep_k[..., None], slot)
    xe = torch.einsum("td,tec->ecd", ht.float(), disp).to(ht.dtype)
    return xe, disp


def _onehot_combine(ye, disp, onehot, gv):
    comb = disp * torch.einsum("tk,tke->te", gv, onehot)[..., None]
    return torch.einsum("ecd,tec->td", ye.float(), comb)


def _moe(p: Dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Top-k MoE with the reference's three paths: an exact gather of the
    chosen experts for one token per row (decode), a dropless dense-masked
    compute for T <= 512 tokens, and the grouped capacity dispatch
    (GShard-style, tokens past an expert's capacity dropped; rows moved by
    index, by one-hot einsums on DTensors) above.  A served request's
    spans: ``moe`` around ``moe.route`` and the path's parts, and its
    token-expert assignments counted with those dropped."""
    m = cfg.moe
    B, S, d = h.shape
    T = B * S
    with span("moe"):
        ht = L.reshape(h, T, d)
        if S == 1:
            with span("moe.route"):
                gate_vals, idx = _route_gates(p, ht, m)          # [T, k]
            obs_trace.moe_assignments(T * m.top_k)
            with span("moe.gather"):
                up_w = p["e_up"][idx]                            # [T,k,d,f]
                dn_w = p["e_down"][idx]                          # [T,k,f,d]
                gate_w = p["e_gate"][idx] if "e_gate" in p else None
            with span("moe.experts"):
                if gate_w is not None:
                    z = L.swiglu(_per_token("td,tkdf->tkf", ht, gate_w),
                                 _per_token("td,tkdf->tkf", ht, up_w))
                else:
                    z = L.gelu(_per_token("td,tkdf->tkf", ht, up_w))
                y = _per_token("tkf,tkfd->tkd", z, dn_w)
                out = _per_token("tk,tkd->td", gate_vals.to(y.dtype), y)
                if "s_up" in p:
                    out = out + _shared_expert(p, ht)
            return out.reshape(B, S, d)
        if T <= 512:
            with span("moe.route"):
                gate_vals, idx = _route_gates(p, ht, m)
            obs_trace.moe_assignments(T * m.top_k)
            with span("moe.dense"):
                w = torch.einsum("tke,tk->te",
                                 F.one_hot(idx, m.n_experts).float(),
                                 gate_vals)
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
        # --- grouped capacity dispatch: ~8192-token groups, one at a time -
        g = max(1, min(S, 8192 // max(1, B)))
        while S % g:
            g -= 1
        n_groups = S // g
        tg = B * g
        cap = max(1, int(MOE_CAPACITY * m.top_k * tg / m.n_experts))
        # on a mesh: the experts' FSDP shards gathered once for all the
        # groups, and the tokens split by batch rows only, so that a group
        # is a slice
        experts = [L.gather_fsdp(p[k]) for k in ("e_gate", "e_up", "e_down")
                   if k in p]
        h = L.shard_hint(h, "__dp__", None, None)

        def group_fn(hgrp, *experts):
            """hgrp: [B, g, d] -> [B, g, d] (router recomputed in-group);
            the experts come as arguments, not from the closure, so that a
            group's remat keeps no gathered weights across the forward."""
            *gate, up, down = experts
            ht = L.reshape(hgrp, tg, d)
            with span("moe.route"):
                gv, ix = _route_gates(p, ht, m)
            with span("moe.dispatch"):
                onehot = F.one_hot(ix, m.n_experts).float()      # [t,k,e]
                load = onehot.sum(1)                             # [t,e]
                # along the transpose's inner dimension: down the outer
                # one CUDA's scan takes a thread a column (on an H100, 1.02
                # ms at 7,040 tokens and 8 experts, against 0.033)
                pos = torch.cumsum(load.t().contiguous(), dim=1).t() - load
                keep = (pos < cap).float()
                pos_k = torch.einsum("tke,te->tk", onehot, pos)
                keep_k = torch.einsum("tke,te->tk", onehot, keep)
                obs_trace.moe_assignments(tg * m.top_k, keep_k)
                dispatch, combine = (
                    (_onehot_dispatch, _onehot_combine)
                    if isinstance(ht, DTensor)
                    else (_index_dispatch, _index_combine))
                xe, plan = dispatch(ht, onehot, ix, pos_k, keep_k, cap)
            with span("moe.experts"):
                if gate:
                    z = L.swiglu(torch.einsum("ecd,edf->ecf", xe, gate[0]),
                                 torch.einsum("ecd,edf->ecf", xe, up))
                else:
                    z = L.gelu(torch.einsum("ecd,edf->ecf", xe, up))
                ye = torch.einsum("ecf,efd->ecd", z, down)
            with span("moe.combine"):
                out = combine(ye, plan, onehot, gv)
            return out.to(ht.dtype).reshape(B, g, d)

        if n_groups == 1:
            out = group_fn(h, *experts)
        else:
            # one group's dispatch buffers live at a time in the backward
            # (the reference's lax.map of a remat'd group_fn)
            hg = h.reshape(B, n_groups, g, d)
            out = torch.cat([L.remat(group_fn, hg[:, i], *experts)
                             for i in range(n_groups)], dim=1)
            # on a mesh the gradient comes back split along the sequence,
            # which the cat's backward slices by group: re-laid out once
            # here, not gathered whole for every group's slice
            out = L.shard_hint(out, "__dp__", None, "model")
        if "s_up" in p:
            with span("moe.experts"):
                out = out + _shared_expert(p, ht).reshape(B, S, d)
        return out


# ===========================================================================
# attention blocks (full sequence)
# ===========================================================================
def _attn_qkv(p: Dict, cfg: ArchConfig, h: torch.Tensor, positions):
    """q, k, v [B,S,heads,width] and the prefill cache (k/v, or MLA's
    compressed latent ckv and its shared rotary key krope)."""
    B, S, _ = h.shape
    hd, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    if cfg.mla is not None:
        m = cfg.mla
        nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
        q = L.linear(p["wuq"], L.rmsnorm(p["q_norm"], L.linear(p["wdq"], h),
                                         cfg.norm_eps))
        q = L.reshape(q, B, S, H, nope + rope)
        c, k_rope = torch.split(L.linear(p["wdkv"], h),
                                [m.kv_lora_rank, rope], dim=-1)
        c = L.rmsnorm(p["kv_norm"], c, cfg.norm_eps)
        kv = L.reshape(L.linear(p["wukv"], c), B, S, H,
                       nope + m.v_head_dim)
        k_nope, v = torch.split(kv, [nope, m.v_head_dim], dim=-1)
        q_nope, q_rope = torch.split(q, [nope, rope], dim=-1)
        q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
        k_rope = L.apply_rope(L.reshape(k_rope, B, S, 1, rope), positions,
                              cfg.rope_theta)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope.expand(B, S, H, rope)], dim=-1)
        return q_full, k_full, v, dict(ckv=c, krope=k_rope)
    q = L.reshape(L.linear(p["wq"], h), B, S, H, hd)
    k = L.reshape(L.linear(p["wk"], h), B, S, Hk, hd)
    v = L.reshape(L.linear(p["wv"], h), B, S, Hk, hd)
    if cfg.rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, dict(k=k, v=v)


def _attn_apply(p: Dict, cfg: ArchConfig, kind: str, x: torch.Tensor, ctx,
                positions, causal: bool, collect: bool):
    with span("attn"):
        B, S, _ = x.shape
        hd, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
        q, k, v, cache = _attn_qkv(p, cfg, h, positions)
        o = attn.chunked_attention(q, k, v, causal=causal,
                                   window=cfg.sliding_window)
        x = x + L.linear(p["wo"], L.reshape(o, B, S, -1))
        if kind == "xattn" and ctx is not None:
            hx = L.rmsnorm(p["x_norm"], x, cfg.norm_eps)
            Sc = ctx.shape[1]
            qx = L.reshape(L.linear(p["x_wq"], hx), B, S, H, hd)
            kx = L.reshape(L.linear(p["x_wk"], ctx), B, Sc, Hk, hd)
            vx = L.reshape(L.linear(p["x_wv"], ctx), B, Sc, Hk, hd)
            ox = attn.chunked_attention(qx, kx, vx, causal=False)
            gate = torch.tanh(p["x_gate"].float()).to(x.dtype)
            x = x + gate * L.linear(p["x_wo"], L.reshape(ox, B, S, H * hd))
            if collect:
                cache = dict(cache, xk=kx, xv=vx)
        return x, (cache if collect else None)


# ===========================================================================
# Mamba
# ===========================================================================
def _ssm_inputs(p: Dict, cfg: ArchConfig, mc: MambaConfig, xm: torch.Tensor):
    """dt [..., di], B and C [..., d_state] in float32 from the conv's
    output ``xm``: ``x_proj`` split as [dt_rank, d_state, d_state], each
    part RMS-normed where the config has the inner norms (Jamba), then
    dt through ``dt_w`` (+ ``dt_bias``) and a softplus."""
    proj = L.linear(p["x_proj"], xm)
    dt_in, b_in, c_in = torch.split(proj, [mc.dt_rank, mc.d_state,
                                           mc.d_state], -1)
    if mc.inner_norms:
        dt_in = L.rmsnorm(p["dt_norm"], dt_in, cfg.norm_eps)
        b_in = L.rmsnorm(p["b_norm"], b_in, cfg.norm_eps)
        c_in = L.rmsnorm(p["c_norm"], c_in, cfg.norm_eps)
    else:
        dt_in = dt_in.float()
    dt = F.softplus(L.linear(p["dt_w"], dt_in).float() + p["dt_bias"])
    return dt, b_in.float(), c_in.float()


def _mamba_apply(p: Dict, cfg: ArchConfig, x: torch.Tensor, collect: bool):
    """The Mamba mixer over a sequence; a served request's spans: ``mamba``
    around it, ``mamba.scan`` around the ``ssm_scan`` kernel, and its
    tokens counted."""
    mc = cfg.mamba or MambaConfig()
    S = x.shape[1]
    with span("mamba"):
        obs_trace.mamba_tokens(x.shape[0] * S)
        h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
        xz = L.linear(p["in_proj"], h)
        xm_raw, z = torch.chunk(xz, 2, dim=-1)               # [B,S,di] each
        # depthwise causal conv1d (zeros concatenated in front: DTensor has
        # no sound padding rule in every torch version)
        pad = torch.cat([xm_raw.new_zeros((xm_raw.shape[0], mc.d_conv - 1,
                                           xm_raw.shape[2])), xm_raw], dim=1)
        conv = sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(mc.d_conv))
        xm = F.silu((conv + p["conv_b"]).float()).to(x.dtype)
        dt, B_in, C_in = _ssm_inputs(p, cfg, mc, xm)
        a = -torch.exp(p["a_log"])                           # [di,ds]
        xf = xm.float()
        with span("mamba.scan"):
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
    """One token of the Mamba mixer; the spans and count of
    :func:`_mamba_apply`, ``mamba.scan`` around the state's step."""
    mc = cfg.mamba or MambaConfig()
    with span("mamba"):
        obs_trace.mamba_tokens(x_t.shape[0])
        h = L.rmsnorm(p["norm1"], x_t, cfg.norm_eps)
        xz = L.linear(p["in_proj"], h)[:, 0]                 # [B, 2di]
        xm, z = torch.chunk(xz, 2, dim=-1)
        hist = torch.cat([cache["conv"], xm[:, None]], dim=1)  # [B,dc,di]
        conv = (hist * p["conv_w"][None]).sum(1) + p["conv_b"]
        xc = F.silu(conv.float()).to(x_t.dtype)
        dt, B_in, C_in = _ssm_inputs(p, cfg, mc, xc)
        a = -torch.exp(p["a_log"])
        with span("mamba.scan"):
            decay = torch.exp(dt[..., None] * a)
            hs = decay * cache["ssm"] + (dt * xc.float())[..., None] \
                * B_in[:, None, :]
            y = (hs * C_in[:, None, :]).sum(-1)
        y = y + p["d_skip"] * xc.float()
        y = (y * F.silu(z.float())).to(x_t.dtype)
        out = x_t + L.linear(p["out_proj"], y)[:, None]
    return out, dict(conv=hist[:, 1:].to(x_t.dtype), ssm=hs)


# ===========================================================================
# xLSTM blocks
# ===========================================================================
def _mlstm_apply(p: Dict, cfg: ArchConfig, x: torch.Tensor, collect: bool):
    """Chunked linear-attention form of mLSTM (sigmoid-stabilised gates):
    the reference's ``lax.scan`` over chunks is a loop."""
    B, S, _ = x.shape
    di, dqk, H = _xlstm_dims(cfg)
    dqk_h, dv_h = dqk // H, di // H
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    u, z = torch.chunk(L.linear(p["up"], h), 2, dim=-1)        # [B,S,di]
    q = L.reshape(L.linear(p["wq"], u), B, S, H, dqk_h).float()
    # a numpy scalar is a float32 array to the reference: k is float32
    k = L.reshape(L.linear(p["wk"], u), B, S, H, dqk_h).float() \
        / float(np.sqrt(dqk_h))
    v = L.reshape(L.linear(p["wv"], u), B, S, H, dv_h).float()
    gts = L.reshape(L.linear(p["gates"], u).float(), B, S, 2, H)
    ig = torch.sigmoid(gts[:, :, 0])                             # [B,S,H]
    fg = torch.sigmoid(gts[:, :, 1] + 4.0)             # forget bias -> ~1
    n_chunks = max(1, S // MLSTM_CHUNK) if S % MLSTM_CHUNK == 0 else 1
    ch = S // n_chunks
    tri = torch.tril(torch.ones((ch, ch), dtype=torch.bool, device=x.device))
    C = torch.zeros((B, H, dqk_h, dv_h), dtype=torch.float32, device=x.device)
    outs = []
    for i in range(n_chunks):
        sl = slice(i * ch, (i + 1) * ch)
        qi, ki, vi, ii = q[:, sl], k[:, sl], v[:, sl], ig[:, sl]
        cum = torch.cumsum(torch.log(torch.clamp_min(fg[:, sl], 1e-6)),
                           dim=1)                                # inclusive
        # intra-chunk: D[t,s] = exp(cum_t - cum_s) * i_s for s <= t
        dmask = cum[:, :, None] - cum[:, None, :]                # [B,t,s,H]
        dmat = torch.where(tri[None, :, :, None],
                           torch.exp(dmask) * ii[:, None, :, :], 0.0)
        scores = torch.einsum("bthd,bshd->btsh", qi, ki)
        o_intra = torch.einsum("btsh,bshe->bthe", scores * dmat, vi)
        # inter-chunk: q_t decayed to the chunk start @ C
        o_inter = torch.einsum("bthd,bhde->bthe",
                               qi * torch.exp(cum)[..., None], C)
        # C' = F_total C + sum_s exp(cum_end - cum_s) i_s k_s v_s^T
        f_tot = torch.exp(cum[:, -1])                            # [B,H]
        w = torch.exp(cum[:, -1:, :] - cum) * ii                 # [B,ch,H]
        C = f_tot[:, :, None, None] * C + torch.einsum(
            "bshd,bshe->bhde", ki * w[..., None], vi)
        outs.append((o_intra + o_inter).to(x.dtype))
    o = L.reshape(torch.cat(outs, dim=1), B, S, di)
    o = L.rmsnorm(p["ln"], o, cfg.norm_eps)
    o = o * F.silu(z.float()).to(x.dtype)
    out = x + L.linear(p["down"], o)
    return out, (dict(C=C) if collect else None)


def _mlstm_decode(p: Dict, cfg: ArchConfig, x_t: torch.Tensor, cache: Dict):
    B = x_t.shape[0]
    di, dqk, H = _xlstm_dims(cfg)
    dqk_h, dv_h = dqk // H, di // H
    h = L.rmsnorm(p["norm1"], x_t, cfg.norm_eps)
    u, z = torch.chunk(L.linear(p["up"], h)[:, 0], 2, dim=-1)
    q = L.reshape(L.linear(p["wq"], u), B, H, dqk_h).float()
    k = L.reshape(L.linear(p["wk"], u), B, H, dqk_h).float() \
        / float(np.sqrt(dqk_h))
    v = L.reshape(L.linear(p["wv"], u), B, H, dv_h).float()
    gts = L.reshape(L.linear(p["gates"], u).float(), B, 2, H)
    ig = torch.sigmoid(gts[:, 0])
    fg = torch.sigmoid(gts[:, 1] + 4.0)
    C = fg[..., None, None] * cache["C"] \
        + ig[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v)
    o = L.reshape(torch.einsum("bhd,bhde->bhe", q, C), B, di)
    o = L.rmsnorm(p["ln"], o.to(x_t.dtype), cfg.norm_eps)
    o = o * F.silu(z.float()).to(x_t.dtype)
    out = x_t + L.linear(p["down"], o)[:, None]
    return out, dict(C=C)


def _slstm_cell(p: Dict, wx_t: torch.Tensor, h_prev, c_prev, dtype):
    pre = wx_t + L.matmul(h_prev.to(dtype), p["wr"]["w"]).float()
    i, f, zg, o = torch.chunk(pre, 4, dim=-1)
    c = torch.sigmoid(f + 2.0) * c_prev + torch.sigmoid(i) * torch.tanh(zg)
    return torch.sigmoid(o) * torch.tanh(c), c


def _slstm_apply(p: Dict, cfg: ArchConfig, x: torch.Tensor, collect: bool):
    B, S, _ = x.shape
    di, _, _ = _xlstm_dims(cfg)
    u = L.linear(p["up"], L.rmsnorm(p["norm1"], x, cfg.norm_eps))
    wx = L.linear(p["wx"], u).float()                          # [B,S,4di]
    h = c = torch.zeros((B, di), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(S):                  # the reference's lax.scan over time
        h, c = _slstm_cell(p, wx[:, t], h, c, x.dtype)
        hs.append(h)
    y = L.rmsnorm(p["ln"], torch.stack(hs, dim=1).to(x.dtype), cfg.norm_eps)
    out = x + L.linear(p["down"], y)
    return out, (dict(h=h, c=c) if collect else None)


def _slstm_decode(p: Dict, cfg: ArchConfig, x_t: torch.Tensor, cache: Dict):
    u = L.linear(p["up"], L.rmsnorm(p["norm1"], x_t, cfg.norm_eps))[:, 0]
    h, c = _slstm_cell(p, L.linear(p["wx"], u).float(), cache["h"],
                       cache["c"], x_t.dtype)
    y = L.rmsnorm(p["ln"], h.to(x_t.dtype), cfg.norm_eps)
    return x_t + L.linear(p["down"], y)[:, None], dict(h=h, c=c)


# ===========================================================================
# unified block API
# ===========================================================================
def block_apply(params: Dict, cfg: ArchConfig, kind: str, moe_on: bool,
                x: torch.Tensor, *, ctx=None, positions=None,
                causal: bool = True, collect_cache: bool = False):
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if kind in ("attn", "xattn"):
        x, cache = _attn_apply(params, cfg, kind, x, ctx, positions, causal,
                               collect_cache)
    elif kind == "mamba":
        x, cache = _mamba_apply(params, cfg, x, collect_cache)
    elif kind == "mlstm":
        x, cache = _mlstm_apply(params, cfg, x, collect_cache)
    elif kind == "slstm":
        x, cache = _slstm_apply(params, cfg, x, collect_cache)
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0 and kind not in ("mlstm", "slstm"):
        x = _ffn(params, cfg, x)
    return x, cache


def _mla_decode(params: Dict, cfg: ArchConfig, h: torch.Tensor, cache: Dict,
                positions, tpos):
    """MLA decode with absorbed projections: only the compressed latent
    (kv_lora_rank + rope width a token) is cached; returns (o [B,1,H,v],
    the caches with the new tails)."""
    B = h.shape[0]
    m, H = cfg.mla, cfg.n_heads
    r, nope, rope = m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim
    q = L.linear(params["wuq"], L.rmsnorm(params["q_norm"],
                                          L.linear(params["wdq"], h),
                                          cfg.norm_eps))
    q_nope, q_rope = torch.split(L.reshape(q, B, 1, H, nope + rope),
                                 [nope, rope], dim=-1)
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    c_t, krope_t = torch.split(L.linear(params["wdkv"], h), [r, rope],
                               dim=-1)
    c_t = L.rmsnorm(params["kv_norm"], c_t, cfg.norm_eps)
    krope_t = L.apply_rope(L.reshape(krope_t, B, 1, 1, rope), positions,
                           cfg.rope_theta)
    ckv_tail, krope_tail = attn.cache_update(
        cache["ckv_tail"], cache["krope_tail"], c_t, krope_t, tpos)
    wukv = L.reshape(params["wukv"]["w"], r, H, nope + m.v_head_dim)
    w_uk, w_uv = wukv[..., :nope], wukv[..., nope:]          # [r,H,*]
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk.float())
    scale = attn.scale_of(nope + rope)

    def mla_stats(ckv_seg, krope_seg, length):
        S = ckv_seg.shape[1]
        s = (L.einsum_f32("bqhr,bsr->bhqs", q_lat.to(ckv_seg.dtype), ckv_seg)
             + L.einsum_f32("bqhn,bsxn->bhqs", q_rope.to(krope_seg.dtype),
                            krope_seg[:, :, 0:1]))
        s = L.shard_hint(s * scale, "__dp__", None, None, "model")
        valid = attn.valid_positions(S, length, h.device)
        s = s.masked_fill(~valid[:, None, None, :], attn.NEG_INF)
        mm = torch.amax(s, dim=-1)
        pr = torch.exp(s - mm[..., None])
        ctx = L.einsum_f32("bhqs,bsr->bqhr", pr.to(ckv_seg.dtype), ckv_seg)
        return ctx, mm, torch.sum(pr, dim=-1)

    pre = mla_stats(cache["ckv"], cache["krope"],
                    torch.clamp_max(cache["plen"], cache["ckv"].shape[1]))
    tail = mla_stats(ckv_tail, krope_tail, tpos + 1)
    ctx_lat = attn.merge_attention([pre, tail], torch.float32)
    o = torch.einsum("bqhr,rhv->bqhv", ctx_lat, w_uv.float()).to(h.dtype)
    return o, dict(cache, ckv_tail=ckv_tail, krope_tail=krope_tail)


def block_decode(params: Dict, cfg: ArchConfig, kind: str, moe_on: bool,
                 x_t: torch.Tensor, cache: Dict, pos: int):
    """x_t: [B,1,d]; pos: the current length.  Cross-attention reads the
    context's keys and values cached at prefill (``xk``/``xv``)."""
    B = x_t.shape[0]
    hd, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    if kind in ("attn", "xattn"):
        with span("attn"):
            h = L.rmsnorm(params["norm1"], x_t, cfg.norm_eps)
            positions = torch.full((B, 1), pos, device=x_t.device)
            # two-tier cache: `plen` tokens live in the prefix, the newest
            # (pos - plen + 1) in the ring tail; writes touch only the tail
            plen = cache["plen"]
            tpos = torch.clamp_min(pos - plen, 0) % KV_TAIL
            if cfg.mla is not None:
                o, cache = _mla_decode(params, cfg, h, cache, positions, tpos)
                x_t = x_t + L.linear(params["wo"], L.reshape(o, B, 1, -1))
            else:
                q = L.reshape(L.linear(params["wq"], h), B, 1, H, hd)
                k = L.reshape(L.linear(params["wk"], h), B, 1, Hk, hd)
                v = L.reshape(L.linear(params["wv"], h), B, 1, Hk, hd)
                if cfg.rope:
                    q = L.apply_rope(q, positions, cfg.rope_theta)
                    k = L.apply_rope(k, positions, cfg.rope_theta)
                S = cache["k"].shape[1]
                kt, vt = attn.cache_update(cache["k_tail"], cache["v_tail"], k,
                                           v, tpos)
                # prefix: a ring of the last <= S tokens (== the window for
                # sliding-window archs); tail: the newest tpos + 1 tokens
                pre = attn.decode_attention_stats(q, cache["k"], cache["v"],
                                                  torch.clamp_max(plen, S))
                tail = attn.decode_attention_stats(q, kt, vt, tpos + 1)
                o = attn.merge_attention([pre, tail], x_t.dtype)
                x_t = x_t + L.linear(params["wo"], L.reshape(o, B, 1, H * hd))
                cache = dict(cache, k_tail=kt, v_tail=vt)
            if kind == "xattn" and "xk" in cache:
                hx = L.rmsnorm(params["x_norm"], x_t, cfg.norm_eps)
                qx = L.reshape(L.linear(params["x_wq"], hx), B, 1, H, hd)
                ox = attn.decode_attention(qx, cache["xk"], cache["xv"],
                                           cache["xk"].shape[1])
                gate = torch.tanh(params["x_gate"].float()).to(x_t.dtype)
                x_t = x_t + gate * L.linear(params["x_wo"],
                                            L.reshape(ox, B, 1, H * hd))
    elif kind == "mamba":
        x_t, cache = _mamba_decode(params, cfg, x_t, cache)
    elif kind == "mlstm":
        x_t, cache = _mlstm_decode(params, cfg, x_t, cache)
    elif kind == "slstm":
        x_t, cache = _slstm_decode(params, cfg, x_t, cache)
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0 and kind not in ("mlstm", "slstm"):
        x_t = _ffn(params, cfg, x_t)
    return x_t, cache


def init_cache(cfg: ArchConfig, kind: str, batch: int, cache_len: int,
               dtype, device) -> Dict:
    hd, Hk = cfg.head_dim, cfg.n_kv_heads
    z = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    if kind in ("attn", "xattn"):
        S = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
            else cache_len
        if cfg.mla is not None:
            m = cfg.mla
            c = dict(ckv=z((batch, S, m.kv_lora_rank)),
                     krope=z((batch, S, 1, m.qk_rope_head_dim)),
                     ckv_tail=z((batch, KV_TAIL, m.kv_lora_rank)),
                     krope_tail=z((batch, KV_TAIL, 1, m.qk_rope_head_dim)),
                     plen=z((), torch.int32))
        else:
            c = dict(k=z((batch, S, Hk, hd)), v=z((batch, S, Hk, hd)),
                     k_tail=z((batch, KV_TAIL, Hk, hd)),
                     v_tail=z((batch, KV_TAIL, Hk, hd)),
                     plen=z((), torch.int32))
        if kind == "xattn":
            c["xk"] = z((batch, cfg.n_context_tokens, Hk, hd))
            c["xv"] = z((batch, cfg.n_context_tokens, Hk, hd))
        return c
    if kind == "mamba":
        mc = cfg.mamba or MambaConfig()
        di = mc.expand * cfg.d_model
        return dict(conv=z((batch, mc.d_conv - 1, di)),
                    ssm=z((batch, di, mc.d_state), torch.float32))
    if kind == "mlstm":
        di, dqk, H = _xlstm_dims(cfg)
        return dict(C=z((batch, H, dqk // H, di // H), torch.float32))
    if kind == "slstm":
        di, _, _ = _xlstm_dims(cfg)
        return dict(h=z((batch, di), torch.float32),
                    c=z((batch, di), torch.float32))
    raise ValueError(kind)
