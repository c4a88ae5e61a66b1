"""Plain float32 reference of the benchmark's decoder-only transformer
language models, and the layout of their weights.

It computes, with plain PyTorch operations, what a configuration file's
``as_run`` section states: token embedding, a stack of periods whose slots
are attention blocks (GQA, rotary positions, causal, an optional sliding
window), each followed by a SwiGLU feed-forward block, dense or top-k
mixture of experts, then a final RMSNorm and the output head.  The
mixture of experts follows the serving semantics the file states under
``moe_dispatch``: prompt positions of a batch above
``dropless_max_tokens`` tokens are routed in groups of about
``group_tokens`` tokens, and a token past an expert's capacity
(``capacity_factor`` x top_k x group tokens / experts) in the group's
order is dropped for that expert; generated positions and small prompts
are dropless.

It reads the weights as a nested dict of tensors laid out as
``leaf_specs`` states (leaves of slot ``p{j}`` stacked over periods, the
tree that ``repro_torch.models.lm.forward`` takes) and casts each to
float32 as it goes, layer by layer, so that only one
layer's float32 copy is alive at a time.  ``precision="fp8"`` is the
control: every product of a weight is taken after rounding its operands
to float8 e4m3 (weights per output column, activations per row).

A configuration names this module under ``reference``; a family of
models with other blocks brings a module of its own with the same
functions (``leaf_specs``, ``logits_at``, ``gaps``, ``rel_err``).  This
module imports torch and numpy only.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30
F8_MAX = 448.0


def leaf_specs(c: Dict) -> List[tuple]:
    """(path, shape, dtype name, init) of every weight of ``as_run`` ``c``;
    init is ("normal", std), ("zeros",) or ("ones",), as the port's
    ``init_params`` draws them."""
    d, V, dt = c["d_model"], c["vocab"], c["param_dtype"]
    H, Hk, f = c["n_heads"], c["n_kv_heads"], c["d_ff"]
    hd = d // H
    lead = (c["n_layers"] // len(c["period"]),)
    specs = [(("embed", "w"), (V, d), dt, ("normal", 0.02))]

    def lin(path, n_in, n_out, std=None):
        specs.append((path + ("w",), lead + (n_in, n_out), dt,
                      ("normal", std if std is not None
                       else 1.0 / math.sqrt(n_in))))

    for j, (kind, moe_on) in enumerate(slot_kinds(c)):
        if kind != "attn":
            raise ValueError(f"slot kind {kind!r}")
        b = ("blocks", f"p{j}")
        specs.append((b + ("norm1", "scale"), lead + (d,), dt, ("ones",)))
        lin(b + ("wq",), d, H * hd)
        lin(b + ("wk",), d, Hk * hd)
        lin(b + ("wv",), d, Hk * hd)
        lin(b + ("wo",), H * hd, d)
        specs.append((b + ("norm2", "scale"), lead + (d,), dt, ("ones",)))
        if moe_on:
            E = c["moe"]["n_experts"]
            lin(b + ("router",), d, E, 0.02)
            for name, shape, n_in in (("e_gate", (E, d, f), d),
                                      ("e_up", (E, d, f), d),
                                      ("e_down", (E, f, d), f)):
                specs.append((b + (name,), lead + shape, dt,
                              ("normal", 1.0 / math.sqrt(n_in))))
        else:
            lin(b + ("w_gate",), d, f)
            lin(b + ("w_up",), d, f)
            lin(b + ("w_down",), f, d)
    specs.append((("final_norm", "scale"), (d,), dt, ("ones",)))
    specs.append((("lm_head", "w"), (d, V), dt,
                  ("normal", 1.0 / math.sqrt(d))))
    return specs


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a scale per slice along ``dim``'s
    complement (amax over ``dim``), returned in float32."""
    amax = torch.clamp_min(x.abs().amax(dim=dim, keepdim=True), 1e-12)
    scale = amax / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Ctx:
    """Precision of the weight products: ``fp32`` (TF32 off) or ``fp8``."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 or fp8")
        self.precision = precision

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., n_in] @ w [n_in, n_out] in float32."""
        x, w = _f32(x), _f32(w)
        if self.precision == "fp8":
            x, w = _q8(x, -1), _q8(w, 0)
        return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * _f32(scale)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [B, L, heads, hd] rotated by position; the two halves of the head
    are the pair's parts."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(
        1.0 / (theta ** (np.arange(0, hd, 2) / hd)), dtype=torch.float32,
        device=x.device)
    ang = positions.to(torch.float32)[:, None] * freqs        # [L, hd/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int, q_block: int = 1024) -> torch.Tensor:
    """Causal GQA attention, one batch row at a time and ``q_block``
    queries at a time: q [B, L, H, hd], k/v [B, L, Hk, hd] -> [B, L, H, hd].
    Query head h reads key head h // (H // Hk)."""
    B, L, H, hd = q.shape
    Hk = k.shape[2]
    out = torch.empty_like(q)
    kp = torch.arange(L, device=q.device)
    for b in range(B):
        kb = torch.repeat_interleave(k[b].transpose(0, 1), H // Hk, dim=0)
        vb = torch.repeat_interleave(v[b].transpose(0, 1), H // Hk, dim=0)
        for lo in range(0, L, q_block):
            hi = min(L, lo + q_block)
            qb = q[b, lo:hi].transpose(0, 1)                  # [H, n, hd]
            s = torch.matmul(qb, kb.transpose(1, 2)) / math.sqrt(hd)
            qp = torch.arange(lo, hi, device=q.device)[:, None]
            keep = kp[None, :] <= qp
            if window > 0:
                keep = keep & (kp[None, :] > qp - window)
            s = s.masked_fill(~keep[None], NEG_INF)
            p = torch.softmax(s, dim=-1)
            out[b, lo:hi] = torch.matmul(p, vb).transpose(0, 1)
    return out


def attn_block(p: Dict, c: Dict, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    B, L, d = x.shape
    H, Hk = c["n_heads"], c["n_kv_heads"]
    hd = d // H
    h = rmsnorm(x, p["norm1"]["scale"], c["norm_eps"])
    pos = torch.arange(L, device=x.device)
    q = rope(ctx.mm(h, p["wq"]["w"]).reshape(B, L, H, hd), pos,
             c["rope_theta"])
    k = rope(ctx.mm(h, p["wk"]["w"]).reshape(B, L, Hk, hd), pos,
             c["rope_theta"])
    v = ctx.mm(h, p["wv"]["w"]).reshape(B, L, Hk, hd)
    o = attention(q, k, v, c.get("sliding_window", 0))
    return x + ctx.mm(o.reshape(B, L, H * hd), p["wo"]["w"])


def _route(p: Dict, ht: torch.Tensor, top_k: int, ctx: Ctx):
    """Softmax router, top-k, gates renormalised over the k."""
    probs = torch.softmax(ctx.mm(ht, p["router"]["w"]), dim=-1)
    idx = torch.topk(probs, top_k, dim=-1).indices
    gv = probs.gather(-1, idx)
    return gv / torch.clamp_min(gv.sum(-1, keepdim=True), 1e-9), idx


def _experts(p: Dict, ht: torch.Tensor, gates: torch.Tensor,
             idx: torch.Tensor, keep: torch.Tensor, ctx: Ctx
             ) -> torch.Tensor:
    """sum over kept (token, choice) of gate * expert(token), one expert at
    a time: ht [T, d], gates/idx/keep [T, k]."""
    out = torch.zeros_like(ht)
    for e in range(p["e_up"].shape[0]):
        tok, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = ht[tok]
        z = F.silu(ctx.mm(xe, p["e_gate"][e])) * ctx.mm(xe, p["e_up"][e])
        ye = ctx.mm(z, p["e_down"][e])
        out.index_add_(0, tok, ye * gates[tok, slot][:, None])
    return out


def _group_len(B: int, S: int, group_tokens: int) -> int:
    """Sequence positions in one dispatch group of a [B, S] prompt batch."""
    g = max(1, min(S, group_tokens // max(1, B)))
    while S % g:
        g -= 1
    return g


def moe(p: Dict, c: Dict, h: torch.Tensor, prompt_len: int, ctx: Ctx
        ) -> torch.Tensor:
    """h [B, L, d] -> the experts' sum [B, L, d].  Positions below
    ``prompt_len`` are the prompt: above ``dropless_max_tokens`` prompt
    tokens, dispatched in groups with a capacity; the rest are dropless."""
    B, L, d = h.shape
    mc, disp = c["moe"], c["moe_dispatch"]
    k, E = mc["top_k"], mc["n_experts"]
    out = torch.zeros_like(h)
    S = min(prompt_len, L)
    if S > 0 and B * S > disp["dropless_max_tokens"]:
        g = _group_len(B, S, disp["group_tokens"])
        tg = B * g
        cap = max(1, int(disp["capacity_factor"] * k * tg / E))
        for lo in range(0, S, g):
            ht = h[:, lo:lo + g].reshape(tg, d)      # batch-major order
            gates, idx = _route(p, ht, k, ctx)
            onehot = F.one_hot(idx, E).sum(1)          # [t, E]
            before = torch.cumsum(onehot, dim=0) - onehot
            pos = before.gather(1, idx)                # [t, k]
            y = _experts(p, ht, gates, idx, pos < cap, ctx)
            out[:, lo:lo + g] = y.reshape(B, g, d)
        rest = slice(S, L)
    else:
        rest = slice(0, L)
    hr = h[:, rest]
    if hr.shape[1]:
        ht = hr.reshape(-1, d)
        gates, idx = _route(p, ht, k, ctx)
        y = _experts(p, ht, gates, idx, torch.ones_like(idx, dtype=torch.bool),
                     ctx)
        out[:, rest] = y.reshape(hr.shape)
    return out


def ffn_block(p: Dict, c: Dict, x: torch.Tensor, prompt_len: int, ctx: Ctx
              ) -> torch.Tensor:
    h = rmsnorm(x, p["norm2"]["scale"], c["norm_eps"])
    if "router" in p:
        return x + moe(p, c, h, prompt_len, ctx)
    z = F.silu(ctx.mm(h, p["w_gate"]["w"])) * ctx.mm(h, p["w_up"]["w"])
    return x + ctx.mm(z, p["w_down"]["w"])


def slot_kinds(c: Dict) -> List[tuple]:
    """(kind, moe_on) of each slot of a period, from ``as_run``."""
    return [(s["kind"], s["moe"]) for s in c["period"]]


def _period(tree, i: int):
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    return tree[i]


@torch.no_grad()
def logits_at(weights: Dict, c: Dict, tokens: torch.Tensor,
              read: Sequence[int], prompt_len: int,
              precision: str = "fp32") -> torch.Tensor:
    """The logits [B, len(read), V] (float32) at sequence positions
    ``read`` of ``tokens`` [B, L], whose first ``prompt_len`` positions
    are the prompt and the rest generated tokens fed back."""
    if tokens.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctx = Ctx(precision)
    x = _f32(weights["embed"]["w"][tokens])
    n_periods = c["n_layers"] // len(c["period"])
    for i in range(n_periods):
        for j, (kind, _) in enumerate(slot_kinds(c)):
            p = _period(weights["blocks"][f"p{j}"], i)
            if kind != "attn":
                raise ValueError(f"slot kind {kind!r}")
            x = attn_block(p, c, x, ctx)
            x = ffn_block(p, c, x, prompt_len, ctx)
    xr = rmsnorm(x[:, list(read)], weights["final_norm"]["scale"],
                 c["norm_eps"])
    return ctx.mm(xr, weights["lm_head"]["w"])


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the row's best, in units of
    the row's standard deviation: ref_logits [..., V], tokens [...]."""
    best = ref_logits.amax(-1)
    got = ref_logits.gather(-1, tokens[..., None].long())[..., 0]
    return (best - got) / ref_logits.std(-1)


def rel_err(logits: torch.Tensor, ref_logits: torch.Tensor) -> torch.Tensor:
    """||logits - ref|| / ||ref - mean(ref)|| per row of [..., V]."""
    ref = ref_logits.float()
    centred = ref - ref.mean(-1, keepdim=True)
    return (logits.float() - ref).norm(dim=-1) / centred.norm(dim=-1)
