"""Plain float32 reference of published Jamba (AI21-Jamba2-Mini's
config.json, the Jamba v0.1 block of arXiv:2403.19887), and the layout of
its weights.

It computes, with plain PyTorch operations, what a configuration file's
``as_run`` section states: token embedding, a stack of periods whose
slots are attention or Mamba mixers, each followed by a SwiGLU
feed-forward block, dense or top-k mixture of experts, then a final
RMSNorm and the output head.  Every block is pre-norm with a residual.

- Attention: GQA, causal, no positional encoding (Jamba has none).
- Mamba (Mamba-1): in_proj to x and the gate z; a depthwise causal
  convolution of ``d_conv`` taps with a bias, then SiLU; x_proj to dt
  (``dt_rank`` wide), B and C (``d_state`` each), each through its own
  RMSNorm; dt_proj with a bias, then softplus; the selective scan
  ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t = C_t . h_t`` with
  ``A = -exp(a_log)``; the skip ``D x``, the gate ``SiLU(z)``, out_proj.
- Mixture of experts: the router's softmax, its top-k probabilities as
  the gates (not renormalised), and the serving semantics the file
  states under ``moe_dispatch``, as ``reference/lm.py`` reads them:
  prompt positions of a batch above ``dropless_max_tokens`` tokens are
  routed in groups of about ``group_tokens`` tokens, and a token past an
  expert's capacity in the group's order is dropped for that expert.

The scan runs in float32 over blocks of channels: a doubling scan
(log2 of the chunk rounds) inside each chunk of steps, then each chunk
continued from the last chunk's end state.  It reassociates the
products of the decays and the sums of the inputs, which float32 holds
far inside any limit of the comparison, and leaves out no term.

It reads the weights as ``leaf_specs`` lays them out (the tree that
``repro_torch.models.lm.forward`` takes) and casts each to float32 as it
goes.  ``precision="fp8"`` is the control: every product of a weight
(the projections, the experts, the router, the head) is taken after
rounding its operands to float8 e4m3, as ``reference/lm.py`` does.

A configuration names this module under ``reference``.  It imports torch
and its sibling ``reference/lm.py``'s helpers only.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import lm
from .lm import Ctx, gaps, rel_err  # noqa: F401  (the interface)

A_LOG_STD = 1.0       # a_log ~ N(0, 1): decays exp(-dt e^{a_log}) of all speeds
SCAN_CHUNK = 64       # steps a doubling scan covers
SCAN_ELEMS = 1 << 27  # float32 elements of one block of channels' states


def leaf_specs(c: Dict) -> List[tuple]:
    """(path, shape, dtype name, init) of every weight of ``as_run`` ``c``,
    in the tree of the port's ``init_params``, drawn with the harness's
    inits: as the port draws them (normal of std 1/sqrt(n_in) for a
    linear layer, 0.02 for the embedding and the router, 0.1 for the conv,
    zeros for the biases, ones for norms and the skip), except ``a_log``,
    a normal of std ``A_LOG_STD`` where the port takes log(1..d_state)."""
    d, V, dt = c["d_model"], c["vocab"], c["param_dtype"]
    H, Hk, f = c["n_heads"], c["n_kv_heads"], c["d_ff"]
    mc = c["mamba"]
    di, N, R, K = mc["expand"] * d, mc["d_state"], mc["dt_rank"], mc["d_conv"]
    hd = d // H
    lead = (c["n_layers"] // len(c["period"]),)
    specs = [(("embed", "w"), (V, d), dt, ("normal", 0.02))]

    def lin(path, n_in, n_out, std=None):
        specs.append((path + ("w",), lead + (n_in, n_out), dt,
                      ("normal", std if std is not None
                       else 1.0 / math.sqrt(n_in))))

    def leaf(path, shape, dtn, init):
        specs.append((path, lead + shape, dtn, init))

    for j, (kind, moe_on) in enumerate(lm.slot_kinds(c)):
        b = ("blocks", f"p{j}")
        leaf(b + ("norm1", "scale"), (d,), dt, ("ones",))
        if kind == "attn":
            lin(b + ("wq",), d, H * hd)
            lin(b + ("wk",), d, Hk * hd)
            lin(b + ("wv",), d, Hk * hd)
            lin(b + ("wo",), H * hd, d)
        elif kind == "mamba":
            lin(b + ("in_proj",), d, 2 * di)
            leaf(b + ("conv_w",), (K, di), dt, ("normal", 0.1))
            leaf(b + ("conv_b",), (di,), dt, ("zeros",))
            lin(b + ("x_proj",), di, R + 2 * N)
            leaf(b + ("dt_bias",), (di,), "float32", ("zeros",))
            lin(b + ("dt_w",), R, di)
            leaf(b + ("a_log",), (di, N), "float32", ("normal", A_LOG_STD))
            leaf(b + ("d_skip",), (di,), "float32", ("ones",))
            lin(b + ("out_proj",), di, d)
            for name, n in (("dt_norm", R), ("b_norm", N), ("c_norm", N)):
                leaf(b + (name, "scale"), (n,), dt, ("ones",))
        else:
            raise ValueError(f"slot kind {kind!r}")
        leaf(b + ("norm2", "scale"), (d,), dt, ("ones",))
        if moe_on:
            E = c["moe"]["n_experts"]
            lin(b + ("router",), d, E, 0.02)
            for name, shape, n_in in (("e_gate", (E, d, f), d),
                                      ("e_up", (E, d, f), d),
                                      ("e_down", (E, f, d), f)):
                leaf(b + (name,), shape, dt, ("normal", 1.0 / math.sqrt(n_in)))
        else:
            lin(b + ("w_gate",), d, f)
            lin(b + ("w_up",), d, f)
            lin(b + ("w_down",), f, d)
    specs.append((("final_norm", "scale"), (d,), dt, ("ones",)))
    specs.append((("lm_head", "w"), (d, V), dt,
                  ("normal", 1.0 / math.sqrt(d))))
    return specs


def attn_block(p: Dict, c: Dict, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """Causal GQA attention with no positional encoding."""
    B, L, d = x.shape
    H, Hk = c["n_heads"], c["n_kv_heads"]
    hd = d // H
    h = lm.rmsnorm(x, p["norm1"]["scale"], c["norm_eps"])
    q = ctx.mm(h, p["wq"]["w"]).reshape(B, L, H, hd)
    k = ctx.mm(h, p["wk"]["w"]).reshape(B, L, Hk, hd)
    v = ctx.mm(h, p["wv"]["w"]).reshape(B, L, Hk, hd)
    o = lm.attention(q, k, v, c.get("sliding_window", 0))
    return x + ctx.mm(o.reshape(B, L, H * hd), p["wo"]["w"])


def selective_scan(dt: torch.Tensor, b: torch.Tensor, cm: torch.Tensor,
                   x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """y [B, L, D] of ``h_t = exp(dt_t a) h_{t-1} + dt_t x_t b_t``,
    ``y_t = cm_t . h_t`` from h = 0: dt/x [B, L, D], b/cm [B, L, N],
    a [D, N], float32."""
    B, L, D = x.shape
    N = a.shape[1]
    ch = SCAN_CHUNK
    n_chunks = -(-L // ch)
    Lp = n_chunks * ch
    y = torch.empty_like(x)
    width = max(1, min(D, SCAN_ELEMS // (B * Lp * N)))
    for lo in range(0, D, width):
        hi = min(D, lo + width)
        dtc = dt[..., lo:hi]
        decay = torch.exp(dtc[..., None] * a[lo:hi])           # [B,L,w,N]
        u = (dtc * x[..., lo:hi])[..., None] * b[:, :, None, :]
        if Lp > L:      # steps past the end: decay 1, input 0
            decay = F.pad(decay, (0, 0, 0, 0, 0, Lp - L), value=1.0)
            u = F.pad(u, (0, 0, 0, 0, 0, Lp - L))
        shape = (B, n_chunks, ch, hi - lo, N)
        decay, u = decay.reshape(shape), u.reshape(shape)
        # inside each chunk: after the round of span k, step t holds the
        # product of the decays and the state from the 2k steps up to it
        k = 1
        while k < ch:
            u = torch.cat([u[:, :, :k],
                           torch.addcmul(u[:, :, k:], decay[:, :, k:],
                                         u[:, :, :-k])], dim=2)
            decay = torch.cat([decay[:, :, :k],
                               decay[:, :, k:] * decay[:, :, :-k]], dim=2)
            k *= 2
        # each chunk continued from the state at the previous chunk's end
        h = torch.zeros_like(u[:, 0, 0])
        start = []
        for i in range(n_chunks):
            start.append(h)
            h = u[:, i, -1] + decay[:, i, -1] * h
        u = torch.addcmul(u, decay, torch.stack(start, 1)[:, :, None])
        u = u.reshape(B, Lp, hi - lo, N)[:, :L]
        y[..., lo:hi] = (u * cm[:, :, None, :]).sum(-1)
        del decay, u, start
    return y


def mamba_block(p: Dict, c: Dict, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    B, L, d = x.shape
    mc, eps = c["mamba"], c["norm_eps"]
    N, R, K = mc["d_state"], mc["dt_rank"], mc["d_conv"]
    h = lm.rmsnorm(x, p["norm1"]["scale"], eps)
    xm, z = ctx.mm(h, p["in_proj"]["w"]).chunk(2, dim=-1)      # [B,L,di]
    # depthwise causal convolution: tap K - 1 weighs the newest input
    w = lm._f32(p["conv_w"])
    padded = F.pad(xm, (0, 0, K - 1, 0))
    conv = lm._f32(p["conv_b"]) + sum(padded[:, i:i + L] * w[i]
                                      for i in range(K))
    del padded
    xm = F.silu(conv)
    dt, bm, cm = ctx.mm(xm, p["x_proj"]["w"]).split([R, N, N], dim=-1)
    dt = lm.rmsnorm(dt, p["dt_norm"]["scale"], eps)
    bm = lm.rmsnorm(bm, p["b_norm"]["scale"], eps)
    cm = lm.rmsnorm(cm, p["c_norm"]["scale"], eps)
    dt = F.softplus(ctx.mm(dt, p["dt_w"]["w"]) + lm._f32(p["dt_bias"]))
    a = -torch.exp(lm._f32(p["a_log"]))
    y = selective_scan(dt, bm, cm, xm, a)
    y = (y + xm * lm._f32(p["d_skip"])) * F.silu(z)
    return x + ctx.mm(y, p["out_proj"]["w"])


def _route(p: Dict, ht: torch.Tensor, top_k: int, ctx: Ctx):
    """Softmax router, top-k; the k probabilities are the gates."""
    probs = torch.softmax(ctx.mm(ht, p["router"]["w"]), dim=-1)
    gv, idx = torch.topk(probs, top_k, dim=-1)
    return gv, idx


def moe(p: Dict, c: Dict, h: torch.Tensor, prompt_len: int, ctx: Ctx
        ) -> torch.Tensor:
    """h [B, L, d] -> the experts' sum [B, L, d]; positions below
    ``prompt_len`` are the prompt, dispatched with a capacity above
    ``dropless_max_tokens`` prompt tokens (``reference/lm.py``'s ``moe``
    with Jamba's gates)."""
    B, L, d = h.shape
    mc, disp = c["moe"], c["moe_dispatch"]
    k, E = mc["top_k"], mc["n_experts"]
    out = torch.zeros_like(h)
    S = min(prompt_len, L)
    rest = slice(0, L)
    if S > 0 and B * S > disp["dropless_max_tokens"]:
        g = lm._group_len(B, S, disp["group_tokens"])
        tg = B * g
        cap = max(1, int(disp["capacity_factor"] * k * tg / E))
        for lo in range(0, S, g):
            ht = h[:, lo:lo + g].reshape(tg, d)      # batch-major order
            gates, idx = _route(p, ht, k, ctx)
            onehot = F.one_hot(idx, E).sum(1)          # [t, E]
            before = torch.cumsum(onehot, dim=0) - onehot
            y = lm._experts(p, ht, gates, idx, before.gather(1, idx) < cap,
                            ctx)
            out[:, lo:lo + g] = y.reshape(B, g, d)
        rest = slice(S, L)
    hr = h[:, rest]
    if hr.shape[1]:
        ht = hr.reshape(-1, d)
        gates, idx = _route(p, ht, k, ctx)
        y = lm._experts(p, ht, gates, idx,
                        torch.ones_like(idx, dtype=torch.bool), ctx)
        out[:, rest] = y.reshape(hr.shape)
    return out


def ffn_block(p: Dict, c: Dict, x: torch.Tensor, prompt_len: int, ctx: Ctx
              ) -> torch.Tensor:
    h = lm.rmsnorm(x, p["norm2"]["scale"], c["norm_eps"])
    if "router" in p:
        return x + moe(p, c, h, prompt_len, ctx)
    z = F.silu(ctx.mm(h, p["w_gate"]["w"])) * ctx.mm(h, p["w_up"]["w"])
    return x + ctx.mm(z, p["w_down"]["w"])


MIXERS = {"attn": attn_block, "mamba": mamba_block}


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
    x = lm._f32(weights["embed"]["w"][tokens])
    n_periods = c["n_layers"] // len(c["period"])
    for i in range(n_periods):
        for j, (kind, _) in enumerate(lm.slot_kinds(c)):
            if kind not in MIXERS:
                raise ValueError(f"slot kind {kind!r}")
            p = lm._period(weights["blocks"][f"p{j}"], i)
            x = MIXERS[kind](p, c, x, ctx)
            x = ffn_block(p, c, x, prompt_len, ctx)
    xr = lm.rmsnorm(x[:, list(read)], weights["final_norm"]["scale"],
                    c["norm_eps"])
    return ctx.mm(xr, weights["lm_head"]["w"])
