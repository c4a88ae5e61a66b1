"""The work a request of a decoder-only transformer LM needs, counted
from shapes: model flops of a prefill and of a decode step, and the bytes
a decode step must move.  They count what the inputs need, whatever
implements it: active experts only, no capacity padding, causal (and
windowed) attention pairs only, the output head at the positions whose
token is served, each input byte read once and each output byte written
once.  ``c`` is a configuration's ``as_run``; a configuration names this
module under ``counts``, and a family with other blocks brings its own."""
from __future__ import annotations

from typing import Dict, Optional

from benchlib.work import BF16, causal_pairs


def _dims(c: Dict):
    d, H, Hk = c["d_model"], c["n_heads"], c["n_kv_heads"]
    return d, H, Hk, d // H


def _moe_layers(c: Dict):
    """Whether each layer's feed-forward block is a mixture of experts."""
    n_per = c["n_layers"] // len(c["period"])
    return [s["moe"] for _ in range(n_per) for s in c["period"]]


def n_attn_layers(c: Dict) -> int:
    return c["n_layers"]


def _token_flops(c: Dict) -> float:
    """Matrix flops a token needs in every layer, attention's pairs and
    the head left out."""
    d, H, Hk, hd = _dims(c)
    f = c["d_ff"]
    total = 0.0
    for moe in _moe_layers(c):
        total += 2 * d * (H * hd + 2 * Hk * hd) + 2 * H * hd * d
        if moe:
            E, k = c["moe"]["n_experts"], c["moe"]["top_k"]
            total += 2 * d * E + k * 3 * 2 * d * f
        else:
            total += 3 * 2 * d * f
    return total


def attention_pair_flops(c: Dict, B: int, S: int) -> float:
    """QK^T and PV over the kept pairs, every attention layer."""
    d, H, Hk, hd = _dims(c)
    return n_attn_layers(c) * 4.0 * B * H * hd * causal_pairs(
        S, c.get("sliding_window", 0))


def prefill_flops(c: Dict, B: int, S: int) -> float:
    """Model flops of prefilling B prompts of S tokens and reading the
    first token's logits."""
    return (B * S * _token_flops(c) + attention_pair_flops(c, B, S)
            + B * 2.0 * c["d_model"] * c["vocab"])


def decode_step_flops(c: Dict, B: int, ctx_len: int) -> float:
    """Model flops of one decode step of B tokens at ``ctx_len`` positions
    (the new one included)."""
    d, H, Hk, hd = _dims(c)
    w = c.get("sliding_window", 0)
    keys = min(ctx_len, w) if w > 0 else ctx_len
    return (B * _token_flops(c) + n_attn_layers(c) * 4.0 * B * H * hd * keys
            + B * 2.0 * d * c["vocab"])


def decode_step_bytes(c: Dict, B: int, ctx_len: int,
                      experts_routed: Optional[list] = None) -> float:
    """Bytes one decode step must move: every weight it reads once (of the
    experts, those routed: ``experts_routed[i]`` distinct experts in the
    i-th MoE layer, all of them when not given), the KV cache's valid
    positions, the new KV entries, and the embedding rows and logits."""
    d, H, Hk, hd = _dims(c)
    f, V = c["d_ff"], c["vocab"]
    w = c.get("sliding_window", 0)
    keys = min(ctx_len, w) if w > 0 else ctx_len
    total = B * d * BF16 + d * V * BF16 + B * V * BF16 + d * BF16
    moe_i = 0
    for moe in _moe_layers(c):
        total += 2 * d * BF16                                   # norms
        total += (d * (H * hd + 2 * Hk * hd) + H * hd * d) * BF16
        total += 2 * B * keys * Hk * hd * BF16                  # K, V read
        total += 2 * B * Hk * hd * BF16                         # new K, V
        if moe:
            E = c["moe"]["n_experts"]
            n = E if experts_routed is None else experts_routed[moe_i]
            moe_i += 1
            total += (d * E + n * 3 * d * f) * BF16
        else:
            total += 3 * d * f * BF16
    return total
