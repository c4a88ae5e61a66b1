"""The work a request of published Jamba needs, counted from shapes, with
the functions of ``counts/lm.py``: model flops of a prefill and of a
decode step and the bytes a decode step must move, counting what the
inputs need (active experts only, no capacity padding, causal attention
pairs only, the head at the positions whose token is served, each input
byte read once and each output byte written once).  Slots of a period
are attention (GQA, no positions) or Mamba mixers; ``n_attn_layers``
counts the attention layers only.  ``ssm_scan_call`` is the selective
scan's work, as the ``ssm_scan`` kernel computes it.  ``c`` is a
configuration's ``as_run``."""
from __future__ import annotations

from typing import Dict, Optional

from benchlib.work import BF16, causal_pairs

F32 = 4


def _dims(c: Dict):
    d, H, Hk = c["d_model"], c["n_heads"], c["n_kv_heads"]
    return d, H, Hk, d // H


def _mamba_dims(c: Dict):
    m = c["mamba"]
    return m["expand"] * c["d_model"], m["d_state"], m["dt_rank"], \
        m["d_conv"]


def _layers(c: Dict):
    """(kind, moe) of every layer, periods in order."""
    n_per = c["n_layers"] // len(c["period"])
    return [(s["kind"], s["moe"]) for _ in range(n_per) for s in c["period"]]


def n_attn_layers(c: Dict) -> int:
    return sum(kind == "attn" for kind, _ in _layers(c))


def n_mamba_layers(c: Dict) -> int:
    return sum(kind == "mamba" for kind, _ in _layers(c))


def ssm_scan_call(B: int, S: int, D: int, N: int) -> Dict[str, float]:
    """A selective scan's flops (per batch row, step, channel and state:
    dt a, the decayed state plus the input times B, and C times the state
    summed, 6; per channel and step dt x, 1), exponentials (exp(dt a), one
    a state-step) and bytes (dt, x, B and C read once in float32, A read
    once, y and the final state written once)."""
    return dict(flops=6.0 * B * S * D * N + 1.0 * B * S * D,
                exps=1.0 * B * S * D * N,
                bytes=float(F32) * (2 * B * S * D + 2 * B * S * N + D * N
                                    + B * S * D + B * D * N))


def _mamba_token_flops(c: Dict) -> float:
    """A Mamba mixer's flops a token, its scan's included."""
    d = c["d_model"]
    di, N, R, K = _mamba_dims(c)
    return (2 * d * 2 * di + 2 * K * di + 2 * di * (R + 2 * N)
            + 2 * R * di + 2 * di * d) + ssm_scan_call(1, 1, di, N)["flops"]


def _token_flops(c: Dict) -> float:
    """Flops a token needs in every layer, attention's pairs and the head
    left out."""
    d, H, Hk, hd = _dims(c)
    f = c["d_ff"]
    total = 0.0
    for kind, moe in _layers(c):
        if kind == "attn":
            total += 2 * d * (H * hd + 2 * Hk * hd) + 2 * H * hd * d
        else:
            total += _mamba_token_flops(c)
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
    return (B * _token_flops(c) + n_attn_layers(c) * 4.0 * B * H * hd
            * ctx_len + B * 2.0 * d * c["vocab"])


def decode_step_bytes(c: Dict, B: int, ctx_len: int,
                      experts_routed: Optional[list] = None) -> float:
    """Bytes one decode step must move: every weight it reads once (of the
    experts, those routed: ``experts_routed[i]`` distinct experts in the
    i-th MoE layer, all of them when not given), the KV cache's valid
    positions and the new KV entries, each Mamba mixer's conv and scan
    state read and written, and the embedding rows and logits."""
    d, H, Hk, hd = _dims(c)
    di, N, R, K = _mamba_dims(c)
    f, V = c["d_ff"], c["vocab"]
    total = B * d * BF16 + d * V * BF16 + B * V * BF16 + d * BF16
    moe_i = 0
    for kind, moe in _layers(c):
        total += 2 * d * BF16                                   # norms
        if kind == "attn":
            total += (d * (H * hd + 2 * Hk * hd) + H * hd * d) * BF16
            total += 2 * B * ctx_len * Hk * hd * BF16           # K, V read
            total += 2 * B * Hk * hd * BF16                     # new K, V
        else:
            total += (d * 2 * di + K * di + di + di * (R + 2 * N)
                      + R * di + di * d + (R + 2 * N)) * BF16
            total += (2 * di + di * N) * F32    # dt bias, skip, a_log
            total += 2 * B * ((K - 1) * di * BF16 + di * N * F32)  # states
        if moe:
            E = c["moe"]["n_experts"]
            n = E if experts_routed is None else experts_routed[moe_i]
            moe_i += 1
            total += (d * E + n * 3 * d * f) * BF16
        else:
            total += 3 * d * f * BF16
    return total
