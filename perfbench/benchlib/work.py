"""The work of a kernel's call, counted from shapes: what the inputs
need, whatever implements it (causal, and windowed, attention pairs only;
each input byte read once and each output byte written once).  A model's
work is counted by the module its configuration names under ``counts``
(``counts/lm.py``)."""
from __future__ import annotations

from typing import Dict

BF16 = 2


def causal_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs a causal mask (with a sliding window) keeps for
    S queries over the same S keys."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_attention_call(B: int, H: int, Hk: int, S: int, hd: int,
                         window: int, elem_bytes: int) -> Dict[str, float]:
    """A causal self-attention call's flops (QK^T and PV over the kept
    pairs) and bytes (q, k, v read once, o written once)."""
    return dict(flops=4.0 * B * H * hd * causal_pairs(S, window),
                bytes=float(elem_bytes) * B * S * hd * (2 * H + 2 * Hk))
