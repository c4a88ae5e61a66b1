"""Published peaks by device name (dense rates, no sparsity).

NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16/fp16 on the tensor cores,
67 TFLOP/s float32 outside them, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_flops=989e12, fp32_flops=67e12,
                                  hbm_bytes=3.35e12),
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    p = PEAKS.get(kind)
    return dict(p) if p is not None else None


def min_time(flops: float, bytes_: float, pk: Dict[str, float],
             flops_key: str):
    """(least time, the bound that sets it) for a call's work."""
    cand = {"operations": flops / pk[flops_key],
            "bytes": bytes_ / pk["hbm_bytes"]}
    bound = max(cand, key=cand.get)
    return cand[bound], bound
