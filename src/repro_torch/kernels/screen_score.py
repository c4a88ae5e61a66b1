"""Surrogate K-candidate screening scores (Eq. 67 path): plain version and
the wrapper of the CUDA kernel ``csrc/screen_score.cu``.

Replaces the TPU kernel ``repro/kernels/screen_score.py``
(``_screen_kernel``).  Scores are the scalarized log1p PPA proxy per
candidate, ``w_power*p0 + w_area*p2 - w_perf*p1`` (lower = better); the
argmin and gate select stay outside (``ppa.surrogate.screen_batch``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

STATE_DIM, N_CONT, H1, H2, N_TARGETS, K_MAX = 52, 30, 128, 64, 3, 8

launches = 0   # CUDA launches of the kernel (one per wrapper call on CUDA)


def screen_scores_plain(params: Dict, s: torch.Tensor, cand: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version.  s [B,S]; cand [B,K,C]; weights [B,3]
    (w_perf, w_power, w_area) -> [B,K]."""
    bsz, k = cand.shape[0], cand.shape[1]
    x = torch.cat([s[:, None, :].expand(bsz, k, s.shape[-1]), cand], dim=-1)
    gelu = lambda v: F.gelu(v, approximate="tanh")
    h = gelu(x @ params["l1"]["w"] + params["l1"]["b"])
    h = gelu(h @ params["l2"]["w"] + params["l2"]["b"])
    pred = h @ params["head"]["w"] + params["head"]["b"]
    return (weights[:, None, 1] * pred[..., 0]
            + weights[:, None, 2] * pred[..., 2]
            - weights[:, None, 0] * pred[..., 1])


def screen_scores_cuda(params: Dict, s: torch.Tensor, cand: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on ``s``'s device and current stream."""
    global launches
    b, k = cand.shape[0], cand.shape[1]
    if not 1 <= k <= K_MAX:
        raise ValueError(f"screen_score: K must be in [1, {K_MAX}], got {k}")
    ws = (params["l1"]["w"], params["l1"]["b"], params["l2"]["w"],
          params["l2"]["b"], params["head"]["w"], params["head"]["b"])
    shapes = ((b, STATE_DIM), (b, k, N_CONT), (b, 3),
              (STATE_DIM + N_CONT, H1), (H1,), (H1, H2), (H2,),
              (H2, N_TARGETS), (N_TARGETS,))
    for t, shape in zip((s, cand, weights) + ws, shapes):
        if t.device != s.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"screen_score: expected contiguous float32 {shape} on "
                f"{s.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if ws[0].data_ptr() % 16 or ws[2].data_ptr() % 16:
        raise ValueError("screen_score: l1 and l2 weights must be 16-byte "
                         "aligned (the kernel copies them with tensor "
                         "copies)")
    score = torch.empty((b, k), dtype=torch.float32, device=s.device)
    lib = build.library()
    stream = torch.cuda.current_stream(s.device).cuda_stream
    rc = lib.screen_score_forward(
        s.data_ptr(), cand.data_ptr(), weights.data_ptr(),
        *(w.data_ptr() for w in ws), score.data_ptr(), b, k, stream)
    build.check(rc, "screen_score_forward")
    launches += 1
    return score


def screen_scores(params: Dict, s: torch.Tensor, cand: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Dispatch on the tensor's device: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor (no fallback between the two)."""
    if s.device.type == "cpu":
        return screen_scores_plain(params, s, cand, weights)
    if s.device.type == "cuda":
        with torch.no_grad():
            return screen_scores_cuda(params, s, cand, weights)
    raise ValueError(f"screen_score: unsupported device {s.device}")
