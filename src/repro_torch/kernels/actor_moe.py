"""Fused MoE SAC actor forward (paper Fig. 2, Eq. 54): plain version and
the wrapper of the CUDA kernel ``csrc/actor_moe.cu``.

Replaces the TPU kernel ``repro/kernels/actor_moe.py`` (``_actor_kernel``).
Outputs are the flat-head view of ``networks.actor_forward``: discrete
logits [B, 20], tanh'd means [B, 30], log-stds clipped to [-20, 2] [B, 30]
and the gate probabilities [B, 4].
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
STATE_DIM, HIDDEN, N_EXPERTS, N_DISC_OUT, N_CONT = 52, 256, 4, 20, 30
PARAM_NAMES = ("gate", "l1", "l2", "disc", "mu", "log_std")

launches = 0   # CUDA launches of the kernel (one per wrapper call on CUDA)


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def actor_forward_plain(params: Dict, s: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version: differentiable, any device."""
    g = torch.softmax(s @ params["gate"], dim=-1)                     # Eq. 54
    h1 = _gelu(torch.einsum("bs,kso->bko", s, params["l1"]["w"])
               + params["l1"]["b"])
    h2 = _gelu(torch.einsum("bkh,kho->bko", h1, params["l2"]["w"])
               + params["l2"]["b"])

    def head(name):
        out = (torch.einsum("bkh,kho->bko", h2, params[name]["w"])
               + params[name]["b"])
        return torch.einsum("bk,bko->bo", g, out)

    return (head("disc"), torch.tanh(head("mu")),
            torch.clamp(head("log_std"), LOG_STD_MIN, LOG_STD_MAX), g)


def _flat_params(params: Dict):
    return (params["gate"], params["l1"]["w"], params["l1"]["b"],
            params["l2"]["w"], params["l2"]["b"],
            params["disc"]["w"], params["disc"]["b"],
            params["mu"]["w"], params["mu"]["b"],
            params["log_std"]["w"], params["log_std"]["b"])


_SHAPES = ((STATE_DIM, N_EXPERTS),
           (N_EXPERTS, STATE_DIM, HIDDEN), (N_EXPERTS, HIDDEN),
           (N_EXPERTS, HIDDEN, HIDDEN), (N_EXPERTS, HIDDEN),
           (N_EXPERTS, HIDDEN, N_DISC_OUT), (N_EXPERTS, N_DISC_OUT),
           (N_EXPERTS, HIDDEN, N_CONT), (N_EXPERTS, N_CONT),
           (N_EXPERTS, HIDDEN, N_CONT), (N_EXPERTS, N_CONT))


def actor_forward_cuda(params: Dict, s: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel on ``s``'s device and current stream: one
    launch, which allocates nothing (the outputs are allocated here)."""
    global launches
    weights = _flat_params(params)
    for t, shape in zip((s,) + weights,
                        ((s.shape[0], STATE_DIM),) + _SHAPES):
        if t.device != s.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(
                f"actor_moe: expected contiguous, 16-byte aligned float32 "
                f"{shape} on {s.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    b = s.shape[0]
    dev = s.device
    disc = torch.empty((b, N_DISC_OUT), dtype=torch.float32, device=dev)
    mu = torch.empty((b, N_CONT), dtype=torch.float32, device=dev)
    log_std = torch.empty((b, N_CONT), dtype=torch.float32, device=dev)
    gate = torch.empty((b, N_EXPERTS), dtype=torch.float32, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.actor_moe_forward(
        s.data_ptr(), *(w.data_ptr() for w in weights), disc.data_ptr(),
        mu.data_ptr(), log_std.data_ptr(), gate.data_ptr(), b, stream)
    build.check(rc, "actor_moe_forward")
    launches += 1
    return disc, mu, log_std, gate


def actor_forward(params: Dict, s: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Dispatch on the tensor's device: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor (no fallback between the two)."""
    if s.device.type == "cpu":
        return actor_forward_plain(params, s)
    if s.device.type == "cuda":
        with torch.no_grad():
            return actor_forward_cuda(params, s)
    raise ValueError(f"actor_moe: unsupported device {s.device}")
