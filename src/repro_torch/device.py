"""Device selection and per-device constant caching for the port.

Entry points take an explicit ``device`` and default to ``"cuda"``.  A
CUDA request on a machine without a usable card raises: nothing moves to
the CPU unless the caller asked for it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def resolve(device="cuda") -> torch.device:
    """``device`` (str or torch.device) -> torch.device, or raise.

    On CUDA, TF32 is switched off for matmuls and cuDNN so float32 stays
    full float32, as in the reference."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


_CONST: Dict[Tuple[int, str], Tuple[np.ndarray, torch.Tensor]] = {}


def const(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A module-level numpy constant as a tensor on ``device``, copied to
    the device once and cached (keyed by the array's identity)."""
    key = (id(arr), str(device))
    hit = _CONST.get(key)
    if hit is None:
        hit = _CONST[key] = (arr, torch.as_tensor(arr, device=device))
    return hit[1]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never a view of a CPU tensor's storage, so
    callers may mutate it without touching device-side state)."""
    return t.detach().cpu().numpy().copy()
