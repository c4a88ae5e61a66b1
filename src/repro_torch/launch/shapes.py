"""The assigned input-shape sets and shape-only stand-ins a cell (port of
``repro.launch.shapes``).

Shapes (assignment):
  train_4k     seq 4,096   global_batch 256   -> train step
  prefill_32k  seq 32,768  global_batch 32    -> prefill step
  decode_32k   seq 32,768  global_batch 128   -> serve step (1 new token)
  long_500k    seq 524,288 global_batch 1     -> serve step, sub-quadratic
                                                 archs only (skips recorded)

``input_specs`` returns tensors that hold no data, in place of the
reference's ``ShapeDtypeStruct``: meta tensors by default, or, under a
``FakeTensorMode``, fake tensors on the device asked for (the dry-run's
fake ``cuda`` tensors), stub modality frontends (precomputed frame and
patch embeddings) included.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

SHAPES: Dict[str, Dict] = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# archs with a sub-quadratic / O(window) long-context mechanism
LONG_OK = ("mixtral-8x7b", "jamba-v0.1-52b", "xlstm-1.3b")


def cell_supported(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and cfg.name not in LONG_OK and not cfg.subquadratic:
        return False, ("SKIP: pure full-attention arch, O(L) KV at 500k has "
                       "no architectural sub-quadratic mechanism "
                       "(DESIGN.md long_500k skip list)")
    return True, ""


def sds(shape, dtype, device="meta") -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def ctx_spec(cfg: ArchConfig, batch: int, device="meta"
             ) -> Optional[torch.Tensor]:
    """Stub modality frontend: precomputed frame/patch embeddings."""
    dt = L.dtype_of(cfg.param_dtype)
    if cfg.is_encdec:
        return sds((batch, cfg.n_audio_frames, cfg.d_model), dt, device)
    if cfg.family == "vlm" and cfg.n_context_tokens:
        return sds((batch, cfg.n_context_tokens, cfg.d_model), dt, device)
    return None


def input_specs(cfg: ArchConfig, shape: str, device="meta"
                ) -> Dict[str, torch.Tensor]:
    """Shape-only stand-ins for every model input of this cell (int32
    tokens, as the reference's)."""
    info = SHAPES[shape]
    S, B = info["seq_len"], info["global_batch"]
    if info["kind"] == "train":
        out = dict(tokens=sds((B, S), torch.int32, device),
                   labels=sds((B, S), torch.int32, device))
    elif info["kind"] == "prefill":
        out = dict(tokens=sds((B, S), torch.int32, device))
    else:  # decode: one new token against a seq_len KV cache
        out = dict(token=sds((B, 1), torch.int32, device),
                   pos=sds((), torch.int32, device))
    c = ctx_spec(cfg, B, device)
    if c is not None and info["kind"] != "decode":
        out["ctx"] = c
    return out
