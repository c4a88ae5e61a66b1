"""Design-point vector space (port of ``repro.ppa.config_space``).

The 30-dim design vector layout, bounds and quantisation steps are the
reference's; :func:`clip`, :func:`quantize` and :func:`project` act on
``(..., 30)`` float32 tensors on any device.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.device import const

FIELDS: List[Tuple[str, float, float, float]] = [
    ("mesh_w", 2, 64, 1),
    ("mesh_h", 2, 64, 1),
    ("sc_x", 1, 8, 1),
    ("sc_y", 1, 8, 1),
    ("fetch", 1, 16, 1),
    ("stanum", 1, 32, 1),
    ("vlen", 128, 2048, 128),
    ("dmem_kb", 16, 512, 16),
    ("wmem_kb", 256, 131072, 256),
    ("imem_kb", 1, 128, 1),
    ("dflit", 64, 8192, 64),
    ("xr_wp", 1, 16, 1),
    ("vr_wp", 1, 16, 1),
    ("xdpnum", 1, 16, 1),
    ("vdpnum", 1, 16, 1),
    ("freq_frac", 0.01, 1.0, 0.0),
    ("precision", 0.0, 1.0, 0.0),
    ("dmem_in_frac", 0.10, 0.80, 0.0),
    ("dmem_out_frac", 0.05, 0.50, 0.0),
    ("lb_alpha", 0.0, 1.0, 0.0),
    ("lb_beta", 0.0, 1.0, 0.0),
    ("rho_matmul", 0.0, 1.0, 0.0),
    ("rho_conv", 0.0, 1.0, 0.0),
    ("rho_general", 0.0, 1.0, 0.0),
    ("stream_in", 0.0, 1.0, 0.0),
    ("stream_out", 0.0, 1.0, 0.0),
    ("sub_matmul", 0.0, 1.0, 0.0),
    ("allreduce_frac", 0.0, 1.0, 0.0),
    ("kv_quant", 0, 2, 1),
    ("kv_window_frac", 0.05, 1.0, 0.0),
]

NAMES = [f[0] for f in FIELDS]
IDX: Dict[str, int] = {name: i for i, name in enumerate(NAMES)}
DIM = len(FIELDS)
LO = np.array([f[1] for f in FIELDS], dtype=np.float32)
HI = np.array([f[2] for f in FIELDS], dtype=np.float32)
STEP = np.array([f[3] for f in FIELDS], dtype=np.float32)
_STEPPED = STEP > 0
_STEP_SAFE = np.where(_STEPPED, STEP, np.float32(1.0)).astype(np.float32)

RHO_BASE = 0.3  # paper §3.5: default rho_base


def clip(cfg: torch.Tensor) -> torch.Tensor:
    """Project a raw vector into bounds (part of Eq. 68's Pi_C)."""
    return torch.clamp(cfg, const(LO, cfg.device), const(HI, cfg.device))


def quantize(cfg: torch.Tensor) -> torch.Tensor:
    """Snap discrete fields to hardware-supported steps (Table 7 note);
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    step = const(_STEP_SAFE, cfg.device)
    stepped = torch.where(const(_STEPPED, cfg.device),
                          torch.round(cfg / step) * step, cfg)
    return clip(stepped)


def project(cfg: torch.Tensor) -> torch.Tensor:
    """Full constraint projection Pi_C (Eq. 68): bounds + quantization."""
    return quantize(clip(cfg))


def default_config() -> np.ndarray:
    """Paper's initial mesh m0 neighbourhood: mid-range everything."""
    cfg = (LO + HI) / 2.0
    for name, v in dict(mesh_w=8, mesh_h=8, sc_x=2, sc_y=2, fetch=4,
                        stanum=4, vlen=512, dmem_kb=128, wmem_kb=8192,
                        imem_kb=8, dflit=1024, xr_wp=2, vr_wp=2, xdpnum=2,
                        vdpnum=2, freq_frac=1.0, precision=0.0,
                        dmem_in_frac=0.4, dmem_out_frac=0.2, lb_alpha=0.5,
                        lb_beta=0.5, rho_matmul=0.3, rho_conv=0.1,
                        rho_general=0.1, stream_in=0.5, stream_out=0.5,
                        sub_matmul=0.5, allreduce_frac=0.3, kv_quant=0,
                        kv_window_frac=1.0).items():
        cfg[IDX[name]] = v
    return cfg.astype(np.float32)
