"""Design-point vector space (port of ``repro.ppa.config_space``).

The 30-dim design vector layout, bounds and quantisation steps are the
reference's; :func:`clip`, :func:`quantize` and :func:`project` act on
``(..., 30)`` float32 tensors on any device.  The host helpers (field
access, dict round trips, :func:`random_config` and the paper's anchor
configurations) take and return numpy vectors, as the reference's do.
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


def get(cfg, name: str):
    return cfg[..., IDX[name]]


def set_field(cfg, name: str, value):
    """A copy of ``cfg`` (numpy array or tensor) with field ``name`` set."""
    out = cfg.clone() if isinstance(cfg, torch.Tensor) else np.array(cfg)
    out[..., IDX[name]] = value
    return out


def to_dict(cfg) -> Dict[str, float]:
    arr = np.asarray(cfg, dtype=np.float64)
    return {name: float(arr[..., i]) for i, name in enumerate(NAMES)}


def from_dict(d: Dict[str, float]) -> np.ndarray:
    cfg = default_config()
    for k, v in d.items():
        cfg[IDX[k]] = v
    return cfg


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


def random_config(rng: np.random.Generator) -> np.ndarray:
    """Uniform sample in bounds (the random-search baseline of Table 21):
    the reference's numpy draw, projected on the CPU."""
    cfg = rng.uniform(LO, HI).astype(np.float32)
    return project(torch.as_tensor(cfg)).numpy()


def _with(cfg: np.ndarray, **fields) -> np.ndarray:
    for k, v in fields.items():
        cfg[IDX[k]] = v
    return cfg


def paper_llama_3nm_config() -> np.ndarray:
    """The paper's reported best 3nm configuration for Llama 3.1 8B
    (Tables 9/14/16): mesh 41x42, VLEN mix averaging 1536, FETCH ~2.5,
    DFLIT 2048, STANUM 3, DMEM 64 KB, IMEM 6 KB, f = f_max."""
    return _with(default_config(), mesh_w=41, mesh_h=42, sc_x=4, sc_y=4,
                 fetch=2.5, stanum=3, vlen=1536, dmem_kb=64, wmem_kb=9800,
                 imem_kb=6, dflit=2048, xr_wp=2, vr_wp=2, xdpnum=2, vdpnum=2,
                 freq_frac=1.0, precision=0.0, rho_matmul=0.55, rho_conv=0.1,
                 rho_general=0.2, kv_quant=0, kv_window_frac=1.0)


def paper_smolvlm_config(f_max_hz: float = 1e9) -> np.ndarray:
    """Paper Table 19 SmolVLM low-power point: 2x4 mesh @ 10 MHz ABSOLUTE
    (freq_frac is relative to the node's f_max, so it is node-dependent)."""
    cfg = paper_smolvlm_3nm_config()
    cfg[IDX["freq_frac"]] = float(np.clip(1e7 / f_max_hz, 0.01, 1.0))
    return cfg


def paper_smolvlm_3nm_config() -> np.ndarray:
    """Paper Table 19 SmolVLM low-power 3nm point: 2x4 mesh @ 10 MHz."""
    return _with(default_config(), mesh_w=2, mesh_h=4, sc_x=1, sc_y=1,
                 fetch=1, stanum=1, vlen=512, dmem_kb=32, wmem_kb=81920,
                 imem_kb=2, dflit=256, xr_wp=1, vr_wp=1, xdpnum=1, vdpnum=1,
                 freq_frac=0.01, precision=0.0, kv_quant=1,
                 kv_window_frac=0.5)
