"""State encoder — paper Table 2 (port of ``repro.core.state``): 73-dim
full state, 52-dim SAC subset.

Only the batched encoder of the vectorised engine is ported; its column
order and scaling are the reference's :func:`repro.core.state.encode_vec`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import const
from repro_torch.ppa import config_space as cs
from repro_torch.ppa.analytic import M_IDX, NODE_IDX
from repro_torch.workload.features import WL_IDX

STATE_DIM = 73
SAC_STATE_DIM = 52

# 21 indices excluded from the SAC subset (73 - 52); see the reference.
DROPPED_IDX = np.array([
    7, 8, 16, 17, 18, 24, 25, 28, 32, 38, 39, 43, 44, 49, 59, 62, 64, 66,
    69, 71, 21,
], dtype=np.int32)
assert len(set(DROPPED_IDX.tolist())) == STATE_DIM - SAC_STATE_DIM

KEPT_IDX = np.array([i for i in range(STATE_DIM)
                     if i not in set(DROPPED_IDX.tolist())], dtype=np.int64)


def encode_vec(wl, cfg, metrics, node, part_stats) -> torch.Tensor:
    """wl (WL_DIM,) shared workload features; cfg (B, 30); metrics
    (B, M_DIM); node (B, NODE_DIM); part_stats (B, 8) -> (B, 73) float32."""
    b = cfg.shape[0]
    w = lambda n: wl[WL_IDX[n]].expand(b)
    c = lambda n: cfg[:, cs.IDX[n]]
    m = lambda n: metrics[:, M_IDX[n]]
    nd = lambda n: node[:, NODE_IDX[n]]
    ps = lambda i: part_stats[:, i]
    one = torch.ones(b, dtype=torch.float32, device=cfg.device)
    mn = lambda x, hi: torch.clamp_max(x, hi)
    mx = lambda x, lo: torch.clamp_min(x, lo)

    hz = m("hazard")
    cols = [
        # Workload (0-4)
        torch.log1p(w("instr_count")) / 25.0,
        w("ilp"), w("mem_intensity"), w("vector_util"), w("matmul_ratio"),
        # Configuration (5-25)
        c("mesh_w") / 64.0, c("mesh_h") / 64.0,
        c("sc_x") / 8.0, c("sc_y") / 8.0,
        c("fetch") / 16.0, c("stanum") / 32.0, c("vlen") / 2048.0,
        c("dmem_kb") / 512.0, torch.log1p(c("wmem_kb")) / 12.0,
        c("imem_kb") / 128.0, c("vr_wp") / 16.0, c("xr_wp") / 16.0,
        c("xdpnum") / 16.0, nd("node_nm") / 28.0,
        m("noc_latency_cyc") / 100.0, c("dflit") / 8192.0,
        c("vdpnum") / 16.0, c("freq_frac"), c("precision"),
        nd("f_max_hz") / 1e9, nd("a_scale"),
        # Partitioning (26-28)
        c("dmem_in_frac"), c("dmem_out_frac"),
        mx(1.0 - c("dmem_in_frac") - c("dmem_out_frac"), 0.0),
        # Load distribution (29-32)
        ps(0), mn(ps(1) / 10.0, 1.0), ps(2), ps(7),
        # Op partition (33-36)
        c("rho_matmul"), c("rho_conv"), c("rho_general"), c("sub_matmul"),
        # Hazards (37-40)
        hz * 0.6, hz * 0.25, hz * 0.15, hz,
        # Per-TCC hazards (41-44)
        hz * ps(2), mn(hz * ps(1) / 4.0, 1.0), ps(5), ps(6),
        # Frequency (45)
        c("freq_frac"),
        # Streaming (46-49)
        c("stream_in"), c("stream_out"), c("allreduce_frac"), 0.5 * one,
        # PPA observation (50-54)
        mn(m("power_mw") / mx(nd("power_budget_mw"), 1e-9), 2.0),
        mn(m("perf_gops") / 1e6, 2.0),
        mn(m("area_mm2") / mx(nd("area_budget_mm2"), 1e-9), 2.0),
        torch.log1p(mx(m("tok_s"), 0.0)) / 12.0,
        mn(m("perf_gops") / mx(m("power_mw"), 1e-6) / 20.0, 2.0),
        # Workload partition (55-58)
        ps(4), ps(5), ps(6), ps(3),
        # Precision distribution (59-64)
        w("prec_fp32"), w("prec_fp16"), w("prec_bf16"),
        w("prec_fp8"), w("prec_int8"), w("prec_mixed"),
        # Instruction type (65-66)
        w("vector_ratio"), w("scalar_ratio"),
        # SC topology (67-69)
        m("n_cores") / 4096.0, m("hbar") / 43.0,
        m("noc_latency_cyc") / 100.0,
        # LLM config (70-72)
        w("batch") / 64.0, c("kv_quant") / 2.0,
        1.0 / mx(m("kappa_compact"), 1.0),
    ]
    return torch.stack(cols, dim=-1).to(torch.float32)


def sac_state_vec(s73: torch.Tensor) -> torch.Tensor:
    """Gather the 52-dim SAC subset."""
    return s73[..., const(KEPT_IDX, s73.device)]
