"""State encoder — paper Table 2 (port of ``repro.core.state``): 73-dim
full state, 52-dim SAC subset.

:func:`encode` / :func:`sac_state` are the scalar engine's host encoder
(numpy, copies of the reference's); :func:`encode_vec` /
:func:`sac_state_vec` are the batched engine's, in torch, with the same
column order and scaling.
"""
from __future__ import annotations

from typing import Optional

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


def encode(wl: np.ndarray, cfg: np.ndarray, metrics: np.ndarray,
           node: np.ndarray, part_stats: Optional[np.ndarray] = None) -> np.ndarray:
    """Build the 73-dim state (Table 2).

    part_stats: optional [8] vector from repro_torch.core.partition:
      [load_var, maxmin_ratio, balance, gini, tcc_load_mean, tcc_load_std,
       tcc_load_max, tcc_load_min]
    """
    if part_stats is None:
        part_stats = np.zeros(8, np.float32)
    w = lambda n: float(wl[WL_IDX[n]])
    c = lambda n: float(cfg[cs.IDX[n]])
    m = lambda n: float(metrics[M_IDX[n]])
    nd = lambda n: float(node[NODE_IDX[n]])

    s = np.zeros(STATE_DIM, np.float32)
    # -- Workload (0-4) ------------------------------------------------------
    s[0] = np.log1p(w("instr_count")) / 25.0
    s[1] = w("ilp")
    s[2] = w("mem_intensity")
    s[3] = w("vector_util")
    s[4] = w("matmul_ratio")
    # -- Configuration (5-25), 21 dims --------------------------------------
    s[5] = c("mesh_w") / 64.0
    s[6] = c("mesh_h") / 64.0
    s[7] = c("sc_x") / 8.0
    s[8] = c("sc_y") / 8.0
    s[9] = c("fetch") / 16.0
    s[10] = c("stanum") / 32.0
    s[11] = c("vlen") / 2048.0
    s[12] = c("dmem_kb") / 512.0
    s[13] = np.log1p(c("wmem_kb")) / 12.0
    s[14] = c("imem_kb") / 128.0
    s[15] = c("vr_wp") / 16.0
    s[16] = c("xr_wp") / 16.0
    s[17] = c("xdpnum") / 16.0
    s[18] = nd("node_nm") / 28.0
    s[19] = m("noc_latency_cyc") / 100.0
    s[20] = c("dflit") / 8192.0
    s[21] = c("vdpnum") / 16.0
    s[22] = c("freq_frac")
    s[23] = c("precision")
    s[24] = nd("f_max_hz") / 1e9
    s[25] = nd("a_scale")
    # -- Partitioning (26-28) ------------------------------------------------
    s[26] = c("dmem_in_frac")
    s[27] = c("dmem_out_frac")
    s[28] = max(0.0, 1.0 - c("dmem_in_frac") - c("dmem_out_frac"))
    # -- Load distribution (29-32) -------------------------------------------
    s[29] = part_stats[0]
    s[30] = min(part_stats[1] / 10.0, 1.0)
    s[31] = part_stats[2]
    s[32] = part_stats[7]
    # -- Op partition (33-36) ------------------------------------------------
    s[33] = c("rho_matmul")
    s[34] = c("rho_conv")
    s[35] = c("rho_general")
    s[36] = c("sub_matmul")
    # -- Hazards (37-40) ------------------------------------------------------
    hz = m("hazard")
    s[37] = hz * 0.6            # RAW share
    s[38] = hz * 0.25           # WAR share
    s[39] = hz * 0.15           # WAW share
    s[40] = hz
    # -- Per-TCC hazards (41-44) ----------------------------------------------
    s[41] = hz * part_stats[2]
    s[42] = min(hz * part_stats[1] / 4.0, 1.0)
    s[43] = part_stats[5]
    s[44] = part_stats[6]
    # -- Frequency (45) --------------------------------------------------------
    s[45] = c("freq_frac")
    # -- Streaming (46-49) ------------------------------------------------------
    s[46] = c("stream_in")
    s[47] = c("stream_out")
    s[48] = c("allreduce_frac")
    s[49] = 0.5  # pipeline-depth proxy (single-stage in this repro)
    # -- PPA observation (50-54) -------------------------------------------------
    s[50] = min(m("power_mw") / max(nd("power_budget_mw"), 1e-9), 2.0)
    s[51] = min(m("perf_gops") / 1e6, 2.0)
    s[52] = min(m("area_mm2") / max(nd("area_budget_mm2"), 1e-9), 2.0)
    s[53] = np.log1p(max(m("tok_s"), 0.0)) / 12.0
    s[54] = min(m("perf_gops") / max(m("power_mw"), 1e-6) / 20.0, 2.0)
    # -- Workload partition (55-58) -----------------------------------------------
    s[55] = part_stats[4]
    s[56] = part_stats[5]
    s[57] = part_stats[6]
    s[58] = part_stats[3]
    # -- Precision distribution (59-64) ---------------------------------------------
    s[59] = w("prec_fp32"); s[60] = w("prec_fp16"); s[61] = w("prec_bf16")
    s[62] = w("prec_fp8"); s[63] = w("prec_int8"); s[64] = w("prec_mixed")
    # -- Instruction type (65-66) -----------------------------------------------------
    s[65] = w("vector_ratio")
    s[66] = w("scalar_ratio")
    # -- SC topology (67-69) -------------------------------------------------------------
    s[67] = m("n_cores") / 4096.0
    s[68] = m("hbar") / 43.0
    s[69] = m("noc_latency_cyc") / 100.0
    # -- LLM config (70-72) -----------------------------------------------------------------
    s[70] = w("batch") / 64.0
    s[71] = c("kv_quant") / 2.0
    s[72] = 1.0 / max(m("kappa_compact"), 1.0)
    return s


def sac_state(s73: np.ndarray) -> np.ndarray:
    """Gather the 52-dim optimized subset used by the SAC actor/critics."""
    return np.asarray(s73)[..., KEPT_IDX]


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
