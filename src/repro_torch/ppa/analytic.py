"""Analytic PPA evaluator — paper Eqs. 14-33 and 62-64 (port of
``repro.ppa.analytic``).

Everything is a pure function of
  (cfg  [..., 30] — design vector, ``repro_torch.ppa.config_space`` layout,
   wl   [WL_DIM]  — workload features, ``repro_torch.workload.features``,
   node [..., NODE_DIM] — process-node constants, NODE_FIELDS below)
returning a metrics tensor [..., M_DIM] (METRICS below).  The leading axes
broadcast, so one function serves the reference's ``evaluate`` (one
point), ``evaluate_batch`` (many points, one node) and ``evaluate_vec``
(per-row nodes).  All arithmetic is float32 elementwise torch ops, in the
reference's order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ppa import config_space as cs
from repro_torch.ppa.nodes import NodeParams
from repro_torch.workload.features import WL_IDX

NODE_FIELDS = [
    "node_nm", "f_max_hz", "vdd", "a_scale", "kappa_p", "e_mac_pj",
    "e_rom_mw_per_mb", "e_sram_pj_per_byte", "e_noc_pj_per_byte_hop",
    "leak_core_mw", "leak_sram_mw_per_mb", "a_logic_mm2",
    "a_rom_mm2_per_mb", "a_sram_mm2_per_mb", "power_budget_mw",
    "area_budget_mm2", "high_perf",
]
NODE_IDX = {n: i for i, n in enumerate(NODE_FIELDS)}
NODE_DIM = len(NODE_FIELDS)


def node_vector(p: NodeParams, *, high_perf: bool = True) -> np.ndarray:
    v = np.zeros((NODE_DIM,), np.float32)
    for name in NODE_FIELDS[:-1]:
        v[NODE_IDX[name]] = getattr(p, name)
    v[NODE_IDX["high_perf"]] = 1.0 if high_perf else 0.0
    return v


def node_matrix(nodes, *, high_perf: bool = True) -> np.ndarray:
    """Stack per-element node constant vectors -> (B, NODE_DIM) float32."""
    return np.stack([node_vector(p, high_perf=high_perf) for p in nodes])


METRICS = [
    "power_mw", "perf_gops", "area_mm2", "tok_s", "ppa_score",
    "feasible", "wmem_ok", "dmem_ok", "power_ok", "area_ok",
    "mem_overuse_mb", "pressure", "hazard",
    "tok_comp", "tok_mem", "tok_noc",
    "bisect_bytes_s", "hbar", "eta_par", "noc_latency_cyc",
    "p_compute_mw", "p_sram_mw", "p_rom_mw", "p_noc_mw", "p_leak_mw",
    "util", "kv_total_mb", "kappa_compact", "xtile_bytes_tok",
    "n_cores", "f_hz", "load_balance",
]
M_IDX = {n: i for i, n in enumerate(METRICS)}
M_DIM = len(METRICS)

ETA_A = 1.288e-3
ETA_B = 4.03e-5
ETA_IMB = 0.05
ALPHA_SPEC = 1.56
TM_FP16 = 128
L_HOP_CYC = 2.0
L_SETUP_CYC = 12.0
PERF_NORM_MESH = 48 * 48


def _g(cfg, name):
    return cfg[..., cs.IDX[name]]


def _w(wl, name):
    return wl[..., WL_IDX[name]]


def _n(node, name):
    return node[..., NODE_IDX[name]]


def score_weights(high_perf):
    """PPA weight triplet (paper §3.13): (0.4,0.4,0.2) high-perf,
    (0.2,0.6,0.2) low-power."""
    w_perf = 0.4 * high_perf + 0.2 * (1.0 - high_perf)
    w_power = 0.4 * high_perf + 0.6 * (1.0 - high_perf)
    w_area = 0.2 + 0.0 * high_perf
    return w_perf, w_power, w_area


def evaluate(cfg: torch.Tensor, wl: torch.Tensor,
             node: torch.Tensor) -> torch.Tensor:
    """Design points -> metrics; leading axes of cfg and node broadcast."""
    cfg = cs.project(cfg)
    mn = torch.minimum
    relu = lambda x: torch.clamp_min(x, 0.0)

    mesh_w = torch.round(_g(cfg, "mesh_w"))
    mesh_h = torch.round(_g(cfg, "mesh_h"))
    n_cores = mesh_w * mesh_h
    f = _g(cfg, "freq_frac") * _n(node, "f_max_hz")
    high_perf = _n(node, "high_perf")

    # NoC model (Eqs. 18-19)
    dflit = _g(cfg, "dflit")
    bisect_bytes_s = mn(mesh_w, mesh_h) * dflit * f / 8.0
    hbar = (mesh_w + mesh_h) / 3.0
    sc_express = 1.0 / (1.0 + 0.1 * (_g(cfg, "sc_x") + _g(cfg, "sc_y") - 2.0))
    noc_latency = hbar * sc_express * L_HOP_CYC + L_SETUP_CYC

    eta_par = 1.0 / (1.0 + ETA_A * hbar + ETA_B * n_cores)
    eta_par = eta_par / (1.0 + ETA_IMB * _w(wl, "moe_imbalance"))

    # KV-cache compaction (Eqs. 25-33)
    kv_bt = _w(wl, "kv_bytes_per_token")
    kv_quant = torch.round(_g(cfg, "kv_quant"))
    b_quant = 16.0 / (2.0 ** kv_quant)
    window_frac = _g(cfg, "kv_window_frac")
    kappa = (16.0 / b_quant) * (1.0 / window_frac)
    seq_len = _w(wl, "seq_len")
    kv_total_mb = seq_len * kv_bt / kappa / 1e6
    kv_bt_eff = kv_bt / kappa

    # throughput ceilings (Eqs. 21-24)
    lanes = torch.clamp_max(_g(cfg, "vlen") / 16.0, float(TM_FP16))
    int8_boost = 1.0 + _g(cfg, "precision")
    dtype_boost = 1.0 + _w(wl, "dtype_fp8") + _w(wl, "dtype_int8")
    alpha_spec = 1.0 + (ALPHA_SPEC - 1.0) * _w(wl, "spec_decode_ok") * high_perf
    flops_tok = _w(wl, "flops_per_token")
    macs_capacity = n_cores * lanes * int8_boost * dtype_boost * f * eta_par
    tok_comp = 2.0 * macs_capacity * alpha_spec / flops_tok

    batch = torch.clamp_min(_w(wl, "batch"), 1.0)
    weight_bytes = _w(wl, "weight_mb") * 1e6
    prec_shrink = 1.0 - 0.5 * _g(cfg, "precision")

    dmem_in_kb = _g(cfg, "dmem_kb") * _g(cfg, "dmem_in_frac")
    act_in_kb = (_w(wl, "d_model") * 2.0 * batch / 1024.0
                 * (1.0 - 0.8 * _g(cfg, "stream_in")))
    kv_dmem_cap_mb = n_cores * relu(dmem_in_kb - act_in_kb) / 1024.0
    wmem_headroom_mb = relu(n_cores * _g(cfg, "wmem_kb") / 1024.0
                            - weight_bytes * prec_shrink / 1e6)
    kv_spill_mb = relu(kv_total_mb - kv_dmem_cap_mb)
    spill_frac = kv_spill_mb / torch.clamp_min(kv_total_mb, 1e-6)

    wtraf_bytes = _w(wl, "weight_traffic_mb") * 1e6
    wtraf_bytes = torch.where(wtraf_bytes > 0.0, wtraf_bytes, weight_bytes)
    bytes_tok = (wtraf_bytes * prec_shrink / batch
                 + kv_bt_eff * (1.0 + 3.0 * spill_frac)
                 + _w(wl, "act_bytes_per_token"))
    rom_bw_tile = (_g(cfg, "vlen") / 8.0) * f
    sram_bw_tile = (_g(cfg, "vr_wp") + _g(cfg, "xr_wp")) / 4.0 * rom_bw_tile
    bw_eff = n_cores * mn(rom_bw_tile + sram_bw_tile, 2.0 * rom_bw_tile)
    tok_mem = bw_eff / bytes_tok

    stream_relief = 1.0 - 0.25 * (_g(cfg, "stream_in")
                                  + _g(cfg, "stream_out")) / 2.0
    xtile_tok = (_w(wl, "xtile_base_bytes") * torch.sqrt(n_cores) / 4.0
                 * (0.6 + 0.8 * _g(cfg, "allreduce_frac")) * stream_relief)
    tok_noc = bisect_bytes_s / xtile_tok

    tok_s = mn(tok_comp, mn(tok_mem, tok_noc))
    util = tok_s / torch.clamp_min(tok_comp, 1e-9)
    perf_gops = 2.0 * macs_capacity * alpha_spec * util / 1e9

    # power (Eq. 62 + Table 12 decomposition)
    p_compute = (macs_capacity * util) * _n(node, "e_mac_pj") * 1e-9
    sram_traffic = (_w(wl, "act_bytes_per_token") + kv_bt_eff) * tok_s
    p_sram = sram_traffic * _n(node, "e_sram_pj_per_byte") * 1e-9
    rom_activity = eta_par * util * _g(cfg, "freq_frac")
    p_rom = (_w(wl, "weight_mb") * prec_shrink * _n(node, "e_rom_mw_per_mb")
             * rom_activity)
    p_noc = xtile_tok * tok_s * hbar * _n(node, "e_noc_pj_per_byte_hop") * 1e-9
    sram_mb = n_cores * (_g(cfg, "dmem_kb") + _g(cfg, "imem_kb")) / 1024.0
    p_leak = (n_cores * _n(node, "leak_core_mw")
              + sram_mb * _n(node, "leak_sram_mw_per_mb"))
    power_mw = p_compute + p_sram + p_rom + p_noc + p_leak

    # area (Eq. 64)
    wmem_total_mb = n_cores * _g(cfg, "wmem_kb") / 1024.0
    area = (n_cores * _n(node, "a_logic_mm2") * _n(node, "a_scale")
            + wmem_total_mb * _n(node, "a_rom_mm2_per_mb")
            + sram_mb * _n(node, "a_sram_mm2_per_mb"))

    # feasibility (Eqs. 14-17, 27-28)
    wmem_bytes = n_cores * _g(cfg, "wmem_kb") * 1024.0
    wmem_need = weight_bytes * prec_shrink
    wmem_ok = wmem_bytes >= wmem_need
    dmem_scr_kb = _g(cfg, "dmem_kb") * relu(
        1.0 - _g(cfg, "dmem_in_frac") - _g(cfg, "dmem_out_frac"))
    scratch_need_kb = _w(wl, "d_model") * 2.0 * 2.0 / 1024.0
    kv_per_tile_kb = kv_total_mb * 1024.0 / n_cores
    dmem_ok = torch.logical_and(kv_spill_mb <= wmem_headroom_mb,
                                dmem_scr_kb >= scratch_need_kb)
    power_ok = power_mw <= _n(node, "power_budget_mw")
    area_ok = area <= _n(node, "area_budget_mm2")
    feasible = wmem_ok & dmem_ok & power_ok & area_ok

    mem_overuse_mb = (relu(wmem_need - wmem_bytes)
                      + relu((kv_per_tile_kb + act_in_kb - dmem_in_kb)
                             * n_cores * 1024.0)) / 1e6
    pressure = (wmem_need / torch.clamp_min(wmem_bytes, 1.0)
                + 0.5 * (kv_per_tile_kb + act_in_kb)
                / torch.clamp_min(dmem_in_kb, 1e-3))

    hazard = torch.clamp(
        0.5 * _w(wl, "ilp") / (1.0 + _g(cfg, "stanum"))
        + 0.3 * relu(1.0 - (_g(cfg, "vr_wp") + _g(cfg, "vdpnum")) / 8.0)
        + 0.2 * relu(1.0 - _g(cfg, "fetch") / 8.0), 0.0, 1.0)
    load_balance = torch.clamp(0.5 + 0.5 * _g(cfg, "sub_matmul")
                               - 0.2 * hazard, 0.0, 1.0)

    # composite PPA score (cost, lower = better)
    perf_range = (PERF_NORM_MESH * 2.0 * TM_FP16 * _n(node, "f_max_hz")
                  * 0.85 * (1.0 + (ALPHA_SPEC - 1.0) * high_perf)) / 1e9
    p_norm = perf_gops / perf_range
    pw_norm = power_mw / _n(node, "power_budget_mw")
    a_norm = area / _n(node, "area_budget_mm2")
    w_perf, w_power, w_area = score_weights(high_perf)
    ppa_score = w_perf * (1.0 - p_norm) + w_power * pw_norm + w_area * a_norm

    vals = dict(
        power_mw=power_mw, perf_gops=perf_gops, area_mm2=area, tok_s=tok_s,
        ppa_score=ppa_score, feasible=feasible, wmem_ok=wmem_ok,
        dmem_ok=dmem_ok, power_ok=power_ok, area_ok=area_ok,
        mem_overuse_mb=mem_overuse_mb, pressure=pressure, hazard=hazard,
        tok_comp=tok_comp, tok_mem=tok_mem, tok_noc=tok_noc,
        bisect_bytes_s=bisect_bytes_s, hbar=hbar, eta_par=eta_par,
        noc_latency_cyc=noc_latency,
        p_compute_mw=p_compute, p_sram_mw=p_sram, p_rom_mw=p_rom,
        p_noc_mw=p_noc, p_leak_mw=p_leak, util=util,
        kv_total_mb=kv_total_mb, kappa_compact=kappa,
        xtile_bytes_tok=xtile_tok, n_cores=n_cores, f_hz=f,
        load_balance=load_balance,
    )
    cols = torch.broadcast_tensors(
        *[vals[k].to(torch.float32) for k in METRICS])
    return torch.stack(cols, dim=-1)


# The reference's three jit entry points are one broadcasting function here.
evaluate_vec = evaluate
evaluate_batch = evaluate

