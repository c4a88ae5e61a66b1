"""Process-node table (paper §3.15, "foundry-calibrated process node table").

The paper interpolates power/area/energy constants from a proprietary foundry
table.  We reconstruct an equivalent table by calibrating each component model
against the paper's own published results (Tables 10/11/12 for Llama 3.1 8B,
Table 19 for SmolVLM) at the paper's reported per-node mesh configurations.
Derivations are annotated inline; the calibration is validated by
``tests/test_ppa_calibration.py`` and ``benchmarks/table10_11.py``.

All energies are *effective* (activity folded) so that the analytic models in
``repro_torch.ppa`` reproduce the paper anchors.  Nodes are keyed in nm.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

NODES = (3, 5, 7, 10, 14, 22, 28)

# Max achievable clock per node (paper Table 11 "Freq" column; MHz -> Hz).
F_MAX_HZ: Dict[int, float] = {
    3: 1.000e9, 5: 0.820e9, 7: 0.570e9, 10: 0.520e9,
    14: 0.400e9, 22: 0.250e9, 28: 0.250e9,
}

# Supply voltage (paper §4.13.1 quotes 0.65 V @6nm, 0.55 V @3nm; rest are
# representative foundry values).  Used by kappa_P = sqrt(A_scale) * Vdd^2.
VDD: Dict[int, float] = {
    3: 0.55, 5: 0.62, 7: 0.70, 10: 0.75, 14: 0.80, 22: 0.90, 28: 1.00,
}

# Logic area scaling relative to 28nm (geometric density ladder; endpoints
# calibrated from Llama Table 10 + SmolVLM Table 19 area columns, see
# DESIGN.md and the derivation in ppa/area.py).
A_SCALE: Dict[int, float] = {
    3: 0.0436, 5: 0.080, 7: 0.130, 10: 0.220, 14: 0.360, 22: 0.700, 28: 1.000,
}

# Logic area of one TCC (RISC-V + 1536b vector datapath + NoC router) at 28nm.
A_LOGIC_MM2_28NM = 1.40

# Effective FP16 MAC energy (pJ/MAC), calibrated per node from Table 12
# "Compute" column at the paper's per-node meshes with mean VLEN=1536
# (96 FP16 lanes) and eta_util = eta_parallel(mesh):
#   e_mac(n) = P_comp(n) / (N_cores * 96 * f(n) * eta_util(n))
E_MAC_PJ: Dict[int, float] = {
    3: 0.184, 5: 0.284, 7: 0.453, 10: 0.473, 14: 0.586, 22: 0.959, 28: 1.012,
}

# Node power-scaling factor relative to 28nm (paper Eq. 62 defines
# kappa_P = sqrt(A_scale) * Vdd^2; we report the *calibrated* factor derived
# from E_MAC_PJ so every dynamic-energy table shares one consistent ladder).
KAPPA_P: Dict[int, float] = {n: E_MAC_PJ[n] / E_MAC_PJ[28] for n in NODES}

# Effective ROM (weight memory) read power density, mW per MB at full
# activity (alpha = eta_util * f/f_max).  Calibrated from Table 12 "ROM Rd"
# with W_total = 15,319 MB and llama activity ~0.905:
#   e_rom(n) = P_rom(n) / (W_MB * alpha_llama(n))
E_ROM_MW_PER_MB: Dict[int, float] = {
    3: 0.2004, 5: 0.1900, 7: 0.1379, 10: 0.1005, 14: 0.0504,
    22: 0.0159, 28: 0.00925,
}

# SRAM dynamic read/write energy (pJ/byte), calibrated at 3nm from Table 12
# "SRAM" (1.324 W at 29,809 tok/s with ~10.5 MB activation+KV traffic per
# token) and scaled across nodes by KAPPA_P.
E_SRAM_PJ_PER_BYTE_3NM = 4.2
E_SRAM_PJ_PER_BYTE: Dict[int, float] = {
    n: E_SRAM_PJ_PER_BYTE_3NM * KAPPA_P[n] / KAPPA_P[3] for n in NODES
}

# NoC energy per byte-hop (pJ), calibrated at 3nm from Table 12 "NoC"
# (17.116 W at 29,809 tok/s, 5.44 MB/token cross-tile, h_bar = 27.67) and
# scaled by KAPPA_P.  ~0.48 pJ/bit-hop at 3nm -- consistent with published
# mesh-NoC numbers.
E_NOC_PJ_PER_BYTE_HOP_3NM = 3.81
E_NOC_PJ_PER_BYTE_HOP: Dict[int, float] = {
    n: E_NOC_PJ_PER_BYTE_HOP_3NM * KAPPA_P[n] / KAPPA_P[3] for n in NODES
}

# Leakage: ROM banks are sleep-gated (paper Eq. 62 discussion) so leakage is
# per-core logic + SRAM periphery.  Two-parameter model per node,
#   P_leak = N_cores * LEAK_CORE_MW + SRAM_MB * LEAK_SRAM_MW_PER_MB,
# solved from the Llama Table 12 "Leak" column and the SmolVLM Table 19
# leakage share (97% @3nm ... 51% @28nm) -- see DESIGN.md §ppa.
LEAK_CORE_MW: Dict[int, float] = {
    3: 0.75, 5: 0.95, 7: 0.85, 10: 0.70, 14: 0.55, 22: 0.30, 28: 0.35,
}
LEAK_SRAM_MW_PER_MB: Dict[int, float] = {
    3: 11.4, 5: 16.5, 7: 15.9, 10: 14.7, 14: 11.5, 22: 3.7, 28: 1.6,
}

# ROM (weight) memory area, mm^2/MB, calibrated per node from the Llama
# Table 10 area column after subtracting logic area (see DESIGN.md):
A_ROM_MM2_PER_MB: Dict[int, float] = {
    3: 0.0346, 5: 0.0485, 7: 0.0653, 10: 0.0877, 14: 0.1141,
    22: 0.1712, 28: 0.2190,
}
# SRAM is ~3x less dense than ROM at iso-node.
A_SRAM_MM2_PER_MB: Dict[int, float] = {n: 3.0 * A_ROM_MM2_PER_MB[n] for n in NODES}

# Default chip-level budgets used for reward normalisation ranges (paper
# §3.10: "normalization ranges are derived from process node characteristics
# and constraints").  Power budget tracks what a mesh of max size at f_max
# would draw; area budget tracks the reticle + package class per node.
POWER_BUDGET_MW: Dict[int, float] = {
    3: 65000.0, 5: 70000.0, 7: 60000.0, 10: 35000.0, 14: 20000.0,
    22: 10000.0, 28: 6000.0,
}
AREA_BUDGET_MM2: Dict[int, float] = {
    3: 850.0, 5: 1200.0, 7: 1600.0, 10: 2000.0, 14: 2600.0,
    22: 3600.0, 28: 4500.0,
}

# Low-power mode budgets (SmolVLM regime, paper Table 19).
POWER_BUDGET_LOW_MW: Dict[int, float] = {n: 13.0 for n in NODES}
AREA_BUDGET_LOW_MM2: Dict[int, float] = {
    3: 30.0, 5: 40.0, 7: 50.0, 10: 65.0, 14: 85.0, 22: 130.0, 28: 160.0,
}


@dataclasses.dataclass(frozen=True)
class NodeParams:
    """All per-node constants bundled, as plain floats (jit-friendly)."""

    node_nm: int
    f_max_hz: float
    vdd: float
    a_scale: float
    kappa_p: float
    e_mac_pj: float
    e_rom_mw_per_mb: float
    e_sram_pj_per_byte: float
    e_noc_pj_per_byte_hop: float
    leak_core_mw: float
    leak_sram_mw_per_mb: float
    a_logic_mm2: float
    a_rom_mm2_per_mb: float
    a_sram_mm2_per_mb: float
    power_budget_mw: float
    area_budget_mm2: float

    def as_vector(self) -> np.ndarray:
        """Dense feature vector for surrogate-model node conditioning."""
        return np.array([
            self.node_nm / 28.0, self.f_max_hz / 1e9, self.vdd,
            self.a_scale, self.kappa_p, self.e_mac_pj,
            self.e_rom_mw_per_mb, self.e_sram_pj_per_byte,
            self.e_noc_pj_per_byte_hop, self.leak_core_mw,
            self.leak_sram_mw_per_mb,
        ], dtype=np.float32)


def node_params(node_nm: int, *, low_power: bool = False) -> NodeParams:
    if node_nm not in NODES:
        raise ValueError(f"unknown process node {node_nm}nm; known: {NODES}")
    return NodeParams(
        node_nm=node_nm,
        f_max_hz=F_MAX_HZ[node_nm],
        vdd=VDD[node_nm],
        a_scale=A_SCALE[node_nm],
        kappa_p=KAPPA_P[node_nm],
        e_mac_pj=E_MAC_PJ[node_nm],
        e_rom_mw_per_mb=E_ROM_MW_PER_MB[node_nm],
        e_sram_pj_per_byte=E_SRAM_PJ_PER_BYTE[node_nm],
        e_noc_pj_per_byte_hop=E_NOC_PJ_PER_BYTE_HOP[node_nm],
        leak_core_mw=LEAK_CORE_MW[node_nm],
        leak_sram_mw_per_mb=LEAK_SRAM_MW_PER_MB[node_nm],
        a_logic_mm2=A_LOGIC_MM2_28NM,
        a_rom_mm2_per_mb=A_ROM_MM2_PER_MB[node_nm],
        a_sram_mm2_per_mb=A_SRAM_MM2_PER_MB[node_nm],
        power_budget_mw=(POWER_BUDGET_LOW_MW if low_power else POWER_BUDGET_MW)[node_nm],
        area_budget_mm2=(AREA_BUDGET_LOW_MM2 if low_power else AREA_BUDGET_MM2)[node_nm],
    )


def all_nodes(*, low_power: bool = False):
    return [node_params(n, low_power=low_power) for n in NODES]
