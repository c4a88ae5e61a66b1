"""Workload feature vector + operator graph (paper Stage 3 artifacts).

``WL`` is the flat float32 feature vector consumed by the jit'd analytic PPA
evaluator and by the RL state encoder (Table 2 "Workload" block).  The
operator graph feeds the operation-level partitioner (paper §3.5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

WL_FIELDS: List[str] = [
    "params_total",        # 0
    "params_active",       # 1
    "weight_mb",           # 2  weight footprint at param precision
    "flops_per_token",     # 3  decode FLOPs/token (matmul-active)
    "kv_bytes_per_token",  # 4  FP16 baseline (Eq. 25)
    "ssm_state_bytes",     # 5  constant recurrent state
    "act_bytes_per_token", # 6  SRAM activation traffic per token
    "seq_len",             # 7
    "batch",               # 8
    "n_ops",               # 9  graph operator count
    "instr_count",         # 10 estimated codegen instruction count
    "ilp",                 # 11 instruction-level parallelism estimate [0,1]
    "mem_intensity",       # 12 bytes/flop normalised [0,1]
    "vector_util",         # 13 fraction of flops in vectorisable ops
    "matmul_ratio",        # 14 fraction of flops in matmul ops
    "conv_ratio",          # 15 fraction of flops in conv ops
    "scalar_ratio",        # 16 scalar instruction fraction
    "vector_ratio",        # 17 vector instruction fraction
    "prec_fp32",           # 18..23 precision distribution (Table 2 idx 59-64)
    "prec_fp16",
    "prec_bf16",
    "prec_fp8",
    "prec_int8",
    "prec_mixed",
    "d_model",             # 24
    "n_layers",            # 25
    "attn_layers",         # 26 layers carrying exact-KV attention
    "xtile_base_bytes",    # 27 cross-tile bytes/token before mesh scaling
    "autoregressive",      # 28 1.0 for decoder LMs
    "spec_decode_ok",      # 29 speculative decoding applicable
    # --- scenario axes; zeros reproduce the legacy decode vector ---
    "phase",               # 30 0.0 = decode (per-token), 1.0 = prefill
    "moe_imbalance",       # 31 expected per-tile expert load imbalance
    "weight_traffic_mb",   # 32 weights actually streamed per step (MoE-aware)
    "dtype_fp8",           # 33 datapath override: fp8 weights/activations
    "dtype_int8",          # 34 datapath override: int8 weights
]
WL_IDX: Dict[str, int] = {n: i for i, n in enumerate(WL_FIELDS)}
WL_DIM = len(WL_FIELDS)
# vector length before the scenario axes were appended; legacy archives and
# recommendation payloads of this length are zero-padded (zeros == defaults)
WL_DIM_LEGACY = 30

# operator kinds (graph `kind` codes)
KIND_MATMUL, KIND_CONV, KIND_ATTENTION, KIND_NORM, KIND_ELEMWISE, \
    KIND_SCAN, KIND_EMBED, KIND_ROUTE = range(8)
KIND_NAMES = ("matmul", "conv", "attention", "norm", "elemwise", "scan",
              "embed", "route")


@dataclasses.dataclass
class WorkloadGraph:
    """Flat operator graph: one entry per op, edges as (src, dst) pairs.

    ``flops``/``bytes_*`` are per decoded token (the paper optimises decode
    throughput); prefill variants are derived by the extractor when needed.
    """
    names: List[str]
    kind: np.ndarray          # int8  [n_ops]
    flops: np.ndarray         # f64   [n_ops] per-token decode FLOPs
    weight_bytes: np.ndarray  # f64   [n_ops] resident weights
    out_bytes: np.ndarray     # f64   [n_ops] activation output bytes/token
    layer: np.ndarray         # int32 [n_ops]
    edges: np.ndarray         # int32 [n_edges, 2]  (src, dst)

    @property
    def n_ops(self) -> int:
        return int(self.kind.shape[0])

    def producers(self, i: int) -> np.ndarray:
        return self.edges[self.edges[:, 1] == i, 0]


@dataclasses.dataclass
class Workload:
    arch_name: str
    features: np.ndarray      # [WL_DIM] float32
    graph: WorkloadGraph

    def f(self, name: str) -> float:
        return float(self.features[WL_IDX[name]])


def wl_vector(**kwargs: float) -> np.ndarray:
    v = np.zeros((WL_DIM,), dtype=np.float32)
    for k, val in kwargs.items():
        v[WL_IDX[k]] = val
    return v


def as_feature_vector(obj) -> np.ndarray:
    """Coerce a recommendation-query payload into the WL feature vector.

    Accepts a full ``WL_DIM`` sequence (taken verbatim) or a
    ``{field_name: value}`` mapping (named fields over zeros, unknown
    names rejected with the valid list) — the wire format of
    the recommendation server, where callers
    describe workloads no campaign has extracted."""
    if isinstance(obj, dict):
        unknown = sorted(set(obj) - set(WL_IDX))
        if unknown:
            raise ValueError(f"unknown workload feature(s) {unknown}; "
                             f"known: {WL_FIELDS}")
        return wl_vector(**{k: float(v) for k, v in obj.items()})
    v = np.asarray(obj, dtype=np.float32).reshape(-1)
    if v.shape[0] == WL_DIM_LEGACY:  # pre-scenario vector: pad with defaults
        v = np.concatenate([v, np.zeros(WL_DIM - WL_DIM_LEGACY, np.float32)])
    if v.shape[0] != WL_DIM:
        raise ValueError(f"feature vector must have {WL_DIM} entries "
                         f"(got {v.shape[0]}); field order: {WL_FIELDS}")
    if not np.all(np.isfinite(v)):
        raise ValueError("feature vector must be finite")
    return v
