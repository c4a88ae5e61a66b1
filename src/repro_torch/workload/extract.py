"""Operator-graph + feature extraction from JAX model configs.

Replaces the paper's Stage 1-3 (ONNX ingestion -> unified graph -> workload
features): we derive the graph directly from the ``ArchConfig`` that also
instantiates the JAX model, so the DSE plane and the workload plane share one
source of truth (DESIGN.md §2).  Granularity is one op per logical tensor
operation (the paper's ONNX granularity is finer; op *counts* therefore
differ from Table 8 while all flop/byte aggregates match analytically).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig, MambaConfig, XLSTMConfig
from repro_torch.workload.features import (KIND_ATTENTION, KIND_CONV, KIND_ELEMWISE,
                                     KIND_EMBED, KIND_MATMUL, KIND_NORM,
                                     KIND_ROUTE, KIND_SCAN, WL_IDX, Workload,
                                     WorkloadGraph, wl_vector)

_PREC_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
               "fp8": 1, "float8": 1}

PHASES = ("decode", "prefill")
# "native" keeps the config's param_dtype; the others override the datapath
DTYPES = ("native", "fp8", "int8")
_DTYPE_PARAM = {"fp8": "fp8", "int8": "int8"}


def routing_imbalance(n_experts: int, top_k: int, tokens: float) -> float:
    """Expected per-tile expert load imbalance from top-k routing.

    With ``tokens`` tokens routed independently to ``top_k`` of ``n_experts``
    experts, each expert's load is Binomial(tokens*top_k, 1/n_experts); the
    expected max-over-experts excess over the mean (Gumbel tail of n_experts
    normals) is ``sigma_rel * sqrt(2 ln n_experts)`` relative std, capped at
    the all-on-one-expert worst case ``n_experts/top_k - 1``.  Decode
    (tokens == batch) is far lumpier than prefill (tokens == batch*seq)."""
    if n_experts <= 1 or top_k >= n_experts:
        return 0.0
    p = top_k / n_experts
    sigma_rel = math.sqrt((1.0 - p) / (max(tokens, 1.0) * p))
    return min(sigma_rel * math.sqrt(2.0 * math.log(n_experts)),
               n_experts / top_k - 1.0)


class _GraphBuilder:
    def __init__(self) -> None:
        self.names: List[str] = []
        self.kind: List[int] = []
        self.flops: List[float] = []
        self.wbytes: List[float] = []
        self.obytes: List[float] = []
        self.layer: List[int] = []
        self.edges: List[Tuple[int, int]] = []

    def add(self, name: str, kind: int, flops: float, wbytes: float,
            obytes: float, layer: int, deps: Tuple[int, ...] = ()) -> int:
        idx = len(self.names)
        self.names.append(name)
        self.kind.append(kind)
        self.flops.append(flops)
        self.wbytes.append(wbytes)
        self.obytes.append(obytes)
        self.layer.append(layer)
        for d in deps:
            if d >= 0:
                self.edges.append((d, idx))
        return idx

    def build(self) -> WorkloadGraph:
        return WorkloadGraph(
            names=self.names,
            kind=np.asarray(self.kind, np.int8),
            flops=np.asarray(self.flops, np.float64),
            weight_bytes=np.asarray(self.wbytes, np.float64),
            out_bytes=np.asarray(self.obytes, np.float64),
            layer=np.asarray(self.layer, np.int32),
            edges=(np.asarray(self.edges, np.int32).reshape(-1, 2)),
        )


def build_graph(cfg: ArchConfig, seq_len: int,
                phase: str = "decode") -> WorkloadGraph:
    """Per-token operator graph with data-flow edges.

    ``phase="decode"`` (default) is the per-token autoregressive graph.
    ``phase="prefill"`` keeps per-token granularity but attends over the
    causal average context ``(ctx+1)/2`` — summed over the S prompt tokens
    that reproduces the O(S^2) seq-parallel attention cost — and is paired
    by :func:`extract` with full-width expert weight traffic."""
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    g = _GraphBuilder()
    d, dff = cfg.d_model, cfg.d_ff
    hd, H, Hk = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    by = _PREC_BYTES.get(cfg.param_dtype, 2)
    ab = 2.0  # activation bytes (fp16/bf16)

    def mm(name, layer, dep, d_in, d_out, kind=KIND_MATMUL):
        return g.add(name, kind, 2.0 * d_in * d_out, by * d_in * d_out,
                     ab * d_out, layer, (dep,))

    prev = g.add("embed", KIND_EMBED, 0.0, by * cfg.vocab * d, ab * d, -1)
    kinds = cfg.layer_kinds()
    ctx = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    # decode attends over the full cached context; a prefill token at
    # position t attends over t+1 keys -> causal average (ctx+1)/2
    ctx = (ctx + 1.0) / 2.0 if phase == "prefill" else ctx

    for li, kind in enumerate(kinds):
        n0 = g.add(f"L{li}.norm1", KIND_NORM, 4.0 * d, by * d, ab * d, li, (prev,))
        if kind in ("attn", "xattn"):
            if cfg.mla is not None:
                m = cfg.mla
                qk_d = m.qk_nope_head_dim + m.qk_rope_head_dim
                qd = mm(f"L{li}.q_down", li, n0, d, m.q_lora_rank)
                qu = mm(f"L{li}.q_up", li, qd, m.q_lora_rank, H * qk_d)
                kv = mm(f"L{li}.kv_down", li, n0, d, m.kv_lora_rank + m.qk_rope_head_dim)
                ku = mm(f"L{li}.kv_up", li, kv, m.kv_lora_rank,
                        H * (m.qk_nope_head_dim + m.v_head_dim))
                att = g.add(f"L{li}.attn", KIND_ATTENTION,
                            4.0 * H * qk_d * ctx, 0.0, ab * H * m.v_head_dim,
                            li, (qu, ku))
                o = mm(f"L{li}.o_proj", li, att, H * m.v_head_dim, d)
            else:
                q = mm(f"L{li}.q_proj", li, n0, d, H * hd)
                k = mm(f"L{li}.k_proj", li, n0, d, Hk * hd)
                v = mm(f"L{li}.v_proj", li, n0, d, Hk * hd)
                att = g.add(f"L{li}.attn", KIND_ATTENTION,
                            4.0 * H * hd * ctx, 0.0, ab * H * hd, li, (q, k, v))
                o = mm(f"L{li}.o_proj", li, att, H * hd, d)
            if kind == "xattn":  # cross-attention onto n_context_tokens
                xq = mm(f"L{li}.xq", li, o, d, H * hd)
                xa = g.add(f"L{li}.xattn", KIND_ATTENTION,
                           4.0 * H * hd * cfg.n_context_tokens, 2 * by * d * Hk * hd,
                           ab * H * hd, li, (xq,))
                o = mm(f"L{li}.xo", li, xa, H * hd, d)
            prev = g.add(f"L{li}.add1", KIND_ELEMWISE, d, 0.0, ab * d, li, (o, prev))
        elif kind == "mamba":
            mc = cfg.mamba or MambaConfig()
            di = mc.expand * d
            up = mm(f"L{li}.in_proj", li, n0, d, 2 * di)
            cv = g.add(f"L{li}.conv1d", KIND_CONV, 2.0 * di * mc.d_conv,
                       by * di * mc.d_conv, ab * di, li, (up,))
            sc = g.add(f"L{li}.ssm_scan", KIND_SCAN, 6.0 * di * mc.d_state,
                       by * di * (3 * mc.d_state + 2), ab * di, li, (cv,))
            prev = mm(f"L{li}.out_proj", li, sc, di, d)
        elif kind in ("mlstm", "slstm"):
            xc = cfg.xlstm or XLSTMConfig()
            di = int(xc.proj_factor * d)
            up = mm(f"L{li}.up_proj", li, n0, d, di if kind == "slstm" else 2 * di)
            if kind == "mlstm":
                dqk = int(di * xc.d_qk_factor)
                qkv = mm(f"L{li}.qkv", li, up, di, 2 * dqk + di)
                sc = g.add(f"L{li}.mlstm_scan", KIND_SCAN, 8.0 * dqk * di / max(1, H),
                           by * 3 * di, ab * di, li, (qkv,))
            else:
                sc = g.add(f"L{li}.slstm_rec", KIND_SCAN, 8.0 * di * di,
                           by * 4 * di * di, ab * di, li, (up,))
            prev = mm(f"L{li}.down_proj", li, sc, di, d)
        if dff > 0 and kind not in ("mlstm", "slstm"):
            n1 = g.add(f"L{li}.norm2", KIND_NORM, 4.0 * d, by * d, ab * d, li, (prev,))
            n_mats = 3 if cfg.mlp_gated else 2
            if cfg.moe_on_layer(li):
                m = cfg.moe
                eff = m.d_ff_expert or dff
                rt = g.add(f"L{li}.router", KIND_ROUTE, 2.0 * d * m.n_experts,
                           by * d * m.n_experts, ab * m.n_experts, li, (n1,))
                # one grouped expert op (O(layers) nodes, not O(layers *
                # n_experts)): flops/out_bytes are the top_k active experts,
                # weight_bytes is the full resident expert bank — aggregates
                # match the old per-expert expansion exactly
                outs = [g.add(f"L{li}.experts", KIND_MATMUL,
                              n_mats * 2.0 * d * eff * m.top_k,
                              by * n_mats * d * eff * m.n_experts,
                              ab * d * m.top_k, li, (rt,))]
                if m.shared_expert:
                    outs.append(g.add(f"L{li}.shared_exp", KIND_MATMUL,
                                      n_mats * 2.0 * d * eff, by * n_mats * d * eff,
                                      ab * d, li, (n1,)))
                n_act = m.top_k + (1 if m.shared_expert else 0)
                prev = g.add(f"L{li}.moe_combine", KIND_ELEMWISE, d * n_act, 0.0,
                             ab * d, li, tuple(outs))
            else:
                h1 = mm(f"L{li}.ffn_up", li, n1, d, (n_mats - 1) * dff)
                prev = mm(f"L{li}.ffn_down", li, h1, dff, d)
    if cfg.is_encdec:  # encoder, amortised per decoded token (runs once/seq)
        amort = cfg.n_audio_frames / max(1.0, float(seq_len))
        enc_flops = cfg.enc_layers * (8.0 * d * d + 4.0 * d * dff + 4.0 * H * hd * cfg.n_audio_frames) * amort
        prev_e = g.add("encoder", KIND_ATTENTION, enc_flops,
                       0.0, ab * d * cfg.n_audio_frames, -1, (prev,))
        prev = prev_e
    gn = g.add("final_norm", KIND_NORM, 4.0 * d, by * d, ab * d, cfg.n_layers, (prev,))
    g.add("lm_head", KIND_MATMUL, 2.0 * d * cfg.vocab,
          0.0 if cfg.tie_embeddings else by * d * cfg.vocab,
          ab * cfg.vocab, cfg.n_layers, (gn,))
    return g.build()


def extract(cfg: ArchConfig, *, seq_len: int = 2048, batch: int = 1,
            phase: str = "decode", dtype: str = "native") -> Workload:
    """Build the full workload descriptor for the DSE plane.

    ``phase``/``dtype`` select the scenario; the defaults
    (``decode``/``native``) reproduce the pre-scenario extraction bitwise
    for dense workloads (the repo-wide back-compat doctrine)."""
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")
    if dtype != "native":
        cfg = dataclasses.replace(cfg, param_dtype=_DTYPE_PARAM[dtype])
    graph = build_graph(cfg, seq_len, phase)
    pc = cfg.param_counts()
    by = _PREC_BYTES.get(cfg.param_dtype, 2)
    weight_bytes = pc["total"] * by
    # tokens processed per forward step: decode emits one token per sequence,
    # prefill chews the whole prompt in parallel
    tokens = batch * (seq_len if phase == "prefill" else 1)

    moe = cfg.moe if any(cfg.moe_on_layer(li)
                         for li in range(cfg.n_layers)) else None
    imbalance = (routing_imbalance(moe.n_experts, moe.top_k, float(tokens))
                 if moe is not None else 0.0)
    if phase == "prefill" or moe is None:
        # prefill touches every expert; dense streams the full weights --
        # same expression as weight_mb so the default scenario's analytic
        # traffic select stays bitwise identical
        weight_traffic = weight_bytes
    else:
        weight_traffic = pc["active"] * by  # only routed experts stream

    total_flops = float(graph.flops.sum())
    k_flops = graph.flops
    matmul_f = float(k_flops[graph.kind == KIND_MATMUL].sum())
    conv_f = float(k_flops[graph.kind == KIND_CONV].sum())
    attn_f = float(k_flops[graph.kind == KIND_ATTENTION].sum())
    scan_f = float(k_flops[graph.kind == KIND_SCAN].sum())
    vec_f = matmul_f + conv_f + attn_f + scan_f

    kinds = cfg.layer_kinds()
    attn_layers = sum(1 for k in kinds if k in ("attn", "xattn"))
    if cfg.is_encdec:
        attn_layers += cfg.n_layers  # decoder cross-attn KV

    act_bytes = 40.0 * cfg.n_layers * cfg.d_model * 2.0   # calibrated k_act=40
    kv_b = cfg.kv_bytes_per_token()
    total_bytes = weight_traffic / max(1, tokens) + kv_b + act_bytes
    mem_intensity = min(1.0, (total_bytes / max(total_flops, 1.0)) / 4.0)

    # codegen-scale instruction estimate: ~1 vector instr / (lanes*2) flops
    instr = total_flops / (64.0 * 2.0) + 64.0 * graph.n_ops
    # ILP proxy: mean fan-out-weighted independence of the graph
    fan = np.bincount(graph.edges[:, 0], minlength=graph.n_ops) if graph.edges.size else np.zeros(graph.n_ops)
    ilp = float(np.clip(fan.mean() / 2.0, 0.05, 1.0))

    feats = wl_vector(
        params_total=pc["total"], params_active=pc["active"],
        weight_mb=weight_bytes / 1e6,
        flops_per_token=total_flops,
        kv_bytes_per_token=kv_b,
        ssm_state_bytes=cfg.ssm_state_bytes(),
        act_bytes_per_token=act_bytes,
        seq_len=seq_len, batch=tokens,
        n_ops=graph.n_ops, instr_count=instr, ilp=ilp,
        mem_intensity=mem_intensity,
        vector_util=vec_f / max(total_flops, 1.0),
        matmul_ratio=matmul_f / max(total_flops, 1.0),
        conv_ratio=conv_f / max(total_flops, 1.0),
        scalar_ratio=1.0 - vec_f / max(total_flops, 1.0),
        vector_ratio=vec_f / max(total_flops, 1.0),
        prec_fp32=cfg.precision_mix[0], prec_fp16=cfg.precision_mix[1],
        prec_bf16=cfg.precision_mix[2], prec_fp8=cfg.precision_mix[3],
        prec_int8=cfg.precision_mix[4], prec_mixed=cfg.precision_mix[5],
        d_model=cfg.d_model, n_layers=cfg.n_layers, attn_layers=attn_layers,
        xtile_base_bytes=2.0 * cfg.d_model * 2.0 * cfg.n_layers,
        autoregressive=0.0 if cfg.family == "audio" and not cfg.is_encdec else 1.0,
        spec_decode_ok=(0.0 if phase == "prefill" else  # no draft in prefill
                        1.0 if cfg.family in ("dense", "moe", "hybrid", "vlm",
                                              "ssm") else 0.0),
        phase=1.0 if phase == "prefill" else 0.0,
        moe_imbalance=imbalance,
        weight_traffic_mb=weight_traffic / 1e6,
        dtype_fp8=1.0 if dtype == "fp8" else 0.0,
        dtype_int8=1.0 if dtype == "int8" else 0.0,
    )
    return Workload(arch_name=cfg.name, features=feats, graph=graph)
