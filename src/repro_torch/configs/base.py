"""Architecture configuration system (copy of ``repro.configs.base``).

One ``ArchConfig`` describes a workload model for BOTH planes of the
framework: the workload plane (model definition and serving) and the DSE
plane (operator-graph extraction feeding the paper's RL compiler).  Every
assigned architecture has a module in ``repro_torch.configs`` exposing
``CONFIG`` (full size) and ``reduced()`` (smoke-test size, runs a real step
on CPU).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

Family = str  # 'dense' | 'moe' | 'hybrid' | 'vlm' | 'audio' | 'ssm'


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-style)."""
    kv_lora_rank: int = 256
    q_lora_rank: int = 768
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0          # 0 -> use arch d_ff
    every: int = 1                # MoE FFN on every `every`-th layer (1=all)
    shared_expert: bool = False   # Llama-4 style always-on shared expert
    renormalize: bool = True      # gates renormalised over the top k


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 1              # width of dt between x_proj and dt_proj
    inner_norms: bool = False     # RMSNorms on dt, B and C (Jamba)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8          # 7 mLSTM : 1 sLSTM  (xLSTM[7:1])
    proj_factor: float = 2.0      # block up-projection
    d_qk_factor: float = 0.5      # mLSTM q/k head dim = d_v * factor


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                      # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    mlp_gated: bool = True       # SwiGLU (3 mats) vs GELU MLP (2 mats)
    rope_theta: float = 10000.0
    rope: bool = True                    # False: no positions (Jamba)
    norm_eps: float = 1e-5
    # --- attention variants ---
    mla: Optional[MLAConfig] = None
    sliding_window: int = 0              # 0 = full attention
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    # --- hybrid (Jamba): 1 attention layer per `attn_period` layers ---
    attn_period: int = 0                 # 0 = all-attention
    attn_offset: int = 0                 # attention's layer in each period
    mamba: Optional[MambaConfig] = None
    # --- ssm (xLSTM) ---
    xlstm: Optional[XLSTMConfig] = None
    # --- vlm ---
    cross_attn_every: int = 0            # every k-th layer has x-attn (vlm)
    n_context_tokens: int = 0            # vision / audio context length
    # --- audio (enc-dec) ---
    enc_layers: int = 0                  # >0 => encoder-decoder
    n_audio_frames: int = 0
    # --- misc ---
    param_dtype: str = "bfloat16"
    # fraction of ops executing in [fp32, fp16, bf16, fp8, int8, mixed]
    precision_mix: Tuple[float, ...] = (0.0, 0.0, 1.0, 0.0, 0.0, 0.0)
    # long-context support: sub-quadratic mechanism present?
    subquadratic: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind sequence for the decoder stack."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm" and self.xlstm is not None:
                k = "slstm" if (i % self.xlstm.slstm_every == self.xlstm.slstm_every - 1) else "mlstm"
            elif self.attn_period > 0 and self.mamba is not None:
                k = ("attn" if i % self.attn_period == self.attn_offset
                     else "mamba")
            elif self.cross_attn_every > 0 and (i % self.cross_attn_every == self.cross_attn_every - 1):
                k = "xattn"
            else:
                k = "attn"
            kinds.append(k)
        return tuple(kinds)

    def moe_on_layer(self, i: int) -> bool:
        return self.moe is not None and (i % max(1, self.moe.every)
                                         == max(1, self.moe.every) - 1)

    # ---------------- parameter counting (used by ppa + roofline) ----------
    def param_counts(self) -> Dict[str, float]:
        """Analytic parameter counts: total and decode-active."""
        d, dff, V = self.d_model, self.d_ff, self.vocab
        hd, H, Hk = self.head_dim, self.n_heads, self.n_kv_heads
        counts = dict(embed=V * d, head=0 if self.tie_embeddings else V * d)

        def attn_params() -> float:
            if self.mla is not None:
                m = self.mla
                qk_d = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * H * qk_d       # q down/up
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)          # kv down
                p += m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                p += H * m.v_head_dim * d                               # o
                return p
            p = d * H * hd + 2 * d * Hk * hd + H * hd * d
            if self.qkv_bias:
                p += H * hd + 2 * Hk * hd
            return p

        def ffn_params(expert_ff: int) -> float:
            n_mats = 3 if self.mlp_gated else 2  # swiglu vs plain MLP
            return n_mats * d * expert_ff

        def mamba_params() -> float:
            mc = self.mamba or MambaConfig()
            di = mc.expand * d
            return (d * 2 * di + di * mc.d_conv
                    + di * (2 * mc.d_state + 2 * mc.dt_rank)
                    + di * mc.d_state + di * d)

        def xlstm_params(kind: str) -> float:
            xc = self.xlstm or XLSTMConfig()
            quant = 16 * self.n_heads   # matches models.blocks._xlstm_dims
            di = max(quant, int(xc.proj_factor * d) // quant * quant)
            if kind == "mlstm":
                dqk = max(quant, int(di * xc.d_qk_factor) // quant * quant)
                return d * di * 2 + di * (2 * dqk + di) + 3 * di + di * d
            # sLSTM: input proj wx (4*di^2) + recurrent R (4*di^2)
            return d * di + 8 * di * di + 4 * di + di * d

        total = active = counts["embed"] + counts["head"]
        # embeddings count once in total; decode touches one row + full head
        for i, kind in enumerate(self.layer_kinds()):
            layer_t = layer_a = 2 * d  # norms
            if kind in ("attn", "xattn"):
                layer_t += attn_params(); layer_a += attn_params()
                if kind == "xattn":  # extra cross-attn block
                    layer_t += attn_params(); layer_a += attn_params()
            elif kind == "mamba":
                layer_t += mamba_params(); layer_a += mamba_params()
            elif kind in ("mlstm", "slstm"):
                layer_t += xlstm_params(kind); layer_a += xlstm_params(kind)
            if self.d_ff > 0 and kind not in ("mlstm", "slstm"):
                if self.moe_on_layer(i):
                    m = self.moe
                    eff = m.d_ff_expert or dff
                    layer_t += m.n_experts * ffn_params(eff) / 3 * 3
                    layer_a += m.top_k * ffn_params(eff)
                    if m.shared_expert:
                        layer_t += ffn_params(eff); layer_a += ffn_params(eff)
                else:
                    layer_t += ffn_params(dff); layer_a += ffn_params(dff)
            total += layer_t; active += layer_a
        if self.is_encdec:  # encoder stack: attention + ffn, no causal masking
            enc = self.enc_layers * (attn_params() + ffn_params(dff) + 2 * d)
            total += enc
            # encoder runs once per sequence; amortised decode-active share ~0
            for _ in range(self.n_layers):   # decoder cross-attention blocks
                total += attn_params(); active += attn_params()
        return dict(total=float(total), active=float(active))

    def kv_bytes_per_token(self, kv_bits: int = 16) -> float:
        """Paper Eq. 25 (generalised to MLA / SWA / hybrid / SSM)."""
        by = kv_bits / 8.0
        if self.family == "ssm":
            return 0.0  # recurrent state, O(1) in L -- see DESIGN §Arch-applicability
        if self.mla is not None:
            per_l = (self.mla.kv_lora_rank + self.mla.qk_rope_head_dim) * by
            return self.n_layers * per_l
        attn_layers = sum(1 for k in self.layer_kinds() if k in ("attn", "xattn"))
        per_l = 2 * self.n_kv_heads * self.head_dim * by
        n = attn_layers + (self.n_layers if self.is_encdec else 0)  # dec self+cross
        return n * per_l

    def ssm_state_bytes(self) -> float:
        """Constant recurrent-state footprint (mamba / xLSTM layers)."""
        by = 2.0
        total = 0.0
        for k in self.layer_kinds():
            if k == "mamba":
                mc = self.mamba or MambaConfig()
                total += mc.expand * self.d_model * mc.d_state * by
            elif k == "mlstm":
                xc = self.xlstm or XLSTMConfig()
                di = int(xc.proj_factor * self.d_model)
                dqk = int(di * xc.d_qk_factor)
                total += dqk * di * by
            elif k == "slstm":
                xc = self.xlstm or XLSTMConfig()
                total += 4 * int(xc.proj_factor * self.d_model) * by
        return total


# ----------------------------------------------------------------------------
ARCH_IDS = (
    "minicpm3-4b", "smollm-135m", "qwen1.5-110b", "qwen2-72b",
    "llama-3.2-vision-90b", "llama4-maverick-400b-a17b", "mixtral-8x7b",
    "jamba-v0.1-52b", "whisper-medium", "xlstm-1.3b",
    # paper's own workloads:
    "llama3.1-8b", "smolvlm",
)

# published models the port runs beside the reference's zoo (ARCH_IDS)
EXTRA_IDS = ("ai21-jamba2-mini",)

_MOD = {a: a.replace("-", "_").replace(".", "_")
        for a in ARCH_IDS + EXTRA_IDS}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MOD:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_MOD)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch_id]}")
    return mod.reduced()
