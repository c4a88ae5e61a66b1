"""AI21-Jamba2-Mini, the published Jamba block (Jamba v0.1, arXiv:2403.19887;
huggingface.co/ai21labs/AI21-Jamba2-Mini config.json).
32L d_model=4096 32H (kv=8) vocab=65536, rms_norm_eps 1e-6, untied head.
Each 8-layer period: attention (no positional encoding) at offset 4,
Mamba-1 in the other 7 (d_state 16, d_conv 4, expand 2, dt_rank 256,
RMSNorms on dt, B and C; a conv bias, no projection biases); a 16-expert
top-2 MoE of width 14336 on every odd layer, its gates the router's
softmax taken as they are; the even layers a dense SwiGLU of 14336.

Beside the zoo, not in ``ARCH_IDS`` (the reference's twelve): the zoo's
``jamba-v0.1-52b`` keeps the reference's simplified block."""
from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="ai21-jamba2-mini", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536, norm_eps=1e-6,
    rope=False, attn_period=8, attn_offset=4,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=256,
                      inner_norms=True),
    moe=MoEConfig(n_experts=16, top_k=2, every=2, renormalize=False),
    subquadratic=True,
)


def reduced() -> ArchConfig:
    """Two whole periods at small widths, every option of the block on."""
    return ArchConfig(
        name="ai21-jamba2-mini-reduced", family="hybrid", n_layers=16,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        norm_eps=1e-6, rope=False, attn_period=8, attn_offset=4,
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2, dt_rank=8,
                          inner_norms=True),
        moe=MoEConfig(n_experts=4, top_k=2, every=2, renormalize=False),
        subquadratic=True,
    )
