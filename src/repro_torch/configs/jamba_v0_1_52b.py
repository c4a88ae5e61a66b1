"""Jamba-v0.1-52B: hybrid Mamba+attention (1:7 interleave) with 16-expert
top-2 MoE every other layer. [arXiv:2403.19887; hf]
32L d_model=4096 32H (kv=8) d_ff=14336 vocab=65536.
Sub-quadratic: 28/32 layers are SSM; the 4 attention layers keep exact KV."""
from repro_torch.configs.base import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536, attn_period=8,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=16, top_k=2, every=2), subquadratic=True,
)

def reduced() -> ArchConfig:
    return ArchConfig(
        name="jamba-reduced", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, attn_period=4,
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
        moe=MoEConfig(n_experts=4, top_k=2, every=2), subquadratic=True,
    )
