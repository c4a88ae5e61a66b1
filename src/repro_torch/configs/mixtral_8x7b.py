"""Mixtral-8x7B: 8-expert top-2 MoE with sliding-window attention (W=4096).
[arXiv:2401.04088; hf]  32L d_model=4096 32H (kv=8) d_ff=14336 vocab=32000.
SWA makes decode state O(W) -> long_500k runs with the architectural window."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=32000, sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, every=1), subquadratic=True,
)

def reduced() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b-reduced", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, sliding_window=32,
        moe=MoEConfig(n_experts=4, top_k=2, every=1), subquadratic=True,
    )
