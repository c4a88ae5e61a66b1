"""Llama-4-Maverick-400B-A17B: MoE (128 experts, top-1) with interleaved dense
FFN layers + shared expert; early-fusion frontend stubbed to text tokens.
[hf:meta-llama/Llama-4 family; unverified]
48L d_model=5120 40H (kv=8) d_ff=8192 vocab=202048."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048, rope_theta=500000.0,
    moe=MoEConfig(n_experts=128, top_k=1, every=2, shared_expert=True),
)

def reduced() -> ArchConfig:
    return ArchConfig(
        name="llama4-maverick-reduced", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        moe=MoEConfig(n_experts=4, top_k=1, every=2, shared_expert=True),
    )
