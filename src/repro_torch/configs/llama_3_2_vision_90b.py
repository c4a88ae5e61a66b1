"""Llama-3.2-Vision-90B: VLM with cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
100L d_model=8192 64H (kv=8) d_ff=28672 vocab=128256.  Vision frontend is a
STUB: input_specs() supplies precomputed patch embeddings (assignment note)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm", n_layers=100, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256,
    cross_attn_every=5, n_context_tokens=4096, rope_theta=500000.0,
)

def reduced() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-90b-reduced", family="vlm", n_layers=5,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        cross_attn_every=5, n_context_tokens=16,
    )
