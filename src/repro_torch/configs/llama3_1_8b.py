"""Llama 3.1 8B: the paper's high-performance workload (S4.3, Table 9).
32L d_model=4096 32H (kv=8) d_ff=14336 vocab=128256; 8.03B params,
14.96 GB FP16 weights, KV 128 KB/token (Eq. 25)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.1-8b", family="dense", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=128256, rope_theta=500000.0,
    param_dtype="float16",
    precision_mix=(0.0, 1.0, 0.0, 0.0, 0.0, 0.0),
)

def reduced() -> ArchConfig:
    return ArchConfig(
        name="llama3.1-8b-reduced", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    )
