"""Qwen1.5-110B: dense decoder with QKV bias.
[hf:Qwen/Qwen1.5 family; hf]  80L d_model=8192 64H (kv=8) d_ff=49152 vocab=152064."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=49152, vocab=152064, qkv_bias=True,
)

def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-110b-reduced", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=192, vocab=256, qkv_bias=True,
    )
