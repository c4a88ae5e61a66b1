"""MiniCPM3-4B: dense decoder with Multi-head Latent Attention (MLA).
[hf:openbmb/MiniCPM3-4B; hf]  62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448."""
from repro_torch.configs.base import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense", n_layers=62, d_model=2560, n_heads=40,
    n_kv_heads=40, d_ff=6400, vocab=73448, d_head=96,
    mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
)

def reduced() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-4b-reduced", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, d_head=24,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
    )
