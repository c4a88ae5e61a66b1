"""Whisper-medium: encoder-decoder audio transformer; conv frontend STUB
(input_specs() provides precomputed 1500-frame embeddings).
[arXiv:2212.04356; unverified]  24L enc + 24L dec, d_model=1024 16H d_ff=4096
vocab=51865."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865,
    enc_layers=24, n_audio_frames=1500, n_context_tokens=1500,
    mlp_gated=False, tie_embeddings=True,
)

def reduced() -> ArchConfig:
    return ArchConfig(
        name="whisper-medium-reduced", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        enc_layers=2, n_audio_frames=32, n_context_tokens=32,
        mlp_gated=False, tie_embeddings=True,
    )
