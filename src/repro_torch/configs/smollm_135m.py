"""SmolLM-135M: llama-architecture small dense LM.
[hf:HuggingFaceTB/SmolLM-135M; hf]  30L d_model=576 9H (kv=3) d_ff=1536 vocab=49152."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="dense", n_layers=30, d_model=576, n_heads=9,
    n_kv_heads=3, d_ff=1536, vocab=49152, tie_embeddings=True,
)

def reduced() -> ArchConfig:
    return ArchConfig(
        name="smollm-135m-reduced", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, tie_embeddings=True,
    )
