"""SmolVLM: the paper's low-power workload (S4.12, Table 19): ~0.48 GB FP16
weights, multi-modal prefix VLM (image tokens concatenated, no cross-attn).
Vision tower is a STUB: input_specs() provides precomputed patch embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smolvlm", family="vlm", n_layers=28, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab=49152, n_context_tokens=1024,
    param_dtype="float16",
    precision_mix=(0.0, 1.0, 0.0, 0.0, 0.0, 0.0),
)

def reduced() -> ArchConfig:
    return ArchConfig(
        name="smolvlm-reduced", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, n_context_tokens=8,
    )
