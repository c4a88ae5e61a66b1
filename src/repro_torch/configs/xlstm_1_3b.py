"""xLSTM-1.3B: sLSTM + mLSTM recurrent blocks (xLSTM[7:1]), no FFN stack.
[arXiv:2405.04517; unverified]  48L d_model=2048 4H vocab=50304 d_ff=0.
O(1) recurrent state: long_500k runs natively; KV-cache compaction (paper
S3.9) is INAPPLICABLE -- see DESIGN.md SArch-applicability."""
from repro_torch.configs.base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=50304,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=1.3, d_qk_factor=0.25),
    subquadratic=True,
)

def reduced() -> ArchConfig:
    return ArchConfig(
        name="xlstm-reduced", family="ssm", n_layers=2, d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=0, vocab=256,
        xlstm=XLSTMConfig(slstm_every=2, proj_factor=2.0, d_qk_factor=0.5),
        subquadratic=True,
    )
