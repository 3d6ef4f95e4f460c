"""xLSTM-125m [arXiv:2405.04517; unverified].

Recurrent LM: 12 blocks, d_model 768, 4 heads; mLSTM:sLSTM 3:1 interleave
(paper's mixed configuration), no FFN (d_ff=0 -> the mLSTM block carries
its own up/down projection).  Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    sub_quadratic=True,
    norm="layernorm",
    act="gelu",
    source="arXiv:2405.04517",
))
