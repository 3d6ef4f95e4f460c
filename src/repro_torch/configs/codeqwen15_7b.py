"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B; hf].

Dense decoder: 32L, d_model 4096, 32 heads (GQA kv=32 -> MHA), d_ff 13440,
vocab 92416.  RoPE + SwiGLU + RMSNorm (Qwen1.5 architecture).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    rope_theta=1_000_000.0,
    source="hf:Qwen/CodeQwen1.5-7B",
))
