"""Phi-3-mini 3.8B [arXiv:2404.14219; unverified].

Dense decoder: 32L, d_model 3072, 32 heads (kv=32), d_ff 8192, vocab 32064.
RoPE + SwiGLU + GQA (here kv=32 = MHA per the assignment sheet).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    source="arXiv:2404.14219",
))
