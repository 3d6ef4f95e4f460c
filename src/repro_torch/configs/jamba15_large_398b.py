"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf].

Hybrid: 72 layers, d_model 8192, 64 heads (GQA kv=8), d_ff 24576; Mamba :
attention 7:1 interleave; MoE (16 experts, top-2) every other layer.
Sub-quadratic in the Mamba layers; the 9 attention layers hold KV caches
(sequence-sharded for long_500k).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    pattern=("mamba", "mamba", "mamba", "attn",
             "mamba", "mamba", "mamba", "mamba"),
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    moe_d_ff=24576,
    ssm_state=16,
    sub_quadratic=True,
    source="arXiv:2403.19887",
))
