"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

MoE decoder: 48L, d_model 5120, 40 heads (GQA kv=8), expert d_ff 8192,
vocab 202048; 16 experts, top-1 routing + 1 shared expert (early-fusion
multimodal in the original; text backbone here).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    moe_every=1,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
