"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

VLM: 40-layer text decoder, d_model 4096, 32 heads (GQA kv=8), d_ff 14336,
vocab 128256, with cross-attention image layers every 5th layer.  The
vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, 1601, d_model)-shaped memory the cross-attn layers attend
to.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    pattern=("attn", "attn", "attn", "attn", "cross"),
    cross_every=5,
    frontend_tokens=1601,   # 1 tile x (40x40+1) patches
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
))
