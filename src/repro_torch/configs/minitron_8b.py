"""Minitron-8B (pruned Nemotron) [arXiv:2407.14679; hf].

Dense decoder: 32L, d_model 4096, 32 heads (GQA kv=8), d_ff 16384,
vocab 256000.  Pruned-Nemotron: squared-ReLU MLP in the original; we keep
the assignment's d_ff and use gelu MLP (2-matrix) to match its non-gated
FFN.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256000,
    act="gelu",
    source="arXiv:2407.14679",
))
