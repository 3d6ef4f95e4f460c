"""SeamlessM4T-medium [arXiv:2308.11596; hf].

Encoder-decoder, multimodal: 12+12 layers, d_model 1024, 16 heads,
d_ff 4096, vocab 256206.  The speech/text frontend is a STUB:
input_specs() provides precomputed frame embeddings for the encoder; the
decoder cross-attends to encoder memory.  LayerNorm + GELU (Transformer
classic / NLLB lineage).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,           # decoder layers
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    pattern=("cross",),    # every decoder layer: self-attn + cross-attn
    frontend_tokens=1024,  # speech frames after frontend (per 4k cell /4)
    norm="layernorm",
    act="gelu",
    source="arXiv:2308.11596",
))
