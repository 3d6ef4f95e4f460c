"""DeepSeek-V2 236B [arXiv:2405.04434; hf].

MoE decoder with multi-head latent attention (MLA): 60L, d_model 5120,
128 heads, kv_lora 512, q_lora 1536, rope/nope head dims 64/128; FFN:
layer 0 dense (d_ff 12288), layers 1.. MoE with 160 routed experts
(d_ff 1536, top-6) + 2 shared experts.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    dense_d_ff=12288,
    vocab=102400,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    moe_every=1,
    first_layer_dense=True,
    route_groups=16,     # device-limited routing (DeepSeek-V2 §: M=3)
    route_limit=3,
    int8_dispatch=True,  # beyond-paper: V3-style quantized dispatch

    mla=True,
    kv_lora=512,
    q_lora=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    head_dim=192,   # nope + rope
    source="arXiv:2405.04434",
))
