"""DeepSeek-V2 236B [arXiv:2405.04434; hf].

MoE decoder with multi-head latent attention (MLA): 60L, d_model 5120,
128 heads, kv_lora 512, q_lora 1536, rope/nope head dims 64/128; FFN:
layer 0 dense (d_ff 12288), layers 1.. MoE with 160 routed experts
(d_ff 1536, top-6) + 2 shared experts.
"""
import dataclasses

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

#: What one 80 GB card serves of DeepSeek-V2: every width as published
#: (d_model 5120; 128 heads of MLA with q_lora 1536, kv_lora 512, nope /
#: rope / v head dims 128 / 64 / 128; vocab 102,400; the dense first layer
#: of 12,288; 160 routed experts of 1536, top-6, 2 shared, device-limited
#: routing over 16 groups with limit 3, int8 dispatch, capacity factor
#: 1.25), with one cut -- depth 60 -> 10 (the dense layer and 9 MoE
#: layers), as far as one card forces (parameters by ``param_count``, bf16
#: bytes):
#:
#:   depth 60: 235,217,146,880 parameters, 470.4 GB -- no;
#:   depth 10:  36,611,322,880, 73.2 GB (68.2 GiB) -- ~11 GiB left, as
#:              the llama4-scout cut's 16 layers left 11.5 GiB;
#:   depth  9:  32,639,206,400, 65.3 GB -- the fallback should a served
#:              run's peak exceed ~76 GiB.
#:
#: 3,911,480,320 active parameters a token.  Not registered: the registry
#: mirrors the reference's.
ONE_CHIP = dataclasses.replace(
    CONFIG, n_layers=10,
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2 config.json "
           "(depth 60 -> 10 for one 80 GB card; widths, MLA ranks and "
           "experts as published)")
