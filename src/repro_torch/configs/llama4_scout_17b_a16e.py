"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

MoE decoder: 48L, d_model 5120, 40 heads (GQA kv=8), expert d_ff 8192,
vocab 202048; 16 experts, top-1 routing + 1 shared expert (early-fusion
multimodal in the original; text backbone here).
"""
import dataclasses

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

#: What one 80 GB card serves of Llama-4-Scout: every width as published
#: (d_model 5120, 40 query heads over 8 KV heads of 128, all 16 experts
#: of width 8192 with top-1 routing, the shared expert of width 8192,
#: capacity factor 1.25, vocab 202048 padded to 202240, rope theta 5e5),
#: every layer an MoE layer as published, with one cut -- depth 48 -> 16,
#: as far as one card forces (parameters by ``param_count``, bf16 bytes):
#:
#:   depth 48: 106,736,358,400 parameters, 213.5 GB -- no;
#:   depth 17:  38,471,203,840, 76.9 GB (71.6 GiB) -- ~7.5 GiB left, too
#:              tight for prefill transients and a plain-path run;
#:   depth 16:  36,269,102,080, 72.5 GB (67.6 GiB) -- ~11.5 GiB left.
#:
#: Not registered: the registry mirrors the reference's.
ONE_CHIP = dataclasses.replace(
    CONFIG, n_layers=16,
    source="hf:meta-llama/Llama-4-Scout-17B-16E config.json (text "
           "backbone; depth 48 -> 16 for one 80 GB card, widths and "
           "experts as published)")
