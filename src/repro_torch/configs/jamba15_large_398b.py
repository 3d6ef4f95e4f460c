"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf].

Hybrid: 72 layers, d_model 8192, 64 heads (GQA kv=8), d_ff 24576; Mamba :
attention 7:1 interleave; MoE (16 experts, top-2) every other layer.
Sub-quadratic in the Mamba layers; the 9 attention layers hold KV caches
(sequence-sharded for long_500k).
"""
import dataclasses

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

#: What one 80 GB card serves of Jamba-1.5-Large: every width as
#: published (d_model 8192, 64 query heads over 8 KV heads of 128, Mamba
#: d_inner 16384 with state 16, conv 4 and dt_rank 512, vocab 65536),
#: with two cuts --
#:
#: * depth 72 -> 8: one whole period of the layer pattern, 7 Mamba layers
#:   and the attention layer at slot 3, the published 7:1 ratio;
#: * experts 16 -> none: a dense SwiGLU FFN of the published expert width
#:   (24576) on all 8 layers, for memory: one period holds 4 MoE layers
#:   of 16 experts of 604 M parameters each, ~45 B parameters (89 GB in
#:   bf16) in all, more than the card's 80 GB.
#:
#: 8,462,049,280 parameters, 16.9 GB in bf16.  Not registered: the
#: registry mirrors the reference's.
ONE_CHIP = dataclasses.replace(
    CONFIG, n_layers=8, n_experts=0, top_k=0,
    source="arXiv:2403.19887; ai21labs/AI21-Jamba-1.5-Large config.json "
           "(one pattern period of 8 layers; dense FFNs of width 24576 in "
           "place of the 16 experts)")

#: Jamba-1.5-Large cut to depth 4 with all 16 experts (top-2, MoE on the
#: odd layers), every width as published: Mamba, Mamba + MoE, Mamba,
#: then attention + MoE -- all three mixers and two MoE layers.
#: 22,484,459,520 parameters, 45.0 GB in bf16.  Not registered.
DEPTH4 = dataclasses.replace(
    CONFIG, n_layers=4, pattern=("mamba", "mamba", "mamba", "attn"),
    source="arXiv:2403.19887; ai21labs/AI21-Jamba-1.5-Large config.json "
           "(layers 0-3 of the pattern: Mamba, Mamba+MoE, Mamba, "
           "attention+MoE; all 16 experts)")

#: One whole period of Jamba-1.5-Large's pattern with all 16 experts:
#: 8 layers (7 Mamba, attention at slot 3, MoE on the odd layers), every
#: width as published.  44,701,360,128 parameters, 89.4 GB in bf16: more
#: than one 80 GB card holds, so it is served placed over four.  Not
#: registered.
PERIOD = dataclasses.replace(
    CONFIG, n_layers=8,
    source="arXiv:2403.19887; ai21labs/AI21-Jamba-1.5-Large config.json "
           "(one pattern period of 8 layers with its 4 MoE layers of 16 "
           "experts)")
