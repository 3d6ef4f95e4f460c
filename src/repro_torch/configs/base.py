"""ArchConfig dataclass + registry + the four assigned input-shape cells.

Every assigned architecture registers itself by importing its module (see
``repro_torch.configs.base.ARCH_MODULES``); ``--arch <id>`` resolves through
:func:`get_arch`.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

_REGISTRY: Dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    dense_d_ff: int = 0         # FFN hidden for non-MoE layers (0 -> d_ff)
    head_dim: int = 0           # 0 -> d_model // n_heads

    # layer pattern: tuple of block kinds, tiled to n_layers.
    # kinds: 'attn', 'mamba', 'mlstm', 'slstm', 'cross' (self+cross pair)
    pattern: Tuple[str, ...] = ("attn",)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0           # per-expert hidden (0 -> d_ff)
    moe_every: int = 1          # MoE on layers where (i % moe_every)==offset
    moe_offset: int = 0
    first_layer_dense: bool = False      # deepseek-v2: layer 0 dense
    capacity_factor: float = 1.25
    route_groups: int = 0       # device-limited routing: expert groups
    route_limit: int = 0        # ... max groups (devices) per token (M)
    int8_dispatch: bool = False  # quantize the dispatch a2a payload

    # MLA (deepseek-v2)
    mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # SSM / recurrent
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2

    # encoder-decoder (audio) / VLM
    encoder_layers: int = 0
    cross_every: int = 0        # vlm: a cross-attn layer every k layers
    frontend_tokens: int = 0    # stub modality tokens (image patches/frames)

    # misc
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "swiglu"         # swiglu | gelu
    tie_embeddings: bool = True
    sub_quadratic: bool = False  # supports the long_500k decode cell
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding: embedding tables are padded to a
        multiple of 256 so the vocab dim shards over any mesh axis and the
        unembed matmul stays MXU-aligned; padded logits are masked."""
        return -(-self.vocab // 256) * 256

    def layer_kinds(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    def is_moe_layer(self, i: int) -> bool:
        if not self.n_experts:
            return False
        if self.first_layer_dense and i == 0:
            return False
        return i % self.moe_every == self.moe_offset

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ArchConfig":
        """Family-preserving smoke-test config: tiny widths, few layers."""
        pat_len = len(self.pattern)
        n_layers = max(pat_len, 2 if pat_len == 1 else pat_len)
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) or 2,
            head_dim=16,
            d_ff=128,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            route_groups=2 if self.route_groups else 0,
            route_limit=1 if self.route_limit else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_d_ff=64 if self.moe_d_ff else 0,
            # generous capacity so tiny smoke batches never drop tokens
            # (capacity drops are shape-dependent and break prefill/train
            # logit-consistency checks)
            capacity_factor=4.0,
            kv_lora=32 if self.kv_lora else 0,
            q_lora=32 if self.q_lora else 0,
            rope_head_dim=8 if self.mla else 64,
            nope_head_dim=16 if self.mla else 128,
            v_head_dim=16 if self.mla else 128,
            ssm_state=8,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_tokens=16 if self.frontend_tokens else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


#: the assigned input-shape set (same four cells for every LM arch)
SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

ARCH_MODULES = (
    "codeqwen15_7b", "phi3_mini_38b", "minitron_8b", "granite3_8b",
    "llama4_scout_17b_a16e", "deepseek_v2_236b", "llama32_vision_11b",
    "xlstm_125m", "jamba15_large_398b", "seamless_m4t_medium",
)


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    for m in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    _load_all()
    return tuple(sorted(_REGISTRY))


def get_shape(name: str) -> ShapeCell:
    return SHAPES[name]


def applicable_cells() -> Tuple[Tuple[str, str], ...]:
    """All (arch, shape) dry-run cells.  long_500k only runs for
    sub-quadratic architectures (see DESIGN.md §Arch-applicability)."""
    cells = []
    for a in list_archs():
        cfg = get_arch(a)
        for s in SHAPES:
            if s == "long_500k" and not cfg.sub_quadratic:
                continue
            cells.append((a, s))
    return tuple(cells)
