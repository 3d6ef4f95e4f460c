"""Analytic per-cell FLOP / HBM-byte / collective-byte accounting (the
port of ``repro.analysis.flops``, arithmetic for arithmetic: its numbers
equal the reference's).

Why analytic: the reference's compiler cost model counts a loop body
once, and the port's dry run runs one microbatch of a step on the
``meta`` device, which has no cost model at all; so the roofline uses
closed-form counts derived from the architecture -- the same first-order
accounting every published MFU/roofline analysis uses.

All outputs are PER DEVICE (divide global work by mesh size).

FLOPs (fwd):
  matmul params     2 * N_active * T          (N excludes embedding gather)
  attention         4 * B * H * hd * S * S_ctx   (x1/2 causal)
  cross-attention   4 * B * H * hd * S * M
  mamba scan        10 * B * S * d_inner * N_state
  mLSTM scan        ~8 * B * S * H * P^2 (matrix-memory update + read)
  sLSTM scan        ~2 * B * S * (4 d^2 / H)  (block-diag recurrence)
Train = 3x fwd (activation bwd 2x).  Decode: T = B, S = 1, S_ctx = cache.

HBM bytes:
  params traffic    train: read(bf16) x2 (fwd+bwd) + write + grads f32 r/w
                    + AdamW mu/nu f32 r/w  = 6 + 8 + 16 = 30 B/param
                    inference: 2 B/param per step
  activations       ~= c_act * T_local * d_model * bytes * n_layers
                    (c_act ~ 12 boundaries/block with remat: resid x2,
                    norms, qkv/gate projections, attention out, ffn in/out)
  KV cache          prefill: write once; decode: read whole cache + masked
                    append (read+write) => 3x cache bytes (baseline impl)
Collectives:
  TP all-reduce     2 * T_local * d * bytes per sharded matmul pair
                    (attn out + ffn out) per layer
  FSDP all-gather   param_bytes_local * (|data|-1)/|data| per microbatch
  DP grad reduce    2 * grad_bytes_local (ring, bf16 grads assumed f32)
  MoE all-to-all    2 * T_local * top_k * d * bytes per MoE layer
  SP softmax        negligible (B*H scalars)
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import model as MDL

BF16 = 2
F32 = 4


@dataclasses.dataclass
class CellCost:
    flops: float          # per device
    hbm_bytes: float      # per device
    coll_bytes: float     # per device
    model_flops: float    # useful 2NT/6NT per device
    detail: Dict[str, float]


def _counts(cfg: ArchConfig):
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ("attn", "cross") for k in kinds)
    n_cross = sum(k == "cross" for k in kinds)
    n_mamba = sum(k == "mamba" for k in kinds)
    n_mlstm = sum(k == "mlstm" for k in kinds)
    n_slstm = sum(k == "slstm" for k in kinds)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    return n_attn, n_cross, n_mamba, n_mlstm, n_slstm, n_moe


def expert_param_count(cfg: ArchConfig) -> int:
    if not cfg.n_experts:
        return 0
    e_ff = cfg.moe_d_ff or cfg.d_ff
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    return 3 * cfg.d_model * e_ff * cfg.n_experts * n_moe


def ep_dispatch_bytes(cfg: ArchConfig, cell: ShapeCell, dp: int) -> float:
    """The analytic EP term of :func:`cell_cost`: the MoE layers'
    all-to-all dispatch + combine bytes a device over the EP (= data)
    group, every token's k rows balanced over the ranks.  Device-limited
    routing (A4) bounds per-token destinations to route_limit groups;
    int8 dispatch (A5) halves the dispatch leg."""
    n_moe = _counts(cfg)[5]
    B, S = cell.global_batch, cell.seq_len
    decode = cell.kind == "decode"
    mult = 3.0 if cell.kind == "train" else 1.0
    T = B if decode else B * S
    t_local = T / min(dp, max(1, B)) if decode else T / dp
    fanout = cfg.top_k
    if cfg.route_groups > 1 and 0 < cfg.route_limit:
        fanout = min(cfg.top_k, cfg.route_limit)
    dispatch_b = 1.0 if cfg.int8_dispatch else BF16
    per_leg = t_local * fanout * cfg.d_model * n_moe * (dp - 1) / dp
    return mult * per_leg * (dispatch_b + BF16)  # dispatch + combine


def cell_cost(cfg: ArchConfig, cell: ShapeCell, n_dev: int,
              *, dp: int, tp: int, n_micro: int = 1,
              fsdp: bool = False, append_impl: str = "scatter",
              param_dp: int = 0) -> CellCost:
    """``dp`` is the batch-sharding width (may be 1 for batch-1 decode);
    ``param_dp`` is the mesh's data-axis size, which FSDP/EP always use
    for parameter storage regardless of batch fit (defaults to dp)."""
    param_dp = param_dp or dp
    B, S = cell.global_batch, cell.seq_len
    train = cell.kind == "train"
    decode = cell.kind == "decode"
    mult = 3.0 if train else 1.0          # bwd = 2x fwd

    n_attn, n_cross, n_mamba, n_mlstm, n_slstm, n_moe = _counts(cfg)
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H = cfg.n_heads
    N_active = MDL.active_param_count(cfg)
    mem_len = MDL.memory_len(cfg, cell)

    T = B if decode else B * S            # tokens this step
    s_q = 1 if decode else S              # query length
    s_ctx = S if decode else S            # context length

    # ---------------- FLOPs (global) ----------------
    f_matmul = 2.0 * N_active * T
    causal = 0.5 if not decode else 1.0
    f_attn = 4.0 * B * H * hd * s_q * s_ctx * causal * n_attn
    f_cross = 4.0 * B * H * hd * s_q * mem_len * n_cross
    d_inner = cfg.ssm_expand * d
    f_mamba = 10.0 * T * d_inner * cfg.ssm_state * n_mamba
    p_m = (2 * d) // max(1, H)            # mLSTM head dim (expand=2)
    f_mlstm = 8.0 * T * H * p_m * p_m * n_mlstm
    f_slstm = 2.0 * T * (4 * d * d // max(1, H)) * n_slstm
    if cfg.encoder_layers and mem_len:
        enc_T = B * mem_len
        enc_params_per_layer = (4 * d * d
                                + 2 * d * (cfg.dense_d_ff or cfg.d_ff))
        f_matmul += 2.0 * enc_params_per_layer * enc_T * cfg.encoder_layers
        f_attn += 4.0 * B * H * hd * mem_len * mem_len * cfg.encoder_layers

    flops_global = mult * (f_matmul + f_attn + f_cross + f_mamba
                           + f_mlstm + f_slstm)
    model_flops_global = (6.0 if train else 2.0) * N_active * T

    # ---------------- HBM bytes (per device) ----------------
    p_local = MDL.param_count(cfg) / (tp * (param_dp if fsdp else 1))
    if train:
        b_params = p_local * 30.0
    else:
        b_params = p_local * BF16
    t_local = T / min(dp, max(1, B)) if decode else T / dp
    c_act = 12.0
    b_acts = c_act * t_local * d * BF16 * cfg.n_layers * (mult / 3 + 2 / 3)
    # KV cache traffic
    b_cache = 0.0
    if not train:
        if cfg.mla:
            per_tok = (cfg.kv_lora + cfg.rope_head_dim) * BF16
        else:
            per_tok = 2 * cfg.n_kv_heads * hd * BF16
        cache_local = (B / min(dp, max(1, B))) * S * per_tok * n_attn / tp
        if decode:
            # attention reads the cache once; the append is in-place DUS
            # ('scatter', §Perf B1) or a full masked rewrite ('masked')
            b_cache = (1.0 if append_impl == "scatter" else 3.0) \
                * cache_local
        else:
            b_cache = cache_local            # prefill writes it once
    hbm = b_params + b_acts + b_cache

    # ---------------- collective bytes (per device) ----------------
    # EP == DP (experts sharded over 'data', §Perf A1): expert weights are
    # never gathered and expert grads reduce locally; only non-expert
    # params pay FSDP gathers / DP grad sync.
    coll = 0.0
    n_params = MDL.param_count(cfg)
    e_params = expert_param_count(cfg)
    ne_params = n_params - e_params
    n_dense_ffn = cfg.n_layers - n_moe
    ring = 2.0 * (tp - 1) / tp
    # TP activation all-reduces: attention out per attn layer + dense
    # ffn out per dense layer (fwd); bwd has matching ARs (x3 for train)
    if tp > 1:
        # Megatron: 2 ARs/layer fwd, matching 2 in bwd => x2 for train
        ar_mult = 2.0 if train else 1.0
        ar_per_layer = n_attn + n_dense_ffn
        coll += ar_mult * t_local * d * BF16 * ar_per_layer * ring
    if fsdp:
        ne_local = ne_params / (tp * param_dp)
        coll += ne_local * BF16 * n_micro * (param_dp - 1) / param_dp \
            * (2 if train else 1)
    if train:
        grad_local = ne_params / (tp * (param_dp if fsdp else 1)) * F32
        coll += 2.0 * grad_local * (dp - 1) / max(1, dp)
    if n_moe:
        coll += ep_dispatch_bytes(cfg, cell, dp)
        # EPxTP expert-ff term: SPMD picks the cheaper of (a) all-reduce
        # of the (E_local, C, d) expert outputs (ff-sharded compute) or
        # (b) all-gathering the model-sharded expert weights per
        # microbatch (FSDP-over-model) -- charge min of the two (§Perf A6)
        if tp > 1:
            ar_out = mult * t_local * cfg.top_k * cfg.capacity_factor \
                * d * BF16 * n_moe * ring
            e_local_bytes = e_params / param_dp * BF16  # per data shard
            ag_w = e_local_bytes / tp * (tp - 1) * n_micro \
                * (2 if train else 1)
            coll += min(ar_out, ag_w)
    # ------------- analytic device residency (bytes a device) -------------
    # params (+grads f32 +AdamW f32 x2 for train) + KV cache + the remat
    # activation stack + transient working set.
    res_params = p_local * (BF16 + (F32 * 3 if train else 0))
    res_cache = cache_local if not train else 0.0
    t_micro_local = t_local / max(1, n_micro)
    if train:   # remat stack saves x per layer boundary
        res_acts = cfg.n_layers * t_micro_local * d * BF16 \
            + 3.0 * t_micro_local * d * F32      # logits/CE transient
    else:       # inference: a few live boundaries, no layer stack
        res_acts = 4.0 * t_micro_local * d * BF16
    residency = res_params + res_cache + res_acts

    detail = {
        "residency_bytes": residency,
        "f_matmul": mult * f_matmul, "f_attn": mult * f_attn,
        "f_cross": mult * f_cross, "f_recurrent": mult * (
            f_mamba + f_mlstm + f_slstm),
        "b_params": b_params, "b_acts": b_acts, "b_cache": b_cache,
    }
    return CellCost(flops=flops_global / n_dev, hbm_bytes=hbm,
                    coll_bytes=coll,
                    model_flops=model_flops_global / n_dev, detail=detail)
