"""Multi-head latent attention, DeepSeek-V2 (arXiv:2405.04434): the port
of ``repro.models.mla``.

* Prefill runs the full (decompressed) form: per-head K_nope and V are
  materialised from the ``kv_lora`` latent, and attention runs through
  the flash-attention kernel
  (:func:`repro_torch.kernels.flash_attention.ops.attention`) at head dim
  ``nope + rope`` (192 for deepseek-v2).  The kernel takes one head dim
  for q, k and v, so V is zero-padded from ``v_head_dim`` to it and the
  output sliced back, as the reference does.  ``impl="kernel"`` launches
  the kernel on CUDA tensors (its plain version on CPU tensors);
  ``impl="ref"`` runs the plain version everywhere.
* Decode runs the absorbed form: the cache holds only the latent
  ``c_kv`` ``(B, max_seq, kv_lora)`` and the shared roped key ``k_rope``
  ``(B, max_seq, rope)``, both bf16; W_uk is absorbed into the query and
  W_uv into the output, so scores and values contract against the
  latent.  No kernel runs there: the reference's decode is plain
  ``einsum``s too.  Its products of bf16 operands with an f32 result
  (``preferred_element_type``) are f32 products here -- both operands
  cast to f32, which is exact -- and need TF32 off on the card.
* Unlike the reference's functional updates, prefill writes the latent
  cache IN PLACE from position 0 and decode one row a sequence
  (out-of-range positions write nothing), returning the same dict.
  Prefill computes ``c_kv`` and ``k_rope`` once; the reference computes
  them twice, to identical values.
* Layout: projections ``x @ W`` with ``(d_in, d_out)`` weights; q and k
  are roped in the ``(B, S, H, D)`` layout of the projection and the
  kernel reads their ``(B, H, S, D)`` views through the strides.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import (
    attention as flash_attention)
from repro_torch.models import layers as L
from repro_torch.models import shards
from repro_torch.models.attention import write_rows


def mla_init(generator, cfg: ArchConfig, *, device,
             dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    d, h = cfg.d_model, cfg.n_heads
    dq = cfg.nope_head_dim + cfg.rope_head_dim

    def dense(d_in, d_out):
        return L.dense_init(generator, d_in, d_out, device=device,
                            dtype=dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    return {"w_dq": dense(d, cfg.q_lora), "q_norm": ones(cfg.q_lora),
            "w_uq": dense(cfg.q_lora, h * dq),
            "w_dkv": dense(d, cfg.kv_lora), "kv_norm": ones(cfg.kv_lora),
            "w_krope": dense(d, cfg.rope_head_dim),
            "w_uk": dense(cfg.kv_lora, h * cfg.nope_head_dim),
            "w_uv": dense(cfg.kv_lora, h * cfg.v_head_dim),
            "wo": dense(h * cfg.v_head_dim, d)}


def init_mla_cache(batch: int, max_seq: int, cfg: ArchConfig, *, device,
                   dtype: torch.dtype = torch.bfloat16
                   ) -> Dict[str, torch.Tensor]:
    return {"c_kv": torch.zeros((batch, max_seq, cfg.kv_lora), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_seq, cfg.rope_head_dim),
                                  dtype=dtype, device=device)}


def _project_q(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(B, S, d)`` or ``(B, d)`` -> q_nope ``(B, S, H, Dn)``, q_rope
    ``(B, S, H, Dr)`` roped (S = 1 for a ``(B, d)`` x); ``positions``
    broadcasts against ``(B, S, H)``."""
    x3 = x if x.dim() == 3 else x[:, None]
    b, s = x3.shape[:2]
    cq = L.rmsnorm(x3 @ p["w_dq"], p["q_norm"])
    q = (cq @ p["w_uq"]).view(b, s, cfg.n_heads,
                              cfg.nope_head_dim + cfg.rope_head_dim)
    q_nope, q_rope = q.split([cfg.nope_head_dim, cfg.rope_head_dim], dim=-1)
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _latent(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache entries of x ``(..., d)``: ``c_kv`` ``(..., kv_lora)`` and
    the roped ``k_rope`` ``(..., Dr)`` (``positions`` broadcasts against
    x's leading dims)."""
    c_kv = L.rmsnorm(x @ p["w_dkv"], p["kv_norm"])
    return c_kv, L.apply_rope(x @ p["w_krope"], positions, cfg.rope_theta)


def _attend(p, x: torch.Tensor, cfg: ArchConfig, c_kv: torch.Tensor,
            k_rope: torch.Tensor, causal: bool, impl: str) -> torch.Tensor:
    """The full form over x ``(B, S, d)`` and its latent entries."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _project_q(p, x, cfg,
                                torch.arange(s, device=x.device)[:, None])
    k_nope = (c_kv @ p["w_uk"]).view(b, s, h, dn)
    v = (c_kv @ p["w_uv"]).view(b, s, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, dr)], dim=-1)
    # the kernel takes one head dim: zero-pad V to nope + rope, slice back
    vp = F.pad(v, (0, dn + dr - dv)) if dn + dr > dv else v
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        vp.transpose(1, 2), causal=causal, impl=impl)
    o = o.transpose(1, 2)[..., :dv].reshape(b, s, h * dv)
    return o @ p["wo"]


def mla_forward(p, x: torch.Tensor, cfg: ArchConfig, *, causal: bool = True,
                impl: str = "kernel") -> torch.Tensor:
    """The full form. x ``(B, S, d)``."""
    c_kv, k_rope = _latent(p, x, cfg, torch.arange(x.shape[1],
                                                   device=x.device))
    return _attend(p, x, cfg, c_kv, k_rope, causal, impl)


def mla_prefill(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                cfg: ArchConfig, *, impl: str = "kernel"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal full-form attention, and ``c_kv`` / ``k_rope`` written into
    the cache from position 0."""
    s = x.shape[1]
    c_kv, k_rope = _latent(p, x, cfg, torch.arange(s, device=x.device))
    out = _attend(p, x, cfg, c_kv, k_rope, True, impl)
    shards.write_prefix(cache["c_kv"], c_kv)
    shards.write_prefix(cache["k_rope"], k_rope)
    return out, cache


def mla_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: torch.Tensor, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed decode. x ``(B, d)``; pos ``(B,)`` int32 current lengths."""
    b = x.shape[0]
    h, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _project_q(p, x, cfg, pos[:, None, None])
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]              # (B, H, D.)
    c_new, kr_new = _latent(p, x, cfg, pos)
    write_rows(cache["c_kv"], c_new, pos)
    write_rows(cache["k_rope"], kr_new, pos)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]

    # absorb W_uk into q: q_c (B, H, kv_lora); every product below is of
    # f32 operands (bf16 ones cast exactly), as the reference's f32
    # einsums and preferred_element_type=f32 give
    w_uk = p["w_uk"].view(cfg.kv_lora, h, dn)
    q_c = torch.einsum("bhd,lhd->bhl", q_nope.float(), w_uk.float())
    c_f = c_kv.float()
    logits = (torch.einsum("bhl,bsl->bhs", q_c.to(c_kv.dtype).float(), c_f)
              + torch.einsum("bhr,bsr->bhs", q_rope.float(),
                             k_rope.float())) * (1.0 / math.sqrt(dn + dr))
    mask = (torch.arange(c_kv.shape[1], device=x.device)[None, None, :]
            <= pos[:, None, None])
    probs = torch.softmax(torch.where(mask, logits, -1e30), dim=-1)
    ctx = torch.einsum("bhs,bsl->bhl", probs.to(c_kv.dtype).float(), c_f)
    # absorb W_uv into the output
    w_uv = p["w_uv"].view(cfg.kv_lora, h, dv)
    o = torch.einsum("bhl,lhv->bhv", ctx, w_uv.float())
    return o.reshape(b, h * dv).to(x.dtype) @ p["wo"], cache
