"""GQA self-attention with KV-cache serving, and cross-attention over a
fixed-length memory (the port of ``repro.models.attention``).

* Prefill attention goes through the flash-attention kernel
  (:func:`repro_torch.kernels.flash_attention.ops.attention`), decode
  through the decode-attention kernel over the cache; ``impl="kernel"``
  launches them on CUDA tensors (and runs their plain versions on CPU
  tensors), ``impl="ref"`` runs the plain versions everywhere.
* KV cache layout ``(B, S, Hkv, D)``, bf16 whatever the parameter dtype,
  as in the reference.  Unlike the reference's functional updates, the
  port writes the cache IN PLACE (prefill from position 0, decode one
  row per sequence) and returns the same dict.
* Projections stay ``x @ W`` with ``(d_in, d_out)`` weights, and q/k are
  roped in the ``(B, S, H, D)`` layout of the projection; the kernel
  reads the ``(B, H, S, D)`` views through their strides, so neither side
  is copied into another layout.  The output projection ``wo`` goes
  through ``shards.row_parallel``: ``o @ wo`` on a plain tensor, and on
  placed heads each rank's f32 partial product summed before one
  rounding.
* Cross-attention (VLM image layers, the enc-dec decoder) has no rope and
  no mask: prefill is non-causal flash attention over the memory's
  ``Sk = M`` rows, decode is decode attention with every length ``M``
  over the memory K/V that prefill wrote.  The memory may be bf16 under
  f32 weights; ``memory @ W`` then promotes as ``jnp`` does (the weights
  are never cast down).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import (
    attention as flash_attention)
from repro_torch.models import layers as L
from repro_torch.models import shards


def attn_init(generator, d_model: int, n_heads: int, n_kv_heads: int,
              head_dim: int, *, device,
              dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    def dense(d_in, d_out):
        return L.dense_init(generator, d_in, d_out, device=device,
                            dtype=dtype)
    return {"wq": dense(d_model, n_heads * head_dim),
            "wk": dense(d_model, n_kv_heads * head_dim),
            "wv": dense(d_model, n_kv_heads * head_dim),
            "wo": dense(n_heads * head_dim, d_model)}


def init_kv_cache(batch: int, max_seq: int, n_kv_heads: int, head_dim: int,
                  *, device, dtype: torch.dtype = torch.bfloat16
                  ) -> Dict[str, torch.Tensor]:
    shape = (batch, max_seq, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_rows(c: torch.Tensor, new: torch.Tensor,
               pos: torch.Tensor) -> None:
    """Write ``new[b]`` (``c``'s trailing shape) at row ``pos[b]`` of
    sequence ``b`` of cache ``c`` (``(B, max_seq, ...)``), in place.  A
    ``pos`` outside ``[0, max_seq)`` is dropped, like the reference's
    ``.at[rows, pos].set(mode="drop")`` -- without a host sync: the row at
    the clamped index is rewritten with its old value."""
    if shards.is_dtensor(c):
        return shards.write_rows(c, new, pos, write_rows)
    max_seq = c.shape[1]
    rows = torch.arange(pos.shape[0], device=pos.device)
    keep = ((pos >= 0) & (pos < max_seq)).view(-1, *[1] * (new.dim() - 1))
    idx = pos.clamp(0, max_seq - 1).long()
    c[rows, idx] = torch.where(keep, new.to(c.dtype), c[rows, idx])


def cache_append(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                 v_new: torch.Tensor, pos: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """Write row ``pos[b]`` of sequence ``b`` (k_new/v_new ``(B, Hkv,
    D)``) in place; out-of-range positions are dropped
    (:func:`write_rows`)."""
    write_rows(cache["k"], k_new, pos)
    write_rows(cache["v"], v_new, pos)
    return cache


def _attend(q, k, v, *, causal: bool, impl: str) -> torch.Tensor:
    """Flash attention over ``(B, H, S, D)``; placed q/k/v run the plain
    versions on each rank's shards (:func:`shards.on_shards`), and the
    kernel takes them as they are (its wrapper refuses a DTensor)."""
    def fn(q, k, v):
        return flash_attention(q, k, v, causal=causal, impl=impl)
    if impl == "kernel":
        return fn(q, k, v)
    return shards.on_shards(fn, q, k, v, 1)


def _decode(q, k, v, lengths, *, impl: str) -> torch.Tensor:
    """Decode attention of q ``(B, H, D)`` over a ``(B, S, Hkv, D)`` cache
    (see :func:`_attend`)."""
    def fn(q, k, v, n):
        return decode_attention(q, k, v, n, impl=impl)
    if impl == "kernel":
        return fn(q, k, v, lengths)
    return shards.on_shards(fn, q, k, v, 2, lengths)


def _project(p, x, n_heads, n_kv_heads, head_dim):
    q = shards.heads(x @ p["wq"], n_heads, head_dim, n_kv_heads)
    k = shards.heads(x @ p["wk"], n_kv_heads, head_dim)
    v = shards.heads(x @ p["wv"], n_kv_heads, head_dim)
    return q, k, v


def attn_forward(p, x: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                 head_dim: int, rope_theta: float, causal: bool = True,
                 positions: Optional[torch.Tensor] = None,
                 impl: str = "kernel", use_rope: bool = True
                 ) -> torch.Tensor:
    """Full-sequence self-attention. x: (B, S, d)."""
    b, s, _ = x.shape
    q, k, v = _project(p, x, n_heads, n_kv_heads, head_dim)
    if use_rope:
        pos = (positions if positions is not None
               else torch.arange(s, device=x.device))
        q = L.apply_rope(q, pos[..., None], rope_theta)
        k = L.apply_rope(k, pos[..., None], rope_theta)
    o = _attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, impl=impl)
    return shards.row_parallel(
        o.transpose(1, 2).reshape(b, s, n_heads * head_dim), p["wo"])


def attn_prefill(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], *,
                 n_heads: int, n_kv_heads: int, head_dim: int,
                 rope_theta: float, impl: str = "kernel"
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: full causal attention AND write the roped K and the
    un-roped V into the cache from position 0."""
    b, s, _ = x.shape
    q, k, v = _project(p, x, n_heads, n_kv_heads, head_dim)
    pos = torch.arange(s, device=x.device)[:, None]      # (S, 1): per head
    qr = L.apply_rope(q, pos, rope_theta)                 # (B, S, H, D)
    kr = L.apply_rope(k, pos, rope_theta)
    o = _attend(qr.transpose(1, 2), kr.transpose(1, 2), v.transpose(1, 2),
                causal=True, impl=impl)
    shards.write_prefix(cache["k"], kr)
    shards.write_prefix(cache["v"], v)
    out = shards.row_parallel(
        o.transpose(1, 2).reshape(b, s, n_heads * head_dim), p["wo"])
    return out, cache


def attn_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                pos: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                head_dim: int, rope_theta: float, impl: str = "kernel"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B, d); pos: (B,) int32 current lengths."""
    b = x.shape[0]
    q, k, v = _project(p, x, n_heads, n_kv_heads, head_dim)
    pos_b = pos[:, None, None]                           # (B, 1, 1)
    q = L.apply_rope(q[:, :, None, :], pos_b, rope_theta)[:, :, 0]
    k = L.apply_rope(k[:, :, None, :], pos_b, rope_theta)[:, :, 0]
    cache = cache_append(cache, k, v, pos)
    o = _decode(q, cache["k"], cache["v"], pos + 1, impl=impl)
    return shards.row_parallel(o.reshape(b, n_heads * head_dim),
                               p["wo"]), cache


# --------------------------------------------------------------------- #
# cross-attention (VLM image layers, enc-dec decoder)
# --------------------------------------------------------------------- #
def cross_init(generator, d_model: int, n_heads: int, n_kv_heads: int,
               head_dim: int, *, device,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    return attn_init(generator, d_model, n_heads, n_kv_heads, head_dim,
                     device=device, dtype=dtype)


def _matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the dtype ``jnp`` promotes the two to (``torch.matmul``
    refuses mixed dtypes): bf16 memory under f32 weights is cast up
    exactly, as XLA does."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def memory_kv(p, memory: torch.Tensor, *, n_kv_heads: int,
              head_dim: int) -> Dict[str, torch.Tensor]:
    """The cross-attention K/V of ``memory`` (B, M, d): ``{"k", "v"}`` of
    shape ``(B, M, Hkv, D)`` in the projection's dtype."""
    return {name: shards.heads(_matmul(memory, p[f"w{name}"]), n_kv_heads,
                               head_dim) for name in ("k", "v")}


def _cross_attend(p, x: torch.Tensor, kv: Dict[str, torch.Tensor], *,
                  n_heads: int, head_dim: int, impl: str) -> torch.Tensor:
    b, s, _ = x.shape
    q = shards.heads(x @ p["wq"], n_heads, head_dim, kv["k"].shape[2])
    o = _attend(q.transpose(1, 2), kv["k"].transpose(1, 2),
                kv["v"].transpose(1, 2), causal=False, impl=impl)
    return shards.row_parallel(
        o.transpose(1, 2).reshape(b, s, n_heads * head_dim), p["wo"])


def cross_forward(p, x: torch.Tensor, memory: torch.Tensor, *,
                  n_heads: int, n_kv_heads: int, head_dim: int,
                  impl: str = "kernel") -> torch.Tensor:
    """x: (B, S, d) queries; memory: (B, M, d).  No rope, not causal."""
    kv = memory_kv(p, memory, n_kv_heads=n_kv_heads, head_dim=head_dim)
    return _cross_attend(p, x, kv, n_heads=n_heads, head_dim=head_dim,
                         impl=impl)


def cross_prefill(p, x: torch.Tensor, memory: torch.Tensor,
                  cache: Dict[str, torch.Tensor], *, n_heads: int,
                  n_kv_heads: int, head_dim: int, impl: str = "kernel"
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`cross_forward`, with the memory K/V (the reference's
    ``build_memory_kv``, the same products) written into ``cache``
    (``{"k", "v"}`` of ``(B, M, Hkv, D)``, the projection's dtype) in
    place."""
    kv = memory_kv(p, memory, n_kv_heads=n_kv_heads, head_dim=head_dim)
    for name in ("k", "v"):
        if cache[name].dtype != kv[name].dtype:
            raise TypeError(f"memory {name} cache is {cache[name].dtype}, "
                            f"the projection {kv[name].dtype}: it would "
                            f"round the memory K/V")
        cache[name].copy_(kv[name])
    return _cross_attend(p, x, kv, n_heads=n_heads, head_dim=head_dim,
                         impl=impl), cache


def cross_decode(p, x: torch.Tensor, memory_kv: Dict[str, torch.Tensor], *,
                 n_heads: int, n_kv_heads: int, head_dim: int,
                 lengths: Optional[torch.Tensor] = None,
                 impl: str = "kernel") -> torch.Tensor:
    """Decode-time cross-attention against precomputed memory K/V.

    x: (B, d); memory_kv: {'k','v': (B, M, Hkv, D)}; ``lengths`` (B,)
    int32, every entry M (made here when not given: a caller that steps
    many times keeps one buffer)."""
    b = x.shape[0]
    q = shards.heads(x @ p["wq"], n_heads, head_dim, n_kv_heads)
    if lengths is None:
        lengths = torch.full((b,), memory_kv["k"].shape[1],
                             dtype=torch.int32, device=x.device)
    o = _decode(q, memory_kv["k"], memory_kv["v"], lengths, impl=impl)
    return shards.row_parallel(o.reshape(b, n_heads * head_dim), p["wo"])
