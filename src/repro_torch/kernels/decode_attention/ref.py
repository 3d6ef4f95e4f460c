"""Plain PyTorch version of the decode-attention kernel: the same f32
streaming softmax over cache tiles of :data:`BLOCK_S` rows, written in
tensors.

Semantics (shared with ``csrc/decode_attention.cu``): q ``(B, Hq, D)``
against the cache-native k/v ``(B, S, Hkv, D)``; query head
``hk * G + g`` reads KV head ``hk``; cache rows at or past ``lengths[b]``
are masked and contribute exactly 0; scores ``(q . k) / sqrt(D)`` in f32;
the output has q's dtype, and a sequence with ``lengths[b] == 0`` gets 0
-- the Pallas kernel's ``l == 0`` guard.  ``repro``'s
``decode_attention_ref`` and ``decode_attention_chunked`` return the mean
of V there instead (their masked ``-1e30`` logits softmax to uniform
weights); the serving path never asks, since its lengths are >= 1.
"""

from __future__ import annotations

import torch

BLOCK_S = 64       # cache rows per tile, as in the CUDA kernel
NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, g, d)
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    m = torch.full((b, hkv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, d), dtype=torch.float32, device=q.device)
    for s0 in range(0, s, BLOCK_S):
        kb = k[:, s0:s0 + BLOCK_S].float()           # (B, BS, Hkv, D)
        vb = v[:, s0:s0 + BLOCK_S].float()
        pos = torch.arange(s0, s0 + kb.shape[1], device=q.device)
        mask = (pos[None, :] < lengths[:, None])[:, None, None]
        scores = torch.einsum("bhgd,bkhd->bhgk", qf, kb) * scale
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.where(mask, torch.exp(scores - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgk,bkhd->bhgd", p,
                                                    vb)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l[..., None]).reshape(b, hq, d).to(q.dtype)


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, lengths: torch.Tensor,
                               rows_per_split: int) -> torch.Tensor:
    """The kernel's two stages in tensors: each split of
    ``rows_per_split`` cache rows (a multiple of :data:`BLOCK_S`) runs the
    streaming softmax of :func:`decode_attention_ref` over its own rows
    into a partial ``(m, l, acc)`` -- an empty split keeps ``m = -inf,
    l = 0`` -- and the partials are combined by log-sum-exp: weights
    ``exp(m_i - max m)`` over the splits with ``l > 0``, output
    ``sum w_i acc_i / sum w_i l_i``, 0 where every split is empty."""
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, g, d)
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    parts = []
    for c0 in range(0, s, rows_per_split):
        c1 = min(c0 + rows_per_split, s)
        m = torch.full((b, hkv, g), float("-inf"), dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, d), dtype=torch.float32,
                          device=q.device)
        for s0 in range(c0, c1, BLOCK_S):
            kb = k[:, s0:min(s0 + BLOCK_S, c1)].float()
            vb = v[:, s0:min(s0 + BLOCK_S, c1)].float()
            pos = torch.arange(s0, s0 + kb.shape[1], device=q.device)
            mask = (pos[None, :] < lengths[:, None])[:, None, None]
            scores = torch.einsum("bhgd,bkhd->bhgk", qf, kb) * scale
            scores = torch.where(mask, scores, float("-inf"))
            m_new = torch.maximum(m, scores.amax(dim=-1))
            m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
            p = torch.exp(scores - m_use[..., None])
            alpha = torch.exp(m - m_use)
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgk,bkhd->bhgd",
                                                        p, vb)
            m = m_new
        parts.append((m, l, acc))
    m_all = torch.stack([m for m, _, _ in parts])        # (n_split, B, Hkv, G)
    l_all = torch.stack([l for _, l, _ in parts])
    live = l_all > 0
    top = torch.where(live, m_all, float("-inf")).amax(dim=0)
    w = torch.where(live, torch.exp(m_all - top), 0.0)
    total = (w * l_all).sum(dim=0)
    acc = sum(torch.where(live[i, ..., None], w[i, ..., None] * a, 0.0)
              for i, (_, _, a) in enumerate(parts))
    inv = torch.where(total == 0.0, 0.0, 1.0 / total)
    return (acc * inv[..., None]).reshape(b, hq, d).to(q.dtype)


def decode_attention_dense(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor
                           ) -> torch.Tensor:
    """The same function in one pass over the whole cache (the reference's
    ``impl="xla"`` decode, ``repro.kernels.decode_attention.ref``): f32
    scores for every row, masked, and the softmax written out as a max, a
    sum of exponentials and a product with V -- over a sequence-sharded
    cache (a DTensor) each is a local reduction plus a small all-reduce,
    where the tiled :func:`decode_attention_ref` would slice the sharded
    rows.  Masked rows contribute exactly 0, and ``lengths[b] == 0``
    gives 0, as in :func:`decode_attention_ref`."""
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    qf = q.float().reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k.float()) * (d ** -0.5)
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] < lengths.long()[:, None])[:, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.where(mask, torch.exp(scores - scores.amax(-1, keepdim=True)),
                    0.0)
    l = p.sum(-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    out = out / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)
