"""Plain PyTorch version of the flash-attention kernel: the same f32
streaming softmax over KV tiles of :data:`BLOCK_K` rows, written in
tensors.

Semantics (shared with ``csrc/flash_attention.cu``):

* q ``(B, Hq, S, D)``, k/v ``(B, Hkv, Sk, D)``, ``Hq % Hkv == 0``; query
  head ``h`` reads KV head ``h // (Hq // Hkv)``;
* scores ``(q . k) * 1/sqrt(D)`` in f32;
* ``causal`` masks column ``c`` for query row ``r`` unless
  ``c <= r + (Sk - S)`` -- the offset of ``repro``'s ``attention_ref`` and
  ``attention_chunked``, so the last query row sees the whole key range;
  ``S > Sk`` under ``causal`` is rejected by the wrapper;
* masked scores contribute exactly 0 (never ``exp(-1e30 - m)``), and a
  row with no unmasked column returns 0 (the Pallas kernel's ``l == 0``
  guard);
* the output has the input dtype.

:func:`attention_qchunk` is the training path, the port of ``repro``'s
``attention_qchunk``: not a plain version of the kernel but the plain
PyTorch attention that autograd differentiates (the kernel has no
backward).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

BLOCK_K = 64       # KV rows per tile, as in the f32 CUDA kernel
BLOCK_Q = 512      # query rows per block of attention_qchunk
NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    b, hq, s, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, g, s, d)
    kf = k.float()
    vf = v.float()
    rows = torch.arange(s, device=q.device)[:, None] + (sk - s)
    m = torch.full((b, hkv, g, s), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, s, d), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, sk, BLOCK_K):
        kb = kf[:, :, k0:k0 + BLOCK_K]                # (B, Hkv, BK, D)
        vb = vf[:, :, k0:k0 + BLOCK_K]
        cols = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None]
        scores = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) * scale
        if causal:
            mask = (cols <= rows).expand(s, kb.shape[2])
        else:
            mask = torch.ones((s, kb.shape[2]), dtype=torch.bool,
                              device=q.device)
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.where(mask, torch.exp(scores - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd",
                                                    p, vb)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = acc / l[..., None]
    return out.reshape(b, hq, s, d).to(q.dtype)


def attention_qchunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True,
                     block_q: int = BLOCK_Q) -> torch.Tensor:
    """Attention over blocks of ``min(block_q, S)`` query rows, each
    against the whole of K and V in f32 (one ``(BQ, Sk)`` score tile and
    a softmax a block), output cast to q's dtype.  Under autograd each
    block's body is checkpointed: the backward recomputes its score tile,
    so a block's tile is the only ``O(S * Sk)`` tensor alive at a time.
    Masked scores are ``-1e30`` before the softmax (the reference's
    ``jnp.where``), so a query row needs one unmasked column: causal
    attention with ``S <= Sk`` has it."""
    b, hq, s, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    bq = min(block_q, s)
    if s % bq:
        raise ValueError(f"seq {s} % block_q {bq} != 0")
    qf = (q.float() * (1.0 / (d ** 0.5))).reshape(b, hkv, g, s, d)
    kf = k.float()
    vf = v.float()
    offset = sk - s                       # the query rows' absolute offset

    def body(qb: torch.Tensor, q0: int) -> torch.Tensor:
        scores = torch.einsum("bhgqd,bhkd->bhgqk", qb, kf)
        if causal:
            rows = offset + q0 + torch.arange(bq, device=q.device)[:, None]
            cols = torch.arange(sk, device=q.device)[None, :]
            scores = torch.where(rows >= cols, scores, NEG_INF)
        return torch.einsum("bhgqk,bhkd->bhgqd",
                            torch.softmax(scores, dim=-1), vf)

    remat = torch.is_grad_enabled()
    outs = []
    for q0 in range(0, s, bq):
        qb = qf[:, :, :, q0:q0 + bq]
        outs.append(checkpoint(body, qb, q0, use_reentrant=False) if remat
                    else body(qb, q0))
    return torch.cat(outs, dim=3).reshape(b, hq, s, d).to(q.dtype)
