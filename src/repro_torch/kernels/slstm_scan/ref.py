"""Plain PyTorch version of the sLSTM scan kernel: the reference's step
(``repro.models.xlstm._slstm_step``) stepped through the port's
``chunked_remat_scan``, with the input projection taken out of the loop.

Semantics (shared with ``csrc/slstm_scan.cu``): ``pre_x = x @ w_in``
``(B, S, 4d)`` and the block-diagonal recurrence ``r_rec`` ``(H, ph,
4 ph)``, both in the activation dtype.  The state starts at ``c = n = 0``
``(B, d)`` and ``m = -1e30`` ``(B, H)`` in f32 and ``h = 0`` ``(B, d)``
in the activation dtype, and each step computes

    rec = (h_prev per head) @ r_rec, f32 sums, rounded; (B, H, 4ph) read
          as (B, 4d) -- so with H = 4 the z gate's recurrent term is
          head 0's, i's head 1's, f's head 2's and o's head 3's
    pre = f32(pre_x_t) + f32(rec)          (see :func:`slstm_step`)
    z, i, f, o = pre split in four (B, d); lf = log_sigmoid(f)
    m'  = max(max_head(lf) + m, max_head(i))     per head of ph units
    fp  = exp(lf + m - m'), ip = exp(i - m')
    c   = fp c + ip tanh(z),  n = fp n + ip
    h   = sigmoid(o) c / max(n, 1e-6), rounded to the activation dtype

and returns every step's h ``(B, S, d)``.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L

CHUNK = 128
M0 = -1e30


def slstm_step(pre_x_t: torch.Tensor, r_rec: torch.Tensor, carry,
               n_heads: int):
    """One step: ``pre_x_t`` ``(B, 4d)``, carry ``(c, n, m, h_prev)`` ->
    the new carry, whose ``h`` is in ``pre_x_t``'s dtype.

    The reference adds ``x_t @ w_in`` and ``rec`` in the activation dtype
    and casts the sum to f32; its compiled step (the scan body's HLO)
    rounds each term to that dtype and adds them in f32 without rounding
    the sum, and so does this."""
    c, n, m, h_prev = carry
    b, d4 = pre_x_t.shape
    d = d4 // 4
    ph = d // n_heads
    hp = h_prev.reshape(b, n_heads, ph).to(r_rec.dtype)
    rec = torch.einsum("bhp,hpq->bhq", hp.float(), r_rec.float()).to(
        r_rec.dtype).reshape(b, d4)
    pre = pre_x_t.float() + rec.float()
    z, i_pre, f_pre, o_pre = pre.split(d, dim=-1)
    zh = torch.tanh(z)
    li = i_pre.reshape(b, n_heads, ph)
    lf = L.log_sigmoid(f_pre).reshape(b, n_heads, ph)
    m_new = torch.maximum(lf.amax(-1) + m, li.amax(-1))
    fp = torch.exp(lf + m[..., None] - m_new[..., None])
    ip = torch.exp(li - m_new[..., None])
    cf = c.reshape(b, n_heads, ph) * fp + ip * zh.reshape(b, n_heads, ph)
    nf = n.reshape(b, n_heads, ph) * fp + ip
    h = L.sigmoid(o_pre) * (cf / torch.clamp(nf, min=1e-6)).reshape(b, d)
    return cf.reshape(b, d), nf.reshape(b, d), m_new, h.to(pre_x_t.dtype)


def slstm_scan_ref(pre_x: torch.Tensor, r_rec: torch.Tensor,
                   n_heads: int) -> torch.Tensor:
    b, s, d4 = pre_x.shape
    d = d4 // 4
    dev = pre_x.device
    carry = (torch.zeros((b, d), dtype=torch.float32, device=dev),
             torch.zeros((b, d), dtype=torch.float32, device=dev),
             torch.full((b, n_heads), M0, dtype=torch.float32, device=dev),
             torch.zeros((b, d), dtype=pre_x.dtype, device=dev))

    def step(cr, x_t):
        new = slstm_step(x_t, r_rec, cr, n_heads)
        return new, new[3]

    _, hs = L.chunked_remat_scan(step, carry, pre_x.transpose(0, 1),
                                 chunk=CHUNK)
    return hs.transpose(0, 1)
