"""Plain PyTorch version of the mLSTM scan kernel: the reference's step
body (``repro.models.xlstm.mlstm_forward``'s ``step``) stepped through
the port's ``chunked_remat_scan``.

Semantics (shared with ``csrc/mlstm_scan.cu``): q, k, v ``(B, S, H, P)``
in the activation dtype, the log gates ``log_i`` and ``log_f`` ``(B, S,
H)`` in f32.  The state starts at ``C = 0`` ``(B, H, P, P)``, ``n = 0``
``(B, H, P)`` and ``m = -1e30`` ``(B, H)``, all f32, and each step
computes

    m'  = max(lf + m, li)
    fp  = exp(lf + m - m'),  ip = exp(li - m')
    C   = fp C + ip v k^T,   n = fp n + ip k
    h   = C q / max(|n . q|, 1)

with q, k and v upcast to f32, and writes h in the activation dtype.
At t = 0, ``lf + m - m'`` is about -1e30, so ``fp`` is exactly 0.  Only
the per-step outputs are returned: the reference's prefill drops the
terminal state.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L

#: the reference's scan chunk (remat for training; no effect forward)
CHUNK = 128
M0 = -1e30


def mlstm_step(carry, q_t, k_t, v_t, li, lf, out_dtype):
    """One step: carry ``(C, n, m)``, q/k/v ``(B, H, P)``, li/lf ``(B,
    H)`` -> (carry, h ``(B, H, P)`` in ``out_dtype``)."""
    c, n, m = carry
    m_new = torch.maximum(lf + m, li)
    fp = torch.exp(lf + m - m_new)[..., None]
    ip = torch.exp(li - m_new)[..., None]
    kf = k_t.float()
    vf = v_t.float()
    c = c * fp[..., None] + ip[..., None] * vf[..., :, None] \
        * kf[..., None, :]
    n = n * fp + ip * kf
    qf = q_t.float()
    num = torch.einsum("bhvk,bhk->bhv", c, qf)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, qf)),
                      min=1.0)[..., None]
    return (c, n, m_new), (num / den).to(out_dtype)


def mlstm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_i: torch.Tensor, log_f: torch.Tensor
                   ) -> torch.Tensor:
    b, s, h, p = q.shape
    dev = q.device
    carry = (torch.zeros((b, h, p, p), dtype=torch.float32, device=dev),
             torch.zeros((b, h, p), dtype=torch.float32, device=dev),
             torch.full((b, h), M0, dtype=torch.float32, device=dev))
    xs = tuple(a.transpose(0, 1) for a in (q, k, v, log_i, log_f))

    def step(c, x):
        return mlstm_step(c, *x, out_dtype=q.dtype)

    _, hs = L.chunked_remat_scan(step, carry, xs, chunk=CHUNK)
    return hs.transpose(0, 1)
