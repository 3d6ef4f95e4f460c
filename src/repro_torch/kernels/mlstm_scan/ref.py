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

:func:`mlstm_scan_ref` steps that recurrence (the kernels' yardstick).
:func:`mlstm_chunkwise_ref` computes the same function a chunk of
``chunk`` steps at a time, as the chunkwise kernel
(``csrc/mlstm_chunkwise.cu``) does; see its docstring for the algebra.
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


#: the chunkwise kernel's chunk length
CHUNKWISE_L = 32


#: how the chunkwise kernel hands its f32 operands to the tensor cores
KERNEL_OPERANDS = "bf16x3"


def _operand(x: torch.Tensor, operands: str) -> torch.Tensor:
    """``x`` (f32) as bf16 tensor-core operands would carry it:
    ``"f32"`` unrounded, ``"bf16"`` rounded once, ``"bf16x2"`` as a pair
    ``hi = bf16(x)``, ``lo = bf16(x - hi)``, ``"bf16x3"`` (the chunkwise
    kernel's) as a triple ``hi``, ``mid = bf16(x - hi)``, ``lo = bf16(x -
    hi - mid)``, each rounded to nearest even, whose products the kernel
    sums (to 2^-16 and 2^-24 of x, against 2^-8 for one rounding)."""
    if operands == "f32":
        return x
    hi = x.to(torch.bfloat16).float()
    if operands == "bf16":
        return hi
    rest = x - hi
    mid = rest.to(torch.bfloat16).float()
    if operands == "bf16x2":
        return hi + mid
    if operands == "bf16x3":
        return hi + mid + (rest - mid).to(torch.bfloat16).float()
    raise ValueError(f"unknown operands {operands!r}: f32, bf16, bf16x2 or "
                     f"bf16x3")


def mlstm_chunkwise_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_i: torch.Tensor, log_f: torch.Tensor, *,
                        chunk: int = CHUNKWISE_L,
                        operands: str = "f32") -> torch.Tensor:
    """The mLSTM scan a chunk of ``chunk`` steps at a time (the algorithm
    of ``csrc/mlstm_chunkwise.cu``, in plain torch).

    The stabiliser is stepped exactly as :func:`mlstm_step` steps it, so
    ``m_t`` equals the stepped version's bit for bit, and so do the
    per-step log factors ``a_s = (lf_s + m_{s-1}) - m_s`` (``log fp``)
    and ``b_j = li_j - m_j`` (``log ip``).  The recurrence telescopes: at
    step t of a chunk, the update of step j <= t weighs ``D[t, j] =
    exp(b_j + seg(j, t))`` and the carried state ``cw_t =
    exp(seg(-1, t))``, where ``seg(j, t) = a_{j+1} + ... + a_t`` is
    summed in that order (all terms <= 0, so no digits cancel, as they
    would in a difference of two running sums when the forget gates are
    near 0).  With ``S = Q K^T`` over the chunk,

        den_t = cw_t (n . q_t) + sum_j S[t, j] D[t, j]
        h_t   = (cw_t C q_t + sum_j S[t, j] D[t, j] v_j) / max(|den_t|, 1)

    and at the end of a chunk that another follows, with ``w_j = D[L-1,
    j]``, ``C = cw_{L-1} C + sum_j w_j v_j k_j^T`` and ``n = cw_{L-1} n
    + sum_j w_j k_j``.  ``operands`` emulates how a kernel hands the
    three f32 tensor-core operands over (``S * D`` in the intra-chunk
    product, C in the inter-chunk one, ``w * v`` in the state update):
    see :func:`_operand`; :data:`KERNEL_OPERANDS` is the chunkwise
    kernel's.  Everything else is f32, as in the kernel; h is written in
    q's dtype."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, not {chunk}")
    b, s, h, p = q.shape
    dev = q.device
    c = torch.zeros((b, h, p, p), dtype=torch.float32, device=dev)
    n = torch.zeros((b, h, p), dtype=torch.float32, device=dev)
    m = torch.full((b, h), M0, dtype=torch.float32, device=dev)
    out = torch.empty((b, s, h, p), dtype=q.dtype, device=dev)
    for t0 in range(0, s, chunk):
        nc = min(chunk, s - t0)
        qc, kc, vc = (x[:, t0:t0 + nc].float().transpose(1, 2)
                      for x in (q, k, v))                  # (b, h, nc, p)
        li, lf = (x[:, t0:t0 + nc].transpose(1, 2)
                  for x in (log_i, log_f))                 # (b, h, nc)
        a = torch.empty_like(li)
        bj = torch.empty_like(li)
        for t in range(nc):
            x = lf[..., t] + m
            m_new = torch.maximum(x, li[..., t])
            a[..., t] = x - m_new
            bj[..., t] = li[..., t] - m_new
            m = m_new
        # seg(j, t) for j < t carried row to row in ascending order; the
        # carry's column seg(-1, t) beside it
        idx = torch.arange(nc, device=dev)
        seg = torch.zeros((b, h, nc, nc), dtype=torch.float32, device=dev)
        run = torch.zeros((b, h, nc), dtype=torch.float32, device=dev)
        segc = torch.zeros((b, h), dtype=torch.float32, device=dev)
        cw = torch.empty_like(li)
        for t in range(nc):
            run = torch.where(idx < t, run + a[..., t, None], run)
            seg[..., t, :] = run
            segc = segc + a[..., t]
            cw[..., t] = torch.exp(segc)
        causal = idx[None, :] <= idx[:, None]              # j <= t
        d = torch.where(causal, torch.exp(bj[..., None, :] + seg),
                        torch.zeros((), device=dev))
        sd = (qc @ kc.transpose(-1, -2)) * d               # (b, h, t, j)
        den = cw * (qc @ n[..., None])[..., 0] + sd.sum(-1)
        num = cw[..., None] * (qc @ _operand(c, operands).transpose(-1, -2)) \
            + _operand(sd, operands) @ vc
        hc = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
        out[:, t0:t0 + nc] = hc.transpose(1, 2).to(q.dtype)
        if t0 + nc < s:
            w = d[..., nc - 1, :]                          # (b, h, j)
            last = cw[..., nc - 1]
            c = last[..., None, None] * c + _operand(
                vc * w[..., None], operands).transpose(-1, -2) @ kc
            n = last[..., None] * n + (w[..., None] * kc).sum(-2)
    return out
