"""Plain PyTorch version of the selective-scan kernel: the recurrence
stepped once per time step, written in tensors.

Semantics (shared with ``csrc/ssm_scan.cu`` and ``repro``'s
``ssm_scan_ref``): x and dt ``(BH, T, P)``, b and c ``(BH, T, N)``, a
``(P, N)``, d ``(P,)``; every input is upcast to f32, the state ``h``
``(BH, P, N)`` starts at zero, and each step computes

    h   = h * exp(dt_t[..., None] * a) + (dt_t * x_t)[..., None] * b_t
    y_t = sum(h * c_t, -1) + d * x_t

The output has x's dtype.  The reference's time chunks (remat for
training) do not change the values, so this loop has none.
"""

from __future__ import annotations

import torch


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, a: torch.Tensor,
                 d: torch.Tensor) -> torch.Tensor:
    bh, t, p = x.shape
    n = b.shape[-1]
    af = a.float()
    df = d.float()
    h = torch.zeros((bh, p, n), dtype=torch.float32, device=x.device)
    y = torch.empty((bh, t, p), dtype=torch.float32, device=x.device)
    for i in range(t):
        x_t = x[:, i].float()
        dt_t = dt[:, i].float()
        da = torch.exp(dt_t[..., None] * af)
        h = h * da + (dt_t * x_t)[..., None] * b[:, i, None].float()
        y[:, i] = (h * c[:, i, None].float()).sum(dim=-1) + df * x_t
    return y.to(x.dtype)
