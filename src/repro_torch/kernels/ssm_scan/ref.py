"""Plain PyTorch version of the selective-scan kernel: the recurrence
stepped once per time step, written in tensors.

Semantics (shared with ``csrc/ssm_scan.cu`` and ``repro``'s
``ssm_scan_ref``): x and dt ``(BH, T, P)``, b and c ``(BH, T, N)``, a
``(P, N)``, d ``(P,)``; every input is upcast to f32, the state ``h``
``(BH, P, N)`` starts at zero, and each step computes

    h   = h * exp(dt_t[..., None] * a) + (dt_t * x_t)[..., None] * b_t
    y_t = sum(h * c_t, -1) + d * x_t

The output has x's dtype.  The reference's time chunks (remat for
training) do not change the values, so this loop has none.  On ``meta``
inputs (the dry run) the step runs once and stands for the T steps
(``layers.scan_once_on_meta``).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, a: torch.Tensor,
                 d: torch.Tensor) -> torch.Tensor:
    bh, t, p = x.shape
    n = b.shape[-1]
    af = a.float()
    df = d.float()
    h = torch.zeros((bh, p, n), dtype=torch.float32, device=x.device)

    def step(h, xs_t):
        x_t, dt_t, b_t, c_t = (v.float() for v in xs_t)
        da = torch.exp(dt_t[..., None] * af)
        h = h * da + (dt_t * x_t)[..., None] * b_t[:, None]
        return h, (h * c_t[:, None]).sum(dim=-1) + df * x_t

    xs = tuple(v.transpose(0, 1) for v in (x, dt, b, c))
    once = L.scan_once_on_meta(step, h, xs)
    if once is not None:
        return once[1].transpose(0, 1).contiguous().to(x.dtype)
    y = torch.empty((bh, t, p), dtype=torch.float32, device=x.device)
    for i in range(t):
        h, y[:, i] = step(h, tuple(v[i] for v in xs))
    return y.to(x.dtype)
