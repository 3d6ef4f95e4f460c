"""Mamba-1 (S6) selective-SSM block, Jamba's sequence mixer (the port of
``repro.models.mamba``).

Block: in_proj -> (x, z); causal depthwise conv + SiLU on x; the
data-dependent (dt, B, C) projections; the diagonal selective scan (the
``ssm_scan`` kernel on CUDA tensors, its plain version on CPU tensors);
gate by SiLU(z); out_proj.

Rounding follows the reference step by step: the projections and the
split run in the activation dtype, the conv accumulates in f32 and is
cast back before SiLU, ``dt_bias`` is cast to the activation dtype
before the add, SiLU's sigmoid and softplus round op by op in that dtype
as XLA lowers them, the scan runs in f32 and returns the activation
dtype, and the gate is taken in that dtype.  Decode follows the
reference's compiled step, which keeps two products in f32 (see
:func:`mamba_decode`).

Serving state per layer: the conv tail ``(B, K-1, d_inner)`` in bf16 and
the SSM state ``(B, d_inner, N)`` in f32.  :func:`mamba_decode` updates
both IN PLACE (the reference returns new arrays).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import layers as L


def mamba_init(generator, d_model: int, *, expand: int = 2,
               state: int = 16, conv: int = 4, device,
               dtype: torch.dtype = torch.bfloat16
               ) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    d_inner = expand * d_model
    dt_rank = max(1, math.ceil(d_model / 16))

    def dense(d_in, d_out):
        return L.dense_init(generator, d_in, d_out, device=device,
                            dtype=dtype)
    a = torch.arange(1, state + 1, dtype=torch.float32,
                     device=device).repeat(d_inner, 1)
    return {
        "in_proj": dense(d_model, 2 * d_inner),
        "conv_w": L.dense_init(generator, conv, d_inner, device=device,
                               dtype=dtype, scale=0.1),
        "x_proj": dense(d_inner, dt_rank + 2 * state),
        "dt_proj": dense(dt_rank, d_inner),
        "dt_bias": torch.zeros(d_inner, dtype=torch.float32, device=device),
        "a_log": torch.log(a),                       # (d_inner, N) f32
        "d_skip": torch.ones(d_inner, dtype=torch.float32, device=device),
        "out_proj": dense(d_inner, d_model),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``jnp.logaddexp(x, 0)``: ``max(x, 0)
    + log1p(exp(-|x|))`` with no threshold
    (``torch.nn.functional.softplus`` returns ``x`` itself above
    ``threshold=20``), each op rounded to x's dtype as in the reference
    (``torch.logaddexp`` rounds once, which in bf16 lands an ulp away
    from the reference on some inputs)."""
    return (torch.clamp(x, min=0)
            + torch.log1p(torch.exp(-torch.abs(x))))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x ``(B, S, C)``, w ``(K, C)``: K explicit
    taps accumulated in f32, then cast to x's dtype.  (Not ``conv1d``: a
    float32 convolution goes through cuDNN in TF32 by default.)"""
    k, s = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].float() * w[i].float()
    return out.to(x.dtype)


def _split_xdbc(p, xc: torch.Tensor, state: int):
    """(dt, b, c) from the conv output; b and c are column views of the
    ``x_proj`` output (row stride ``dt_rank + 2 * state``)."""
    dt_rank = p["dt_proj"].shape[0]
    xdbc = xc @ p["x_proj"]
    dt_r = xdbc[..., :dt_rank]
    b = xdbc[..., dt_rank:dt_rank + state]
    c = xdbc[..., dt_rank + state:]
    dt = softplus(dt_r @ p["dt_proj"] + p["dt_bias"].to(xdbc.dtype))
    return dt, b, c


def mamba_forward(p, x: torch.Tensor, *, state: int = 16,
                  impl: str = "kernel") -> torch.Tensor:
    """Prefill: x ``(B, S, d)`` -> ``(B, S, d)``, one selective scan."""
    xz = x @ p["in_proj"]
    xc, z = xz.chunk(2, dim=-1)                     # (B, S, d_inner)
    xc = L.silu(_causal_conv(xc, p["conv_w"]))
    dt, b, c = _split_xdbc(p, xc, state)
    a = -torch.exp(p["a_log"])                      # (d_inner, N)
    y = ssm_ops.ssm_scan(xc, dt, b, c, a, p["d_skip"], impl=impl)
    y = y * L.silu(z)
    return y @ p["out_proj"]


def init_mamba_cache(batch: int, d_model: int, *, expand: int = 2,
                     state: int = 16, conv: int = 4, device,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    d_inner = expand * d_model
    return {"conv": torch.zeros((batch, conv - 1, d_inner), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, d_inner, state),
                               dtype=torch.float32, device=device)}


def mamba_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], *,
                 state: int = 16
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: x ``(B, d)`` -> ``(B, d)``.  The conv window is the
    cached tail followed by this token's pre-conv x; the new tail (that
    window without its first row, in the cache's dtype) and the new SSM
    state are written into ``cache`` in place, and ``cache`` is
    returned."""
    xz = x @ p["in_proj"]
    xc, z = xz.chunk(2, dim=-1)                     # (B, d_inner)
    # cat promotes the bf16 tail to x's dtype, as jnp.concatenate does
    window = torch.cat([cache["conv"], xc[:, None]], dim=1)
    w = p["conv_w"].float()                         # (K, d_inner)
    conv_out = (window.float() * w[None]).sum(dim=1)
    # SiLU, its last product kept in f32 for the scan's skip term (see
    # ssm_ops.single_step)
    xs = conv_out.to(x.dtype)
    x_f32 = xs.float() * L.sigmoid(xs).float()
    xc = x_f32.to(x.dtype)
    dt, b, c = _split_xdbc(p, xc, state)
    a = -torch.exp(p["a_log"])
    _, y = ssm_ops.single_step(cache["ssm"], xc, dt, b, c, a, p["d_skip"],
                               x_f32=x_f32)
    y = y * L.silu(z)
    cache["conv"].copy_(window[:, 1:])
    return y @ p["out_proj"], cache
