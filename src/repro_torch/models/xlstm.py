"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory), the port
of ``repro.models.xlstm``.

Stabilised exponential gating keeps the gates in log space with a
stabiliser m (see the scans' plain versions for the recurrences).
Prefill runs each recurrence over the whole prompt as one scan -- the
``mlstm_scan`` and ``slstm_scan`` kernels on CUDA tensors with
``impl="kernel"``, their plain versions on CPU tensors or with
``impl="ref"`` -- and, as the reference's prefill does, returns only the
per-step outputs.  Decode is one step in plain torch, as in the
reference, and writes the new state into the cache IN PLACE (the
reference returns new arrays).

Rounding follows the reference's compiled program:

* the key scale: ``k = heads(xg @ wk) / sqrt(P)`` divides by √P rounded
  to the activation dtype, and XLA turns the divide into a multiply by
  its f32 reciprocal (``1 / 5.65625`` = 0.17679559 at P 32 in bf16),
  rounded back to the activation dtype in prefill and left in f32 in
  decode (:func:`mlstm_decode`);
* the gates ``xg @ w_if`` are rounded to the activation dtype, then
  taken in f32, in prefill, and are the product's f32 sums in decode;
  ``log_f = log_sigmoid(f)`` in f32;
* the mLSTM output ``h = num / den`` is rounded to the activation dtype
  every step; the sLSTM carry ``h`` is kept in it;
* the sLSTM step adds ``x_t @ w_in`` and the recurrent product each
  rounded to the activation dtype, in f32 (:func:`slstm_step`).

The sLSTM's recurrent product ``(B, H, 4 ph)`` is read as ``(B, 4d)``
and split into z, i, f, o: with H = 4 (4 ph = d) each gate takes its
recurrent term from one head's ``h_prev`` -- the reference's layout,
copied as it is.

On placed tensors (``launch.sharding``: the batch over the data axes) each
scan runs on each rank's batch shard (``shards.on_batch_shards``), so its
steps are local ops and its loop makes no collective; the kernels take
no DTensor, so placed, the scans run their plain versions.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
from repro_torch.kernels.mlstm_scan.ref import M0, mlstm_step
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.slstm_scan.ref import slstm_step
from repro_torch.models import layers as L
from repro_torch.models import shards


def _refuse_placed(kernel: str, x: torch.Tensor, impl: str) -> None:
    """The kernels take no DTensor: a placed CUDA x with ``impl="kernel"``
    raises here, before the scan's region would hand the kernel local
    shards (placed paths run the plain versions)."""
    if shards.is_dtensor(x) and impl == "kernel" and x.is_cuda:
        _build.refuse_dtensor(kernel, x)


# --------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------- #
def mlstm_init(generator, d_model: int, n_heads: int, *, expand: int = 2,
               device, dtype: torch.dtype = torch.bfloat16
               ) -> Dict[str, torch.Tensor]:
    d_inner = expand * d_model

    def dense(d_in, d_out, scale=None):
        return L.dense_init(generator, d_in, d_out, device=device,
                            dtype=dtype, scale=scale)
    return {
        "up": dense(d_model, 2 * d_inner),
        "wq": dense(d_inner, d_inner),
        "wk": dense(d_inner, d_inner),
        "wv": dense(d_inner, d_inner),
        "w_if": dense(d_inner, 2 * n_heads, scale=0.02),
        "down": dense(d_inner, d_model),
        "out_norm": torch.ones(d_inner, dtype=dtype, device=device),
    }


def _key_scale(ph: int, dtype: torch.dtype) -> float:
    """The f32 reciprocal of √P rounded to ``dtype`` (see the module
    docstring)."""
    root = torch.tensor(math.sqrt(ph), dtype=torch.float32).to(dtype)
    return float(torch.tensor(1.0, dtype=torch.float32) / root.float())


def _mlstm_qkv(p, xg: torch.Tensor, n_heads: int, *,
               decode: bool = False):
    """xg ``(..., d_inner)`` -> q, k, v ``(..., H, P)`` + log gates
    ``(..., H)`` f32.  With ``decode`` the scaled key and the gates stay
    in f32 (see :func:`mlstm_decode`)."""
    ph = xg.shape[-1] // n_heads

    def heads(y):
        return y.reshape(*y.shape[:-1], n_heads, ph)
    q = heads(xg @ p["wq"])
    k = heads((xg @ p["wk"]).float() * _key_scale(ph, xg.dtype))
    v = heads(xg @ p["wv"])
    if decode:
        gates = xg.float() @ p["w_if"].float()
    else:
        k = k.to(xg.dtype)
        gates = (xg @ p["w_if"]).float()
    log_i, f_pre = gates.split(n_heads, dim=-1)
    return q, k, v, log_i, L.log_sigmoid(f_pre)


def _mlstm_out(p, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(h, p["out_norm"])
    return (h * L.silu(z)) @ p["down"]


def mlstm_forward(p, x: torch.Tensor, n_heads: int, *,
                  impl: str = "kernel") -> torch.Tensor:
    """Prefill: x ``(B, S, d)`` -> ``(B, S, d)``, one mLSTM scan."""
    b, s, _ = x.shape
    _refuse_placed("mlstm_scan", x, impl)
    xg, z = (x @ p["up"]).chunk(2, dim=-1)          # (B, S, d_inner)
    q, k, v, log_i, log_f = _mlstm_qkv(p, xg, n_heads)
    h = shards.on_batch_shards(
        lambda *a: mlstm_ops.mlstm_scan(*a, impl=impl),
        (q, k, v, log_i, log_f))
    return _mlstm_out(p, h.reshape(b, s, -1), z)


def init_mlstm_cache(batch: int, d_model: int, n_heads: int, *,
                     expand: int = 2, device) -> Dict[str, torch.Tensor]:
    ph = expand * d_model // n_heads
    return {
        "c": torch.zeros((batch, n_heads, ph, ph), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, n_heads, ph), dtype=torch.float32,
                         device=device),
        "m": torch.full((batch, n_heads), M0, dtype=torch.float32,
                        device=device),
    }


def mlstm_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 n_heads: int
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: x ``(B, d)`` -> ``(B, d)``; the state is written into
    ``cache`` in place, and ``cache`` is returned.

    The reference's compiled decode step keeps the scaled key and the
    gates in f32: each rounding to the activation dtype there is followed
    at once by an f32 convert, and XLA drops the pair -- the key is
    ``f32(round(xg @ wk)) * scale`` and the gates the f32 sums of ``xg @
    w_if`` (the prefill, whose scan inputs are stored, keeps both
    roundings)."""
    xg, z = (x @ p["up"]).chunk(2, dim=-1)
    q, k, v, log_i, log_f = _mlstm_qkv(p, xg, n_heads, decode=True)
    (c, n, m), h = mlstm_step((cache["c"], cache["n"], cache["m"]), q, k,
                              v, log_i, log_f, out_dtype=x.dtype)
    for name, new in (("c", c), ("n", n), ("m", m)):
        cache[name].copy_(new)
    return _mlstm_out(p, h.reshape(x.shape[0], -1), z), cache


# --------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------- #
def slstm_init(generator, d_model: int, n_heads: int, *, device,
               dtype: torch.dtype = torch.bfloat16
               ) -> Dict[str, torch.Tensor]:
    ph = d_model // n_heads
    w_in = L.dense_init(generator, d_model, 4 * d_model, device=device,
                        dtype=dtype)
    # the reference draws N(0, 1) in f32 and divides by sqrt(ph)
    rec = L._normal((n_heads, ph, 4 * ph), generator, device,
                    1.0 / math.sqrt(ph), dtype)
    out = L.dense_init(generator, d_model, d_model, device=device,
                       dtype=dtype)
    return {"w_in": w_in, "r_rec": rec, "out": out}


def slstm_forward(p, x: torch.Tensor, n_heads: int, *,
                  impl: str = "kernel") -> torch.Tensor:
    """Prefill: x ``(B, S, d)`` -> ``(B, S, d)``: the input projection for
    every step in one product, then one sLSTM scan."""
    if p["r_rec"].shape[0] != n_heads:
        raise ValueError(f"r_rec has {p['r_rec'].shape[0]} heads, not "
                         f"{n_heads}")
    _refuse_placed("slstm_scan", x, impl)
    hs = shards.on_batch_shards(
        lambda pre_x, r_rec: slstm_ops.slstm_scan(pre_x, r_rec, impl=impl),
        (x @ p["w_in"],), (p["r_rec"],))
    return hs @ p["out"]


def init_slstm_cache(batch: int, d_model: int, n_heads: int, *,
                     device) -> Dict[str, torch.Tensor]:
    return {
        "c": torch.zeros((batch, d_model), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, d_model), dtype=torch.float32,
                         device=device),
        "m": torch.full((batch, n_heads), M0, dtype=torch.float32,
                        device=device),
        "h": torch.zeros((batch, d_model), dtype=torch.bfloat16,
                         device=device),
    }


def slstm_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 n_heads: int
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: x ``(B, d)`` -> ``(B, d)``; the state is written into
    ``cache`` in place (``h`` in the cache's dtype, bf16 from
    :func:`init_slstm_cache`), and ``cache`` is returned."""
    c, n, m, h = slstm_step(x @ p["w_in"], p["r_rec"],
                            (cache["c"], cache["n"], cache["m"],
                             cache["h"]), n_heads)
    for name, new in (("c", c), ("n", n), ("m", m), ("h", h)):
        cache[name].copy_(new)
    return h @ p["out"], cache
