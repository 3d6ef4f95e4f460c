"""Shared layers: norms, RoPE, MLPs, embeddings (the port of
``repro.models.layers``).

Parameters keep the reference's layout -- a dense weight is ``(d_in,
d_out)`` and a layer computes ``x @ W`` -- and every function rounds
where the reference rounds: compute dtype follows the input, norm
statistics and RoPE run in f32, the unembedding accumulates in f32.
Initialisers draw from an explicit ``torch.Generator``; on the ``meta``
device they only allocate shapes (for parameter counts).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import shards


def _normal(shape, generator: Optional[torch.Generator], device,
            scale: float, dtype: torch.dtype) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(scale).to(dtype)


def dense_init(generator, d_in: int, d_out: int, *, device,
               dtype: torch.dtype = torch.bfloat16,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1/d_in) weight of shape ``(d_in, d_out)``, drawn in f32."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _normal((d_in, d_out), generator, device, scale, dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5, *,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """RMSNorm in f32, cast to ``dtype`` (x's by default) BEFORE the
    weight, as the reference does."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype or x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5, *,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dtype or x.dtype) * w + b


# --------------------------------------------------------------------- #
# rotary position embeddings
# --------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # the compiled reference folds this constant in f64, then rounds
    return (1.0 / (theta ** exps.double())).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate-half RoPE in f32.  ``x`` is ``(..., S, D)``; ``positions``
    broadcasts against ``x.shape[:-1]`` (``(S,)``, ``(..., S)``, or
    ``(B, 1, 1)`` for one decode token per row)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------- #
def swiglu_init(generator, d: int, d_ff: int, *, device,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    return {"w_gate": dense_init(generator, d, d_ff, device=device,
                                 dtype=dtype),
            "w_up": dense_init(generator, d, d_ff, device=device,
                               dtype=dtype),
            "w_down": dense_init(generator, d_ff, d, device=device,
                                 dtype=dtype)}


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA lowers it: ``1 / (1 + exp(-x))``, each
    op rounded to x's dtype.  (``torch.sigmoid`` rounds once, which in
    bf16 lands an ulp away from the reference on some inputs.)"""
    return 1 / (1 + torch.exp(-x))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``, ``-softplus(-x)``, in the form its
    compiled HLO computes: ``-(max(-x, 0) + log1p(exp(-|x|)))`` (a NaN
    passes through), in x's dtype (the xLSTM gates call it in f32)."""
    neg = -x
    sp = torch.clamp(neg, min=0) + torch.log1p(torch.exp(-torch.abs(neg)))
    return -torch.where(neg != neg, neg, sp)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` rounded op by op, like ``jax.nn.silu``."""
    return x * sigmoid(x)


def swiglu(x: torch.Tensor, p) -> torch.Tensor:
    h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return shards.row_parallel(h, p["w_down"])


def gelu_mlp_init(generator, d: int, d_ff: int, *, device,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    return {"w_in": dense_init(generator, d, d_ff, device=device,
                               dtype=dtype),
            "w_out": dense_init(generator, d_ff, d, device=device,
                                dtype=dtype)}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh approximation) as XLA lowers it:
    ``x * (0.5 * (1 + tanh(c * (x + k * x*x*x))))`` with the constants
    and every op rounded to x's dtype.  (``torch.nn.functional.gelu``
    rounds once, which in bf16 lands an ulp away on ~40% of inputs.)"""
    c, k = (torch.tensor(v, dtype=torch.float32, device=x.device).to(
        x.dtype) for v in (math.sqrt(2 / math.pi), 0.044715))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def gelu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    return shards.row_parallel(gelu(x @ p["w_in"]), p["w_out"])


# --------------------------------------------------------------------- #
# embeddings / unembedding
# --------------------------------------------------------------------- #
def embedding_init(generator, vocab: int, d: int, *, device,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return _normal((vocab, d), generator, device, 0.02, dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``.  ``F.embedding`` rather than
    ``table[tokens]``: the same gather forward, and a backward that sums a
    repeated token's gradients in a fixed order on CUDA.  A
    vocabulary-sharded table (a DTensor) takes :func:`shards.embed`."""
    if shards.is_dtensor(table) and any(p.is_shard(0)
                                        for p in table.placements):
        return shards.embed(tokens, table)
    return torch.nn.functional.embedding(tokens, table)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Tied unembedding, ``x @ table.T`` accumulated and returned in f32
    (a bf16 ``matmul`` would round the logits to bf16).  Placed, x's
    pending partial sums are summed and a table also split along d (FSDP)
    is gathered along d, so the logits come out split on the vocabulary
    (:func:`cross_entropy`) and the table is not gathered over it."""
    return (shards.reduced(x).float()
            @ shards.whole_dim(table, 1).float().t())


# --------------------------------------------------------------------- #
# scans over time
# --------------------------------------------------------------------- #
def _scan(step: Callable, carry, xs, start: int, stop: int):
    """``step`` over steps ``start:stop`` of ``xs``: the last carry and the
    ``y_t`` stacked (a tensor or a tuple, as ``step`` returns them)."""
    seq = xs if isinstance(xs, (tuple, list)) else (xs,)
    ys = []
    for t in range(start, stop):
        x_t = tuple(a[t] for a in seq)
        carry, y = step(carry, x_t if isinstance(xs, (tuple, list))
                        else x_t[0])
        ys.append(y)
    if isinstance(ys[0], (tuple, list)):
        return carry, tuple(torch.stack(c) for c in zip(*ys))
    return carry, torch.stack(ys)


def scan_once_on_meta(step: Callable, carry, xs):
    """A scan over the leading (time) axis of ``xs`` on ``meta`` inputs:
    ``step`` run once, on step 0, with its ``y`` expanded to the T steps
    (contiguous, as ``torch.stack`` gives it) and its carry standing for
    the last -- or None where ``xs`` holds values.

    On ``meta`` no value exists, so stepping T times computes nothing:
    the dry run (``launch.dryrun``) records shapes, placements, the
    autograd graph and the collectives only, and the reference's compiled
    dry run counts a loop body once (XLA sees a ``lax.scan`` body once).
    Every input stays in the graph: the backward reaches each leaf the
    stepped loop reaches, with the same shapes and placements.  There is
    nothing to recompute, so no chunk is checkpointed.  Keyed on the
    device alone (a DTensor reports its local shard's): every tensor
    that holds values is stepped."""
    seq = xs if isinstance(xs, (tuple, list)) else (xs,)
    if seq[0].device.type != "meta":
        return None
    t = seq[0].shape[0]
    x_0 = tuple(a[0] for a in seq)
    carry, y = step(carry, x_0 if isinstance(xs, (tuple, list))
                    else x_0[0])

    def stand(y_0):
        return y_0.unsqueeze(0).expand(t, *y_0.shape).contiguous()
    if isinstance(y, (tuple, list)):
        return carry, tuple(stand(c) for c in y)
    return carry, stand(y)


def chunked_remat_scan(step: Callable, carry, xs, chunk: int
                       ) -> Tuple[object, object]:
    """The reference's ``chunked_remat_scan``: ``step(carry, x_t) ->
    (carry, y_t)`` stepped over the leading (time) axis of ``xs`` (a
    tensor or a tuple of tensors), returning the last carry and the
    ``y_t`` stacked on a new leading axis (a tensor or a tuple, as
    ``step`` returns them) -- what ``lax.scan`` gives.

    Under autograd, when ``T % chunk == 0`` and ``T > chunk`` (the
    reference's rule), each chunk of ``chunk`` steps is checkpointed
    (``torch.utils.checkpoint``, non-reentrant): the backward keeps the
    carries at the chunk boundaries only and recomputes a chunk's steps,
    so memory is O((T/chunk + chunk) x state) instead of O(T x state).
    The forward is the same steps in the same order either way.  On
    ``meta`` inputs the step runs once (:func:`scan_once_on_meta`)."""
    once = scan_once_on_meta(step, carry, xs)
    if once is not None:
        return once
    seq = xs if isinstance(xs, (tuple, list)) else (xs,)
    t = seq[0].shape[0]
    if (not torch.is_grad_enabled() or chunk <= 1 or t % chunk
            or t <= chunk):
        return _scan(step, carry, xs, 0, t)
    parts = []
    for start in range(0, t, chunk):
        carry, ys = checkpoint(_scan, step, carry, xs, start, start + chunk,
                               use_reentrant=False)
        parts.append(ys)
    if isinstance(parts[0], tuple):
        return carry, tuple(torch.cat(c) for c in zip(*parts))
    return carry, torch.cat(parts)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """logits (..., V) f32, labels (...) int: the mean NLL.  Logits
    sharded on the vocabulary (a DTensor, from a vocabulary-sharded
    unembedding) take :func:`shards.cross_entropy`."""
    if shards.is_dtensor(logits) and any(
            p.is_shard(logits.dim() - 1) for p in logits.placements):
        return shards.cross_entropy(logits, labels)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long()).squeeze(-1)
    return (logz - gold).mean()
