"""Mixture-of-Experts layer: top-k routing, sort-based capacity dispatch
(the port of ``repro.models.moe``).

Expert weights are stacked ``(E, d, f)``.  Dispatch follows the
reference step for step: flatten the (token, expert-choice) pairs, sort
them stably by expert, give each pair its position within its expert
from the counts, drop the pairs past the capacity ``C``, run the three
batched expert products over an ``(E, C, d)`` buffer, and combine the
kept rows back with their routing weights.  Also returns the
Switch-style load-balancing loss.

Where the reference's result depends on an order or a rounding, the port
fixes it to the reference's:

* top-k is a stable descending sort, so ties go to the lower index as in
  ``jax.lax.top_k`` (``torch.topk`` does not fix the order of ties);
* kept (expert, slot) pairs are unique, so an indexed store of the kept
  rows equals the reference's scatter-add; dropped pairs go to a scratch
  row that is thrown away;
* the combine adds each token's k contributions in ascending expert id
  (the order XLA applies the sorted updates), one rounded add at a time,
  where CUDA's ``index_add_`` would add in any order;
* with int8 dispatch, the reference masks the dropped pairs' payload but
  not their scales, which all land in slot ``(0, C-1)``: the port adds
  them there in the same order (:func:`_fold_f32`), keeping the gradient
  of the slot's own scale.

``_maybe_shard`` (the reference's sharding hints) is not ported: one
card, no mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    # device-limited routing (DeepSeek-V2): tokens may route into at most
    # ``route_limit`` of ``route_groups`` expert groups
    route_groups: int = 0
    route_limit: int = 0
    # quantize the dispatch payload to int8 (per-token scale)
    int8_dispatch: bool = False


def moe_init(generator, dims: MoEDims, *, device,
             dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The reference's distributions: an f32 router N(0, 0.02^2), expert
    stacks N(0, 1/d_in) drawn in f32, a shared SwiGLU of width ``d_ff *
    n_shared``.  The draws are not the reference's (see
    ``transformer.init_params``)."""
    e, d, f = dims.n_experts, dims.d_model, dims.d_ff

    def expert_stack(d_in, d_out):
        return L._normal((e, d_in, d_out), generator, device,
                         1.0 / math.sqrt(d_in), dtype)

    p = {"router": L.dense_init(generator, d, e, device=device,
                                dtype=torch.float32, scale=0.02),
         "w_gate": expert_stack(d, f),
         "w_up": expert_stack(d, f),
         "w_down": expert_stack(f, d)}
    if dims.n_shared:
        p["shared"] = L.swiglu_init(generator, d, f * dims.n_shared,
                                    device=device, dtype=dtype)
    return p


def capacity(n_tokens: int, dims: MoEDims) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens: rounded up to a
    multiple of 8, at least 8."""
    per = n_tokens * dims.top_k * dims.capacity_factor / dims.n_experts
    return max(8, int(-(-per // 8) * 8))


class Routing(NamedTuple):
    """Where one call sent its tokens (token-major: pair ``(t, j)`` is
    token ``t``'s ``j``-th choice)."""
    gate_idx: torch.Tensor   # (T, k) int64 expert ids, most probable first
    gate_vals: torch.Tensor  # (T, k) routing weights, summing to 1
    keep: torch.Tensor       # (T, k) bool: the pair got a slot
    pos: torch.Tensor        # (T, k) int64 position within its expert
    margin: torch.Tensor     # (T,) f32: the smallest gap a flip must cross
    aux: torch.Tensor        # () f32 load-balancing loss


def _top_k(v: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Values and indices of the ``k`` largest along the last axis, ties
    to the lower index (``jax.lax.top_k``), and the gap between the k-th
    and the (k+1)-th value (inf when there is none)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    gap = (vals[..., k - 1] - vals[..., k] if k < v.shape[-1]
           else torch.full(v.shape[:-1], math.inf, device=v.device))
    return vals[..., :k], idx[..., :k], gap


def route(p, x: torch.Tensor, dims: MoEDims,
          routes: Optional[torch.Tensor] = None):
    """Router probabilities, the top-k choice and its weights, and the
    aux loss.  ``routes`` (T, k), a check hook and not a feature, replays
    a recorded choice: the weights are then this call's probabilities at
    those indices, as ``top_k`` would give them -- taken before the
    device-limited group mask, since the groups are part of the recorded
    choice (this call's mask could zero a replayed expert's weight)."""
    t = x.shape[0]
    e, k = dims.n_experts, dims.top_k
    # the router must see f32 products: TF32 keeps 10 mantissa bits, so
    # it would move the logits by ~1e-3 and flip any near-tied choice
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "moe: torch.backends.cuda.matmul.allow_tf32 is on; the router "
            "needs f32 products (TF32 flips near-tied expert choices)")
    probs = torch.softmax(x.float() @ p["router"], dim=-1)         # (T, E)
    unmasked = probs
    margin = torch.full((t,), math.inf, device=x.device)
    if dims.route_groups > 1 and 0 < dims.route_limit < dims.route_groups:
        g = dims.route_groups
        per = e // g
        score = probs.view(t, g, per).amax(dim=-1)                 # (T, G)
        _, top_g, margin = _top_k(score, dims.route_limit)
        gmask = torch.zeros((t, g), dtype=torch.bool, device=x.device)
        gmask.scatter_(1, top_g, True)
        probs = torch.where(gmask.repeat_interleave(per, dim=1), probs,
                            0.0)
    gate_vals, gate_idx, gap = _top_k(probs, k)
    margin = torch.minimum(margin, gap)
    if routes is not None:
        gate_idx = routes
        gate_vals = unmasked.gather(1, routes)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    # Switch aux loss: E * sum_e (fraction_e * mean_prob_e)
    fraction = _counts(gate_idx[:, 0], e).float() / t
    aux = e * torch.sum(fraction * probs.mean(dim=0))
    return gate_idx, gate_vals, margin, aux


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(ids, minlength=n)`` for ids below ``n``, without the
    host sync ``torch.bincount`` makes on CUDA to size its output (an
    integer scatter-add, exact in any order)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _fold_f32(first: float, step: float, n: int) -> float:
    """``first + step + ... + step`` (``n`` steps), each add rounded to
    f32 in turn, as XLA applies ``n`` scatter-add updates to one slot
    (``np.cumsum`` on float32 is that left fold)."""
    seq = np.full(n + 1, step, dtype=np.float32)
    seq[0] = first
    return float(np.cumsum(seq, dtype=np.float32)[-1])


#: f32(1/127): compiled, the reference's ``max / 127.0`` is a multiply by
#: it (XLA rewrites a division by a constant)
_INV_127 = float(torch.tensor(1 / 127.0, dtype=torch.float32))


def _dispatch_int8(x, slot, keep, e, c):
    """The int8 dispatch buffer ``(E*C, d)``: per-token symmetric scale,
    payload rounded half to even and clipped to +-127, dequantised as
    ``bf16(q) * bf16(scale)`` in x's dtype -- as the reference's compiled
    program computes it, which in f32 keeps the product exact (XLA on the
    CPU drops the bf16 rounding between the product and its f32 convert;
    the eager reference rounds it).  Slot ``(0, C-1)``'s scale also sums the
    dropped pairs' scales (their payload is zeroed first, so each is
    ``1e-6 / 127``), in the reference's update order: the pair kept
    there, if any, then the dropped ones."""
    t, d = x.shape
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True),
                            1e-6) * _INV_127                       # (T, 1)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    qbuf = torch.zeros((e * c + 1, d), dtype=torch.int8, device=x.device)
    sbuf = torch.zeros((e * c + 1, 1), dtype=torch.float32,
                       device=x.device)
    for j in range(slot.shape[1]):
        qbuf[slot[:, j]] = q
        sbuf[slot[:, j]] = scale
    n_drop = int((~keep).sum())
    if n_drop:
        dropped = torch.clamp_min(torch.zeros((), device=x.device),
                                  1e-6) * _INV_127
        kept = sbuf[c - 1].clone()
        # the fold's value plus the slot's own term minus itself (exactly
        # 0): the value is the fold's, bit for bit, and the slot's real
        # scale keeps its gradient, as under the reference's scatter-add
        sbuf[c - 1] = (_fold_f32(float(kept.detach()), float(dropped), n_drop)
                       + (kept - kept.detach()))
    return _Dequant.apply(qbuf[:e * c], sbuf[:e * c], x.dtype)


def _sum_bf16(p: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis of bf16 ``p`` (R, n) -> (R, 1) as XLA on
    the CPU reduces a bf16 array: windows of 32 (the padding split low /
    high, the larger half high), each a left fold rounded to bf16 at
    every add, then the windows' sums the same way until one is left."""
    while p.shape[-1] > 1:
        n = p.shape[-1]
        w = min(32, n)
        pad = -n % w
        p = F.pad(p, (pad // 2, pad - pad // 2)).reshape(p.shape[0], -1, w)
        acc = p[..., 0]
        for j in range(1, w):
            acc = acc + p[..., j]
        p = acc
    return p


class _Dequant(torch.autograd.Function):
    """``bf16(q) * bf16(scale)`` in ``dtype`` for ``q`` (R, d) int8 and
    ``scale`` (R, 1) f32.  The scale's gradient is the reference's compiled
    one: its transpose rounds the cotangent and each product to bf16 and
    sums them over d in bf16 (:func:`_sum_bf16`); autograd's would sum in
    f32 and round once, which is off by ~1e-2 of the scale's gradient."""

    @staticmethod
    def forward(ctx, q, scale, dtype):
        qb = q.to(torch.bfloat16)
        ctx.save_for_backward(qb)
        return qb.to(dtype) * scale.to(torch.bfloat16).to(dtype)

    @staticmethod
    def backward(ctx, g):
        qb, = ctx.saved_tensors
        return None, _sum_bf16(qb * g.to(torch.bfloat16)).float(), None


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` in the dtype ``jnp`` promotes them to (``torch.bmm``
    and ``@`` refuse mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _combine(y: torch.Tensor, gate_idx: torch.Tensor, slot: torch.Tensor,
             gate_vals: torch.Tensor) -> torch.Tensor:
    """out[t] = sum_j y[slot[t, j]] * w[t, j] in y's dtype, each product
    and each add rounded, the k terms added in ascending expert id: the
    order in which XLA applies the reference's scatter-add updates
    (sorted by expert).  A slot past ``y``'s rows (a dropped pair's)
    reads row 0 with weight 0, and so adds nothing."""
    _, by_expert = torch.sort(gate_idx, dim=1)
    rows = slot.gather(1, by_expert)
    kept = rows < y.shape[0]
    rows = torch.where(kept, rows, 0)
    w = torch.where(kept, gate_vals.gather(1, by_expert), 0).to(y.dtype)
    out = torch.zeros((slot.shape[0], y.shape[1]), dtype=y.dtype,
                      device=y.device)
    for j in range(slot.shape[1]):
        out = out + y[rows[:, j]] * w[:, j, None]
    return out


def moe_forward(p, x: torch.Tensor, dims: MoEDims,
                routes: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Routing]:
    """x: (T, d) flat tokens -- every token of the call, since the
    capacity and the drops depend on all of them.  Returns (out (T, d),
    the call's :class:`Routing`).  ``routes``: see :func:`route`."""
    t, d = x.shape
    e, k = dims.n_experts, dims.top_k
    c = capacity(t, dims)
    gate_idx, gate_vals, margin, aux = route(p, x, dims, routes)

    # ---- sort-based dispatch ------------------------------------------
    flat_e = gate_idx.reshape(-1)                                  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    counts = _counts(flat_e, e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat_e)
    pos[order] = (torch.arange(t * k, device=x.device)
                  - starts[flat_e[order]])
    pos = pos.view(t, k)
    keep = pos < c
    slot = torch.where(keep, gate_idx * c + pos, e * c)   # e*c: scratch
    if dims.int8_dispatch:
        buf = _dispatch_int8(x, slot, keep, e, c)
    else:
        buf = x.new_zeros((e * c + 1, d))
        for j in range(k):
            buf[slot[:, j]] = x
        buf = buf[:e * c]

    # ---- expert compute ----------------------------------------------
    buf = buf.view(e, c, d)
    g = torch.bmm(*_promoted(buf, p["w_gate"]))
    u = torch.bmm(*_promoted(buf, p["w_up"]))
    h, w_down = _promoted(L.silu(g) * u, p["w_down"])
    y = torch.bmm(h, w_down).view(e * c, d)

    out = _combine(y, gate_idx, slot, gate_vals).to(x.dtype)
    if "shared" in p:
        sh = p["shared"]
        dt = torch.promote_types(x.dtype, sh["w_gate"].dtype)
        out = out + L.swiglu(x.to(dt), {n: sh[n].to(dt) for n in
                                        ("w_gate", "w_up", "w_down")})
    return out, Routing(gate_idx, gate_vals, keep, pos, margin, aux)


def moe_apply(p, x: torch.Tensor, dims: MoEDims,
              routes: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) flat tokens. Returns (out (T, d), aux_loss scalar), as
    the reference's ``moe_apply``.  ``routes``: see :func:`route`."""
    out, r = moe_forward(p, x, dims, routes)
    return out, r.aux
