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
  them there in the same order (:func:`_fold_f32`, computed on the device
  by :func:`fold_f32`), keeping the gradient of the slot's own scale.

On placed tokens (a DTensor ``x``, ``launch.sharding``) :func:`moe_forward`
runs the expert-parallel path (:func:`_moe_placed`): EP x TP as the
reference's rules place the experts -- E over ``data``, the expert ff dim
over ``model`` -- with routing on each rank's own tokens, positions and
capacity taken over ALL tokens (the reference's single-device meaning),
a fixed-size token all-to-all over ``data`` each way, the three expert
products on local weight shards and one all-reduce over ``model``.
Every collective is called explicitly, so
``analysis.collectives.CollectiveRecord`` sees it.  The reference's
``_maybe_shard`` hints have no counterpart: the placement is the code.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models import layers as L
from repro_torch.models import shards


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


def _route(router: torch.Tensor, x: torch.Tensor, dims: MoEDims,
           routes: Optional[torch.Tensor] = None):
    """The top-k choice of the tokens ``x`` (T, d) and its weights, the
    routing margin, and the (group-masked) router probabilities (T, E).
    ``routes`` (T, k), a check hook and not a feature, replays
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
    probs = torch.softmax(x.float() @ router, dim=-1)              # (T, E)
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
    return gate_idx, gate_vals, margin, probs


def route(p, x: torch.Tensor, dims: MoEDims,
          routes: Optional[torch.Tensor] = None):
    """(gate_idx, gate_vals, margin, aux) of the tokens ``x`` (T, d): see
    :func:`_route`; ``aux`` is the Switch load-balancing loss."""
    gate_idx, gate_vals, margin, probs = _route(p["router"], x, dims, routes)
    # Switch aux loss: E * sum_e (fraction_e * mean_prob_e)
    e = dims.n_experts
    fraction = _counts(gate_idx[:, 0], e).float() / x.shape[0]
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


#: the scale of a dropped pair: its payload is zeroed first, so the
#: reference's ``max(max|0|, 1e-6) / 127`` (compiled: ``* f32(1/127)``)
_DROPPED_SCALE = float(np.float32(1e-6) * np.float32(_INV_127))


def fold_rounds(n_max: int) -> int:
    """Rounds of :func:`fold_f32` that cover any ``n <= n_max``: one a
    binade the sum passes through.  Past the first add the sum is at
    least ``step``, each add moves it by at most ``2 step`` while it moves
    at all (an add that moves it is at least half an ulp), so it ends
    below ``max(first, step) (1 + 2 n)``: at most ``log2(1 + 2 n) + 1``
    binades, and one round more for the first add."""
    return (2 * n_max + 1).bit_length() + 2


def fold_f32(first: torch.Tensor, step: float, n: torch.Tensor,
             n_max: int) -> torch.Tensor:
    """:func:`_fold_f32` on the device: ``first + step + ... + step`` (``n``
    adds, ``0 <= n <= n_max``, a tensor) in f32 with every add rounded,
    elementwise over ``first`` (f32, >= 0; ``step`` > 0 an f32 value),
    with no read of the device -- so no host sync, and it runs on
    ``meta`` -- and bit for bit the left fold.

    Within one binade of f32 every add of ``step`` moves the sum by the
    same number of ulps, ``round(step / ulp)`` (at a tie, to the even sum:
    after two adds the sum is even and so is every move), so one round a
    binade makes two real f32 adds and then jumps, in f64 (exact: every
    value is an f32 sum), to the last sum below the binade's top; the next
    round's first add crosses it.  The rounds' binades and moves come from
    one pass over the round axis, and where ``n`` runs out from one cumsum
    of the adds each round took.  The rounds stay a chain (7 ops each):
    where a binade's last sum lies depends on its first sum modulo the
    move, and the next binade's first sum on that."""
    r = fold_rounds(n_max)
    s32 = torch.tensor(step, dtype=torch.float32, device=first.device)
    x = first.detach().float()
    # round i works in the i-th binade above that of the first add's sum
    _, ex = torch.frexp(x + s32)
    ex = ex + torch.arange(r, device=x.device).view((r,) + (1,) * x.dim())
    ulp = torch.ldexp(torch.ones_like(ex, dtype=torch.float64), ex - 24)
    move = torch.round(step / ulp) * ulp     # what an add moves the sum
    top = (2.0 ** 24 - 1) * ulp              # the binade's largest f32
    room = top - move
    mod = torch.where(move > 0, move, 2.0 ** 60 * ulp)
    firsts, seconds, lasts = [], [], []
    for i in range(r):
        a = x + s32
        b = a + s32
        # the binade's last sum on b's grid of moves (b itself
        # where the second add left the binade or adds move nothing)
        x = torch.maximum(b, top[i] - torch.remainder(room[i] - b,
                                                      mod[i])).float()
        firsts.append(a)
        seconds.append(b)
        lasts.append(x)
    # a round takes 2 adds and its jump's moves (none where the second add
    # left the binade or an add moves nothing)
    a1, a2, last = (torch.stack(v).double()
                    for v in (firsts, seconds, lasts))
    took = (last - a2) / torch.where(move > 0, move, 1.0) + 2
    done = torch.cumsum(took, 0)
    nf = n.to(device=x.device, dtype=torch.float64)
    j = (done < nf).sum(dim=0, keepdim=True).clamp_max(r - 1)

    def at(t):
        return t.gather(0, j.expand((1,) + t.shape[1:])).squeeze(0)
    m = torch.minimum(nf - at(done - took), at(took))   # adds in round j
    out = torch.where(m >= 2, at(a2) + (m - 2) * at(move), at(a1))
    return torch.where(nf > 0, out, first.detach().double()).float()


def _quantize(x: torch.Tensor):
    """Per-token symmetric int8: (q (T, d) int8, scale (T, 1) f32), the
    payload rounded half to even and clipped to +-127."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True),
                            1e-6) * _INV_127                       # (T, 1)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _fold_dropped(sbuf: torch.Tensor, c: int, n_drop: torch.Tensor,
                  n_max: int) -> torch.Tensor:
    """Slot ``(0, C-1)`` of the scale buffer plus ``n_drop`` dropped
    pairs' scales, in the reference's update order (the pair kept there,
    if any, then the dropped ones): the fold's value plus the slot's own
    term minus itself (exactly 0), so the value is the fold's, bit for
    bit, and the slot's real scale keeps its gradient, as under the
    reference's scatter-add."""
    kept = sbuf[c - 1].clone()
    sbuf[c - 1] = (fold_f32(kept.detach(), _DROPPED_SCALE, n_drop, n_max)
                   + (kept - kept.detach()))
    return sbuf


def may_drop(t: int, k: int, c: int, replayed: bool) -> bool:
    """Whether a call of ``t`` tokens can drop a pair at capacity ``c``:
    a token's own top-k experts are distinct, so an expert gets at most
    ``t`` pairs (a replayed choice, at most ``t k``).  Where none can
    drop, the int8 fold adds nothing and is skipped (a decode step's
    capacity is at least 8 tokens)."""
    return c < (t * k if replayed else t)


def _dispatch_int8(x, slot, keep, e, c, fold: bool = True):
    """The int8 dispatch buffer ``(E*C, d)``: per-token symmetric scale,
    payload rounded half to even and clipped to +-127, dequantised as
    ``bf16(q) * bf16(scale)`` in x's dtype -- as the reference's compiled
    program computes it, which in f32 keeps the product exact (XLA on the
    CPU drops the bf16 rounding between the product and its f32 convert;
    the eager reference rounds it).  Slot ``(0, C-1)``'s scale also sums the
    dropped pairs' scales (:func:`_fold_dropped`) unless ``fold`` is off
    (:func:`may_drop`)."""
    t, d = x.shape
    q, scale = _quantize(x)
    qbuf = torch.zeros((e * c + 1, d), dtype=torch.int8, device=x.device)
    sbuf = torch.zeros((e * c + 1, 1), dtype=torch.float32,
                       device=x.device)
    for j in range(slot.shape[1]):
        qbuf[slot[:, j]] = q
        sbuf[slot[:, j]] = scale
    if fold:
        sbuf = _fold_dropped(sbuf, c, (~keep).sum(), keep.numel())
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


def _positions(flat_e: torch.Tensor, e: int):
    """The pairs (token-major expert ids ``flat_e``) sorted stably by
    expert: (the order, the pairs an expert, where each expert's pairs
    start in that order, each pair's position within its expert)."""
    order = torch.argsort(flat_e, stable=True)
    counts = _counts(flat_e, e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat_e)
    pos[order] = (torch.arange(flat_e.shape[0], device=flat_e.device)
                  - starts[flat_e[order]])
    return order, counts, starts, pos


def _experts(buf: torch.Tensor, w_gate, w_up, w_down,
             groups=()) -> torch.Tensor:
    """The three batched expert products of ``buf`` (n, C, d) -> (n*C, d);
    ``groups``: those that split the ff dim (the down product summed over
    them, ``shards.row_parallel``)."""
    n, c, d = buf.shape
    g = torch.bmm(*_promoted(buf, w_gate))
    u = torch.bmm(*_promoted(buf, w_up))
    h, w_down = _promoted(L.silu(g) * u, w_down)
    return shards.row_parallel(h, w_down, groups).view(n * c, -1)


def _with_shared(p, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    if "shared" not in p:
        return out
    sh = p["shared"]
    dt = torch.promote_types(x.dtype, sh["w_gate"].dtype)
    return out + L.swiglu(x.to(dt), {n: sh[n].to(dt) for n in
                                     ("w_gate", "w_up", "w_down")})


def moe_forward(p, x: torch.Tensor, dims: MoEDims,
                routes: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Routing]:
    """x: (T, d) flat tokens -- every token of the call, since the
    capacity and the drops depend on all of them.  Returns (out (T, d),
    the call's :class:`Routing`).  ``routes``: see :func:`route`.  A
    placed ``x`` runs the expert-parallel path (:func:`_moe_placed`)."""
    if shards.is_dtensor(x):
        return _moe_placed(p, x, dims, routes)
    t, d = x.shape
    e, k = dims.n_experts, dims.top_k
    c = capacity(t, dims)
    gate_idx, gate_vals, margin, aux = route(p, x, dims, routes)

    # ---- sort-based dispatch ------------------------------------------
    pos = _positions(gate_idx.reshape(-1), e)[3].view(t, k)
    keep = pos < c
    slot = torch.where(keep, gate_idx * c + pos, e * c)   # e*c: scratch
    if dims.int8_dispatch:
        buf = _dispatch_int8(x, slot, keep, e, c,
                             may_drop(t, k, c, routes is not None))
    else:
        buf = x.new_zeros((e * c + 1, d))
        for j in range(k):
            buf[slot[:, j]] = x
        buf = buf[:e * c]

    # ---- expert compute ----------------------------------------------
    y = _experts(buf.view(e, c, d), p["w_gate"], p["w_up"], p["w_down"])
    out = _combine(y, gate_idx, slot, gate_vals).to(x.dtype)
    return (_with_shared(p, x, out),
            Routing(gate_idx, gate_vals, keep, pos, margin, aux))


def _gather_before(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the mesh dims ``axes`` that come
    before this one in their pod-major order (one all-gather an axis)."""
    g, idx, stride = t[None], 0, 1
    for i in reversed(axes):            # the innermost axis first
        n = mesh.size(i)
        if n > 1:
            g = shards.gather0(g, mesh.get_group(i))
        idx += mesh.get_local_rank(i) * stride
        stride *= n
    return g[:idx].sum(dim=0)


def _groups(mesh, axes):
    return [mesh.get_group(i) for i in axes if mesh.size(i) > 1]


def _moe_placed(p, x: DTensor, dims: MoEDims,
                routes: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Routing]:
    """The expert-parallel MoE layer on placed tokens ``x`` (T, d), equal
    in routes, kept pairs and positions to :func:`moe_forward` on all T
    tokens, on local shards:

    * **tokens**: x's batch split (pod-major), cut over ``data`` as well
      where data ranks held them alike (a local slice; the output is
      gathered back); ``model`` ranks hold them alike;
    * **route** this rank's tokens with the replicated router; the aux
      loss takes the fraction and the mean probability over all tokens
      (an all-reduce of (E,) counts and of (E,) probability sums);
    * **positions and capacity are global**: ``C = capacity(T)``, and a
      pair's position within its expert counts the pairs for that expert
      of every token shard before this one (an all-gather of each shard's
      (E,) counts) -- per-rank positions would keep pairs the reference
      drops;
    * **dispatch**: each kept pair's row goes to the ``data`` rank of its
      expert (E over data, replicated over pod: each pod's expert ranks
      take their own pod's rows) in one equal-split all-to-all, ``S =
      min(T_local k, E_local C)`` rows for every (source, destination)
      pair -- the most one source can send one destination, so no size
      reads a value -- with each row's slot in the destination's (E_local,
      C) table (int8 dispatch sends the payload as int8 and its f32
      scale; the rank of expert 0 folds the GLOBAL count of dropped pairs'
      scales into slot (0, C-1), :func:`fold_f32`);
    * **experts**: ``w_gate`` / ``w_up`` column shards and ``w_down`` row
      shards over ``model`` as placed, then one all-reduce over ``model``
      of the down product's f32 partial sums (``shards.row_parallel``);
      expert weights are never gathered;
    * **combine**: the reverse all-to-all sends each row back, and
      :func:`_combine` adds a token's k terms in ascending expert id.

    ``routes`` (T, k) -- all tokens' -- replays a choice (:func:`route`).
    Returns the output split over the batch as ``x`` is and a
    :class:`Routing` whose per-token fields are DTensors over the token
    split (``aux`` a plain scalar, the same on every rank)."""
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    if "data" not in names:
        raise ValueError("moe: the expert-parallel path needs a 'data' "
                         "mesh axis")
    t, d = x.shape
    e, k = dims.n_experts, dims.top_k
    c = capacity(t, dims)
    dax = names.index("data")
    n_data = mesh.size(dax)
    if e % n_data:
        raise ValueError(f"moe: {e} experts do not split over |data| "
                         f"{n_data}")
    e_loc = e // n_data
    # a pending partial sum (a row-parallel output) summed first
    x = shards.reduced(x)
    out_pl = [pl if pl.is_shard(0) else Replicate() for pl in x.placements]
    if list(x.placements) != out_pl:
        x = x.redistribute(mesh, out_pl)
    tok_pl = [Shard(0) if n == "data" or (pl.is_shard(0) and n != "model")
              else Replicate() for n, pl in zip(names, x.placements)]
    xs = x if list(x.placements) == tok_pl else x.redistribute(mesh, tok_pl)
    axes = [i for i, pl in enumerate(tok_pl) if pl.is_shard()]
    x_loc = xs.to_local(grad_placements=tok_pl)
    t_loc = x_loc.shape[0]
    start = shards._offset(xs)[1][0]
    t_max = t
    for i in axes:              # the largest shard (torch.chunk's split)
        t_max = -(-t_max // mesh.size(i))
    dev = x_loc.device

    # ---- route this rank's tokens --------------------------------------
    router = shards.local_weight(p["router"], mesh,
                                 [Replicate()] * mesh.ndim, axes)
    if routes is not None:
        routes = shards.whole(routes)[start:start + t_loc].to(dev)
    gate_idx, gate_vals, margin, probs = _route(router, x_loc, dims, routes)
    tok_groups = _groups(mesh, axes)
    top1 = shards._sum(_counts(gate_idx[:, 0], e), tok_groups)
    mean = shards.summed(probs.sum(dim=0), tok_groups) / t
    aux = e * torch.sum(top1.float() / t * mean)

    # ---- global positions ----------------------------------------------
    flat_e = gate_idx.reshape(-1)
    order, counts, starts, pos = _positions(flat_e, e)
    pos = (pos + _gather_before(counts, mesh, axes)[flat_e]).view(t_loc, k)
    keep = pos < c

    # ---- dispatch: each kept pair's row to its expert's data rank -----
    s_rows = min(t_max * k, e_loc * c)
    n_send = n_data * s_rows
    kept = keep.reshape(-1)[order].long()               # in sorted order
    before = torch.cumsum(kept, 0) - kept
    first = torch.cat([before, kept.sum().view(1)])[starts[::e_loc]]
    dest = flat_e[order] // e_loc
    row = torch.empty_like(flat_e)
    row[order] = torch.where(kept.bool(),
                             dest * s_rows + before - first[dest], n_send)
    row = row.view(t_loc, k)                 # n_send: dropped (scratch)
    slot = (gate_idx % e_loc) * c + pos      # in the destination's table
    send_slot = torch.full((n_send + 1,), e_loc * c, dtype=torch.int64,
                           device=dev)
    for j in range(k):
        send_slot[row[:, j]] = slot[:, j]
    group = mesh.get_group(dax) if n_data > 1 else None
    recv_slot = shards.all_to_all(send_slot[:n_send], group)

    def exchange(rows: torch.Tensor, width: int) -> torch.Tensor:
        """``rows`` (one a token) sent to the pairs' destinations and
        placed in this rank's (E_local*C + 1, width) table."""
        send = rows.new_zeros((n_send + 1, width))
        for j in range(k):
            send[row[:, j]] = rows
        table = rows.new_zeros((e_loc * c + 1, width))
        table[recv_slot] = shards.all_to_all(send[:n_send], group)
        return table

    if dims.int8_dispatch:
        q, scale = _quantize(x_loc)
        qbuf, sbuf = exchange(q, d), exchange(scale, 1)
        if may_drop(t, k, c, routes is not None):
            n_drop = shards._sum((~keep).sum(), tok_groups)
            if mesh.get_local_rank(dax) == 0:        # holds expert 0
                sbuf = _fold_dropped(sbuf, c, n_drop, t * k)
        buf = _Dequant.apply(qbuf[:e_loc * c], sbuf[:e_loc * c], x.dtype)
    else:
        buf = exchange(x_loc, d)[:e_loc * c]

    # ---- the experts on this rank's shards, summed over model ----------
    m_axes = [names.index("model")] if "model" in names else []
    m_groups = _groups(mesh, m_axes)

    def expert_pl(ff: int):
        return [Shard(0) if i == dax else Shard(ff) if i in m_axes
                else Replicate() for i in range(mesh.ndim)]
    w_gate, w_up = (shards.local_weight(p[n], mesh, expert_pl(2), axes)
                    for n in ("w_gate", "w_up"))
    w_down = shards.local_weight(p["w_down"], mesh, expert_pl(1), axes)
    y = _experts(shards.grad_summed(buf.view(e_loc, c, d), m_groups),
                 w_gate, w_up, w_down, m_groups)

    # ---- combine: the rows back to their tokens -------------------------
    back = shards.all_to_all(
        torch.cat([y, y.new_zeros((1, y.shape[1]))])[recv_slot], group)
    out_loc = _combine(back, gate_idx, row, gate_vals).to(x.dtype)

    def placed(v: torch.Tensor) -> DTensor:
        shape = torch.Size((t,) + tuple(v.shape[1:]))
        return DTensor.from_local(v, mesh, tok_pl, run_check=False,
                                  shape=shape, stride=torch.empty(
                                      shape, device="meta").stride())
    out = placed(out_loc)
    if tok_pl != out_pl:
        out = out.redistribute(mesh, out_pl)
    return (_with_shared(p, x, out),
            Routing(placed(gate_idx), placed(gate_vals), placed(keep),
                    placed(pos), placed(margin), aux))


def moe_apply(p, x: torch.Tensor, dims: MoEDims,
              routes: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) flat tokens. Returns (out (T, d), aux_loss scalar), as
    the reference's ``moe_apply``.  ``routes``: see :func:`route`."""
    out, r = moe_forward(p, x, dims, routes)
    return out, r.aux
