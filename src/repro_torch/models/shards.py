"""The model's ops on placed tensors (DTensors, ``launch.sharding``) where
DTensor's own sharding rules do not fit: each is written on this rank's
local shards, and every collective it needs is called explicitly (so
``analysis.collectives.CollectiveRecord`` sees it).

* :func:`is_dtensor` / :func:`whole` / :func:`local`: the one test for a
  placed tensor, its gathered whole, and this rank's shard under given
  placements (a plain tensor counts as replicated, as under
  ``implicit_replication``);
* :func:`write_rows` / :func:`write_prefix`: the in-place cache writes
  (a decode step's append, prefill's rows from position 0) on each
  rank's shard -- DTensor would slice a sequence-sharded dim into a
  gathered copy and write there;
* :func:`heads`: a projection's columns as heads, gathered where its
  shards would cut a head;
* :func:`on_shards`: attention that is local along its split dims (batch
  and heads), run on each rank's shards under ``local_map``;
* :func:`on_batch_shards`: a recurrence over time, local along the
  batch, run on each rank's batch shard under ``local_map``;
* :func:`embed` / :func:`cross_entropy`: the vocabulary-parallel lookup
  and NLL;
* :func:`summed` / :func:`grad_summed` / :func:`all_to_all`: the
  collectives of a hand-written placed op (``models/moe`` uses them)
  with their gradients: a sum over ranks whose backward passes the
  gradient through, its mirror (the identity forward, the sum backward),
  and an equal-split all-to-all whose backward is the reverse one;
* :func:`local_weight`: this rank's block of a weight, its gradient
  summed over the mesh axes whose ranks use it on tokens of their own.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed import _functional_collectives as fc
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from torch.distributed.tensor.experimental import local_map


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A placed tensor gathered whole (a collective: every rank calls it,
    in the same order); a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _placed(t: torch.Tensor, mesh) -> DTensor:
    """``t`` as a DTensor on ``mesh``: a plain ``t`` (the same on every
    rank) replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``t`` under ``placements`` (a plain ``t`` is
    cut locally)."""
    return _placed(t, mesh).redistribute(mesh, placements).to_local()


def reduced(t: torch.Tensor) -> torch.Tensor:
    """A placed ``t`` with its partial sums summed (DTensor keeps a
    row-parallel product's sum pending through linear ops); any other
    ``t`` as it is."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        t = t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return t


def whole_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with dim ``dim`` whole on every rank (an all-gather over the
    mesh axes that split it, as FSDP gathers a weight at use); a plain
    ``t``, or one not split there, as it is."""
    if isinstance(t, DTensor) and any(p.is_shard(dim)
                                      for p in t.placements):
        t = t.redistribute(t.device_mesh, [
            Replicate() if p.is_shard(dim) else p for p in t.placements])
    return t


def _offset(c: DTensor):
    """(local shape, global offset) of this rank's shard of ``c``."""
    return compute_local_shape_and_global_offset(c.shape, c.device_mesh,
                                                 c.placements)


def write_rows(c: DTensor, new: torch.Tensor, pos: torch.Tensor,
               write: Callable) -> None:
    """``write(c, new, pos)`` -- a plain cache append of ``new[b]`` at row
    ``pos[b]`` of ``c`` ``(B, S, ...)``, dropping positions out of range --
    on each rank's shard of the placed ``c``: ``new`` and ``pos`` are
    brought to ``c``'s batch and trailing placements (no communication
    where they already match), and a sequence-sharded cache's rank
    writes only the rows its shard holds (positions shifted by its
    offset; the others drop as out of range)."""
    mesh = c.device_mesh
    new_pl = [Shard(p.dim - 1) if p.is_shard() and p.dim > 1
              else p if p.is_shard(0) else Replicate()
              for p in c.placements]
    pos_pl = [p if p.is_shard(0) else Replicate() for p in c.placements]
    write(c.to_local(), local(new, mesh, new_pl),
          local(pos, mesh, pos_pl) - _offset(c)[1][1])


def write_prefix(c: torch.Tensor, new: torch.Tensor) -> None:
    """``c[:, :s] = new`` in place (``new`` ``(B, s, ...)``, cast to
    ``c``'s dtype); on a placed ``c``, each rank writes the rows of its
    own shard."""
    if not isinstance(c, DTensor):
        c[:, :new.shape[1]] = new.to(c.dtype)
        return
    mesh = c.device_mesh
    shape, offset = _offset(c)
    rows = local(new, mesh, [p if p.is_shard() and p.dim != 1
                             else Replicate() for p in c.placements])
    rows = rows[:, offset[1]:offset[1] + shape[1]]
    c.to_local()[:, :rows.shape[1]] = rows.to(c.dtype)


def heads(t: torch.Tensor, n: int, d: int,
          groups: Optional[int] = None) -> torch.Tensor:
    """``(..., n * d)`` as ``(..., n, d)``.  A placed projection whose
    column shards would cut a head -- or, for queries, one of the
    ``groups`` KV groups that grouped attention splits them into -- is
    first gathered along that axis (an all-gather; GSPMD reshards there
    too): the reference's rules shard granite's 8 KV heads and its
    queries 16 ways at |model| 16."""
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, t.dim() - 1
        pls = [Replicate() if pl.is_shard(last) and (groups or n)
               % mesh.size(i) else pl for i, pl in enumerate(t.placements)]
        if pls != list(t.placements):
            t = t.redistribute(mesh, pls)
    return t.view(*t.shape[:-1], n, d)


def on_shards(fn: Callable, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, kv_heads: int, lengths=None):
    """``fn(q, k, v[, lengths])`` -- attention over q ``(B, H, ...)`` and
    k/v whose batch is dim 0 and heads dim ``kv_heads`` -- where q is
    placed and the attention is local along every split dim: batch and
    heads (a query shard keeps its KV groups when the mesh divides the KV
    heads; else its heads are gathered).  Each rank runs ``fn`` on its
    shards (``local_map``) and the output is placed as q is: no
    collective, where DTensor's einsum rules may flatten two split dims
    (and refuse).  Pending partial sums (a projection whose weight is
    split along its input, FSDP) are summed first.  Anything else -- a
    plain q, a sequence-sharded K/V -- goes to ``fn`` as it is."""
    if not isinstance(q, DTensor):
        return fn(*((q, k, v) + ((lengths,) if lengths is not None
                                 else ())))
    q, k, v = reduced(q), reduced(k), reduced(v)
    args = (q, k, v) + ((lengths,) if lengths is not None else ())
    mesh = q.device_mesh
    q_pl = []
    for i, pl in enumerate(q.placements):
        if pl.is_shard(0) or pl.is_replicate():
            q_pl.append(pl)
        elif pl.is_shard(1):
            q_pl.append(pl if k.shape[kv_heads] % mesh.size(i) == 0
                        else Replicate())
        else:
            return fn(*args)
    for t in (k, v):
        if isinstance(t, DTensor) and any(
                pl.is_shard() and pl.dim not in (0, kv_heads)
                for pl in t.placements):
            return fn(*args)
    kv_pl = [Shard(kv_heads) if pl.is_shard(1) else pl for pl in q_pl]
    in_pl = (q_pl, kv_pl, kv_pl)
    if lengths is not None:
        in_pl += ([pl if pl.is_shard(0) else Replicate() for pl in q_pl],)
    return local_map(fn, out_placements=q_pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(
        *(_placed(t, mesh) for t in args))


def on_batch_shards(fn: Callable, acts, weights=()) -> torch.Tensor:
    """``fn(*acts, *weights)`` -- a scan over time whose activations
    ``acts`` have their batch on dim 0 -- on each rank's batch shard
    (``local_map``) where ``acts[0]`` is placed: the activations keep the
    mesh dims that split ``acts[0]``'s batch and are whole along the
    others, the weights are whole on every rank, and a weight's gradient
    is a partial sum over the batch's mesh dims.  The output is split as
    the batch.  Each step then runs on local tensors, with no collective
    in the loop: on DTensors the recurrent product's backward
    reduce-scatters the carry's gradient every step.  Pending partial sums
    are summed first.  Plain tensors go to ``fn`` as they are."""
    if not isinstance(acts[0], DTensor):
        return fn(*acts, *weights)
    acts = tuple(reduced(a) for a in acts)
    mesh = acts[0].device_mesh
    act_pl = [Shard(0) if pl.is_shard(0) else Replicate()
              for pl in acts[0].placements]
    w_pl = [Replicate()] * mesh.ndim
    w_grad = [Partial() if pl.is_shard(0) else Replicate() for pl in act_pl]
    n_a, n_w = len(acts), len(weights)
    return local_map(
        fn, out_placements=act_pl,
        in_placements=(act_pl,) * n_a + (w_pl,) * n_w,
        in_grad_placements=(act_pl,) * n_a + (w_grad,) * n_w,
        device_mesh=mesh, redistribute_inputs=True)(
        *(_placed(t, mesh) for t in acts + tuple(weights)))


def _sum(x: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        x = fc.wait_tensor(fc.all_reduce(x, "sum", g))
    return x


class _SumOverShards(torch.autograd.Function):
    """All-reduce (sum) over ``groups`` forward, the identity backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, groups) -> torch.Tensor:
        return _sum(x, groups)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class _SumGrad(torch.autograd.Function):
    """The identity forward, an all-reduce (sum) of the gradient over
    ``groups`` backward: an input that each rank of ``groups`` uses with
    its own shard of the weights gets its whole gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, groups) -> torch.Tensor:
        ctx.groups = groups
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _sum(grad.contiguous(), ctx.groups), None


def summed(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed over the ranks of each process group in ``groups`` (an
    all-reduce each); the gradient passes through: every rank holds the
    sum's whole gradient."""
    return _SumOverShards.apply(x, groups) if groups else x


def row_parallel(a: torch.Tensor, w: torch.Tensor, groups=()) -> torch.Tensor:
    """``a @ w`` where ``a``'s last dim and ``w``'s rows are split over
    ranks, summed over them: ``groups`` for local shards, and on DTensors
    the mesh dims that split ``a``'s last dim.  Each rank's partial product
    stays in f32 until the sum and is rounded to ``a``'s dtype once after
    it, as one card's product rounds its f32 sum once (bf16 partials,
    each rounded and then summed in bf16, miss it by up to 1.5 ulp).  With
    no split, or in f32, the product as it is, summed."""
    if is_dtensor(a):
        split = any(p.is_shard() and p.dim in (-1, a.dim() - 1)
                    and a.device_mesh.size(i) > 1
                    for i, p in enumerate(a.placements))
    else:
        split = bool(groups)
    if split and a.dtype != torch.float32:
        if is_dtensor(a) or not a.is_cuda or (torch.is_grad_enabled() and (
                a.requires_grad or w.requires_grad)):
            y = a.float() @ w.float()
        else:                   # products and sums in f32, no f32 copies
            y = (torch.bmm if a.dim() == 3 else torch.mm)(
                a, w, out_dtype=torch.float32)
        return (reduced(y) if is_dtensor(y) else summed(y, groups)).to(
            a.dtype)
    return reduced(a @ w) if is_dtensor(a) else summed(a @ w, groups)


def grad_summed(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` as it is, its gradient summed over ``groups`` (see
    :class:`_SumGrad`)."""
    return _SumGrad.apply(x, groups) if groups else x


def gather0(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` stacked along dim 0, in rank order
    (an all-gather; no gradient)."""
    import torch.distributed as dist
    out = torch.ops._c10d_functional.all_gather_into_tensor(
        x.contiguous(), dist.get_world_size(group), group.group_name)
    return fc.wait_tensor(out)


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    return fc.wait_tensor(fc.all_to_all_single(x.contiguous(), None, None,
                                               group))


class _AllToAll(torch.autograd.Function):
    """An equal-split all-to-all along dim 0; its backward is the same
    exchange of the gradient (block ``j`` came from rank ``j`` and goes
    back there)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _a2a(grad, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Rank ``i`` sends block ``j`` of ``x`` (dim 0 cut into as many equal
    blocks as ``group`` has ranks) to rank ``j`` and gets its block ``j``
    from rank ``i`` -- a fixed size, so nothing reads the values (it runs
    on ``meta`` under a fake process group) -- with its gradient; None for
    ``group`` (one rank) is the identity."""
    if group is None:
        return x
    return (_AllToAll.apply(x, group) if x.dtype.is_floating_point
            else _a2a(x, group))


def local_weight(w: torch.Tensor, mesh, want, token_axes) -> torch.Tensor:
    """This rank's block of weight ``w`` placed as ``want`` (redistributed
    there if it is not: no communication from ``Replicate`` to ``Shard``),
    as a plain tensor whose gradient flows back to ``w``: on each mesh dim
    in ``token_axes`` where ``want`` replicates ``w``, the ranks use it on
    tokens of their own, so its gradient there is a partial sum."""
    w = _placed(w, mesh)
    if list(w.placements) != list(want):
        w = w.redistribute(mesh, want)
    return w.to_local(grad_placements=[
        Partial() if i in token_axes and pl.is_replicate() else pl
        for i, pl in enumerate(want)])


def embed(tokens: torch.Tensor, table: DTensor) -> torch.Tensor:
    """Vocabulary-parallel lookup: each rank looks up the tokens its rows
    hold (zeros for the others) and the partial rows are summed over the
    vocabulary's mesh axes (an all-reduce forward, the identity backward:
    each rank's rows take the whole gradient of their tokens; a sum of
    one row and zeros, so exact).  A table also sharded along d (FSDP) is
    gathered along d first.  Written out because DTensor's own masked
    partial is not redistributed correctly in the backward."""
    mesh = table.device_mesh
    if any(p.is_shard() and not p.is_shard(0) for p in table.placements):
        table = table.redistribute(mesh, [
            p if p.is_shard(0) else Replicate() for p in table.placements])
    vocab = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    tokens = _placed(tokens, mesh)
    if any(not tokens.placements[i].is_replicate() for i in vocab):
        tokens = tokens.redistribute(mesh, [
            Replicate() if i in vocab else p
            for i, p in enumerate(tokens.placements)])
    shape, offset = _offset(table)
    tok = tokens.to_local().long() - offset[0]
    hit = (tok >= 0) & (tok < shape[0])
    # this rank's table rows see the gradient of this rank's tokens only:
    # a partial sum over the axes that split the tokens
    rows_of = table.to_local(grad_placements=[
        table.placements[i] if i in vocab
        else Partial() if p.is_shard() else Replicate()
        for i, p in enumerate(tokens.placements)])
    rows = torch.nn.functional.embedding(
        tok.clamp(0, max(shape[0] - 1, 0)), rows_of)
    rows = _SumOverShards.apply(rows * hit[..., None].to(rows.dtype),
                                [mesh.get_group(i) for i in vocab])
    shape = torch.Size(tuple(tokens.shape) + (table.shape[1],))
    return DTensor.from_local(rows, mesh, tokens.placements, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


def cross_entropy(logits: DTensor, labels: torch.Tensor) -> torch.Tensor:
    """The vocabulary-parallel NLL, written out on each rank's shard: the
    row max (an all-reduce max over the vocabulary axes), the sum of
    exponentials and the gold logit (all-reduce sums, the identity
    backward), then the sum of this rank's tokens' NLL over the batch
    axes, divided by the token count -- a plain scalar, the same on
    every rank.  (``torch.distributed.tensor.parallel.loss_parallel``
    does this for a one-dimensional mesh only, on some releases with no
    mean.)"""
    mesh, last = logits.device_mesh, logits.dim() - 1
    if any(not p.is_replicate() and not p.is_shard(0)
           and not p.is_shard(last) for p in logits.placements):
        logits = logits.redistribute(mesh, [
            p if p.is_shard(0) or p.is_shard(last) else Replicate()
            for p in logits.placements])
    vocab = [i for i, p in enumerate(logits.placements) if p.is_shard(last)]
    batch = [i for i, p in enumerate(logits.placements) if p.is_shard(0)]
    labels = local(labels, mesh, [Replicate() if i in vocab else p
                                  for i, p in enumerate(logits.placements)])
    shape, offset = _offset(logits)
    mine = logits.to_local()
    top = mine.detach().amax(dim=-1)
    for i in vocab:
        top = fc.wait_tensor(fc.all_reduce(top, "max", mesh.get_group(i)))
    groups = [mesh.get_group(i) for i in vocab]
    sumexp = _SumOverShards.apply(
        torch.exp(mine - top[..., None]).sum(dim=-1), groups)
    col = labels.long() - offset[last]
    hit = (col >= 0) & (col < shape[last])
    gold = mine.gather(-1, col.clamp(0, max(shape[last] - 1, 0))[..., None]
                       ).squeeze(-1)
    gold = _SumOverShards.apply(gold * hit.to(gold.dtype), groups)
    nll = torch.log(sumexp) + top - gold
    total = _SumOverShards.apply(nll.sum(), [mesh.get_group(i)
                                             for i in batch])
    return total / (logits.numel() // logits.shape[-1])
