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
* :func:`embed` / :func:`cross_entropy`: the vocabulary-parallel lookup
  and NLL.
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
    (and refuse).  Anything else -- a plain q, a sequence-sharded K/V --
    goes to ``fn`` as it is."""
    args = (q, k, v) + ((lengths,) if lengths is not None else ())
    if not isinstance(q, DTensor):
        return fn(*args)
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


class _SumOverShards(torch.autograd.Function):
    """All-reduce (sum) over ``groups`` forward, the identity backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, groups) -> torch.Tensor:
        for g in groups:
            x = fc.wait_tensor(fc.all_reduce(x, "sum", g))
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


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
