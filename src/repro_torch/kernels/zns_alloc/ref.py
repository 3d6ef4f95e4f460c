"""Plain PyTorch version of the zns_alloc selection kernel.

The same function as ``csrc/zns_alloc.cu``, written with tensor ops: the
CPU path of :func:`repro_torch.kernels.zns_alloc.ops.zns_alloc_rows` and
the yardstick the kernel is held to, bit for bit, on the card.

Per row ``(lane, group)`` of a ``(L, G, W)`` wear/availability batch, an
element (column ``c``) is *free* when its availability code is FREE (0) or
INVALID (3), its row is eligible, and ``c < per_group_eff[lane]`` (columns
past a union lane's own group width are padding).  Every column gets a
unique 64-bit key::

    free, by_wear       (wear << 32) | c
    free, not by_wear   c
    not free            (1 << 62) | c

and the row selects the ``take`` smallest keys.  The picks are then
re-ordered by ``(wear, c)`` with non-free filler last in ascending column
order -- the order the engine assigns zone slots in.  Keys stay unique
while ``0 <= wear < 2**30``.
"""

from __future__ import annotations

from typing import Tuple

import torch

AVAIL_FREE, AVAIL_INVALID = 0, 3
NONFREE = 1 << 62


def _free_mask(avail, eligible, per_group_eff):
    width = avail.shape[-1]
    col = torch.arange(width, dtype=torch.int32, device=avail.device)
    return (((avail == AVAIL_FREE) | (avail == AVAIL_INVALID))
            & (eligible != 0)[..., None]
            & (col < per_group_eff[:, None, None]))


def zns_alloc_rows_ref(wear: torch.Tensor, avail: torch.Tensor,
                       eligible: torch.Tensor, by_wear: torch.Tensor,
                       take_eff: torch.Tensor, per_group_eff: torch.Tensor,
                       *, take: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Returns ``(cols, ok, cost, sel)``:

    * ``cols`` (L, G, take) int32 -- the selected columns, ordered by
      ``(wear, col)``, non-free filler last in ascending column order;
    * ``ok`` (L, G) int32 -- the row's free count;
    * ``cost`` (L, G) float32 -- the wear summed in f32 over the first
      ``take_eff[lane]`` entries of ``cols`` (the ``take_eff`` smallest
      free wears under ``by_wear``), ``+inf`` if one of them is not free;
    * ``sel`` (L, G, W) int32 0/1 -- the free picks as a mask.
    """
    free = _free_mask(avail, eligible, per_group_eff)
    col = torch.arange(wear.shape[-1], dtype=torch.int64,
                       device=wear.device)
    w64 = wear.to(torch.int64)
    by_wear_key = torch.where(by_wear[:, None, None] != 0,
                              (w64 << 32) | col, col)
    key = torch.where(free, by_wear_key, NONFREE | col)
    picks = torch.sort(key, dim=-1, stable=True).values[..., :take]
    pcol = picks & 0xFFFFFFFF
    pfree = picks < NONFREE
    pwear = torch.gather(w64, -1, pcol)
    order = torch.sort(torch.where(pfree, (pwear << 32) | pcol,
                                   NONFREE | pcol),
                       dim=-1, stable=True).indices
    cols = torch.gather(pcol, -1, order).to(torch.int32)
    sfree = torch.gather(pfree, -1, order)
    swear = torch.gather(pwear, -1, order).to(torch.float32)
    part = torch.where(sfree, swear, torch.inf)
    rank = torch.arange(take, dtype=torch.int32, device=wear.device)
    part = torch.where(rank < take_eff[:, None, None], part, 0.0)
    # sequential left-to-right f32 sum, as the kernel adds
    cost = torch.zeros(part.shape[:-1], dtype=torch.float32,
                       device=wear.device)
    for r in range(take):
        cost = cost + part[..., r]
    ok = free.sum(-1).to(torch.int32)
    sel = torch.zeros(wear.shape, dtype=torch.int32, device=wear.device)
    sel.scatter_(-1, pcol, pfree.to(torch.int32))
    return cols, ok, cost, sel


def zns_alloc_ref(wear2d: torch.Tensor, avail2d: torch.Tensor,
                  eligible: torch.Tensor, *, take: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas contract: ``(sel int32 (G, W), ok int32 (G,))`` -- per
    eligible row the ``take`` lowest-wear free elements, ties to the
    lowest column."""
    one = torch.ones(1, dtype=torch.int32, device=wear2d.device)
    take_k = min(take, wear2d.shape[-1])
    _, ok, _, sel = zns_alloc_rows_ref(
        wear2d[None], avail2d[None], eligible[None].to(torch.int32), one,
        one * take_k, one * wear2d.shape[-1], take=take_k)
    return sel[0], ok[0]
