"""Plain PyTorch version of the zns_alloc selection kernel.

The same functions as ``csrc/zns_alloc.cu``, written with tensor ops: the
CPU path of the wrappers in :mod:`repro_torch.kernels.zns_alloc.ops` and
the yardstick the kernels are held to, bit for bit, on the card.

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

:func:`alloc_select_ref` and :func:`grow_select_ref` are the engine's
whole ALLOC and silent-grow selections per lane (one launch each on the
card): the wear-bounded availability, the round-robin window, the
cheapest groups and the claimed element ids, from the lane constants
packed in :data:`LANE_FIELDS` order.
"""

from __future__ import annotations

from typing import Tuple

import torch

AVAIL_FREE, AVAIL_VALID, AVAIL_INVALID = 0, 1, 3
NONFREE = 1 << 62
BIG = 2**30        # the engine's sentinel wear

#: the per-lane constants of the fused selections, in column order of the
#: ``(L, len(LANE_FIELDS))`` int32 table they read: the lane's own group
#: width and group count, zone groups, ranks a full claim takes, the
#: wear-aware key (0/1), the silent policy (0/1), the wear bound, pages
#: per claimed rank, the member's ``take`` and LUN columns per element
LANE_FIELDS = ("per_group", "n_groups", "zone_groups", "take_eff",
               "wear_aware", "silent", "wear_bound", "per_rank", "take",
               "lpg")


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


# ----------------------------------------------------------------------- #
# the engine's fused selections
# ----------------------------------------------------------------------- #
def _fields(lanes: torch.Tensor) -> dict:
    return dict(zip(LANE_FIELDS, lanes.unbind(1)))


def _grids(wear, avail, n_groups: int, per_group: int):
    """The (L, n_groups, per_group) views of the element arrays (which
    carry a scratch slot past the grid)."""
    n = n_groups * per_group
    shape = (wear.shape[0], n_groups, per_group)
    return wear[:, :n].reshape(shape), avail[:, :n].reshape(shape)


def _wear_bounded(w2, a2, f) -> torch.Tensor:
    """The availability codes with every element worn more than
    ``wear_bound`` past the least-worn free element of the lane's own
    grid presented busy (VALID)."""
    G, W = w2.shape[1:]
    dev = w2.device
    real = ((torch.arange(G, device=dev) < f["n_groups"][:, None])[..., None]
            & (torch.arange(W, device=dev) < f["per_group"][:, None])[:,
                                                                    None])
    free = (a2 == AVAIL_FREE) | (a2 == AVAIL_INVALID)
    min_wear = torch.where(free & real, w2, BIG).amin((1, 2))
    in_bound = (w2 - min_wear[:, None, None]) <= f["wear_bound"][:, None,
                                                                 None]
    return torch.where(in_bound, a2, AVAIL_VALID)


def _first_groups(elig: torch.Tensor, k: int) -> torch.Tensor:
    """``jnp.nonzero(elig, size=k, fill_value=0)`` per lane: the first
    ``k`` eligible group ids ascending, 0-filled -- from a running count
    instead of a sort."""
    L, G = elig.shape
    pos = torch.cumsum(elig.to(torch.int32), 1, dtype=torch.int32) - 1
    slot = torch.where(elig & (pos < k), pos, k).long()
    g = torch.arange(G, dtype=torch.int32, device=elig.device).expand(L, G)
    out = torch.zeros((L, k + 1), dtype=torch.int32, device=elig.device)
    return out.scatter(1, slot, g)[:, :k]


def _claim(elig, cols, per_group: int, zone_groups: int):
    """The winning groups (the first ``zone_groups`` eligible, ascending,
    0-filled) and their selected element ids (L, zone_groups, take).  A
    group that is not eligible selects its first ``take`` columns, as a
    selection with no free element does."""
    take = cols.shape[-1]
    filler = torch.arange(take, dtype=torch.int32, device=cols.device)
    cols = torch.where(elig[..., None], cols, filler)
    win = _first_groups(elig, zone_groups)
    picked = torch.gather(cols, 1, win.long()[..., None].expand(-1, -1,
                                                                take))
    return win, (win[:, :, None] * per_group + picked).to(torch.int32)


def alloc_select_ref(wear: torch.Tensor, avail: torch.Tensor,
                     lanes: torch.Tensor, rr_next: torch.Tensor,
                     hint: torch.Tensor, *, n_groups: int, per_group: int,
                     take: int, zone_groups: int):
    """The engine's ALLOC selection for every lane.

    ``wear`` / ``avail`` are the ``(L, >= n_groups * per_group)`` element
    arrays, ``lanes`` the ``(L, len(LANE_FIELDS))`` constants,
    ``rr_next`` the round-robin window start and ``hint`` the op's page
    count, both ``(L,)``.  A traditional lane takes its round-robin
    window (key ``(wear, col)`` when wear-aware, else ``col``) when every
    window group has ``take_eff`` free elements, and otherwise the
    ``zone_groups`` groups whose ``take_eff`` cheapest free elements
    cost least (ties to the lower group).  A silent lane takes those
    cheapest groups on the wear-bounded grid, for the ranks the hint
    needs.  One wear-keyed selection per group serves both the ranking
    and the claim.

    Returns ``(win (L, zone_groups), eids (L, zone_groups, take),
    feasible (L,) bool, rr_next (L,), rank_lim (L,))``: the winning
    groups, their elements in slot order, whether the claim can be
    made, the next window start and the ranks the claim commits."""
    f = _fields(lanes)
    w2, a2 = _grids(wear, avail, n_groups, per_group)
    dev = w2.device
    g = torch.arange(n_groups, dtype=torch.int32, device=dev)
    sil = f["silent"] != 0
    take_eff = f["take_eff"]
    ones = torch.ones_like(take_eff)

    # traditional: the round-robin window
    pos = torch.arange(zone_groups, dtype=torch.int32, device=dev)
    idx = torch.where(pos < f["zone_groups"][:, None],
                      torch.remainder(rr_next[:, None] + pos,
                                      f["n_groups"][:, None]), n_groups)
    elig1 = (idx[:, :, None] == g).any(1)
    cols1, ok1, _, _ = zns_alloc_rows_ref(
        w2, a2, elig1.to(torch.int32), f["wear_aware"], take_eff,
        f["per_group"], take=take)
    f1 = ((ok1 >= take_eff[:, None]) | ~elig1).all(1)

    # the cheapest groups: traditional's fallback (whole claim,
    # unbounded) or silent's (hint-sized ranks, at least one, on the
    # wear-bounded grid)
    ranks_hint = -torch.div(-hint, f["per_rank"], rounding_mode="floor")
    take_s = torch.minimum(torch.clamp(
        torch.where(hint > 0, ranks_hint, take_eff), min=1), take_eff)
    a2p = torch.where(sil[:, None, None], _wear_bounded(w2, a2, f), a2)
    take_p = torch.where(sil, take_s, take_eff)
    rows = (g < f["n_groups"][:, None]) & (f["per_group"][:, None] > 0)
    cols2, ok2, cost, _ = zns_alloc_rows_ref(
        w2, a2p, rows.to(torch.int32), ones, take_p, f["per_group"],
        take=take)
    before = ((cost[:, None, :] < cost[:, :, None])
              | ((cost[:, None, :] == cost[:, :, None])
                 & (g[None, :] < g[:, None])))
    elig2 = before.sum(2) < f["zone_groups"][:, None]
    f2 = ((ok2 >= take_p[:, None]) | ~elig2).all(1)

    use_rr = ~sil & f1
    elig = torch.where(use_rr[:, None], elig1, elig2)
    cols = torch.where(use_rr[:, None, None], cols1, cols2)
    win, eids = _claim(elig, cols, per_group, zone_groups)
    feasible = torch.where(sil, f2, f1 | f2)
    # the window advances even when the allocation then fails
    rr_out = torch.where(sil, rr_next, torch.remainder(
        rr_next + f["zone_groups"], f["n_groups"]))
    rank_lim = torch.where(sil, take_s, f["take"])
    return win, eids, feasible, rr_out, rank_lim


def grow_select_ref(wear: torch.Tensor, avail: torch.Tensor,
                    lanes: torch.Tensor, zone_cols: torch.Tensor,
                    zone: torch.Tensor, k: torch.Tensor, *, n_groups: int,
                    per_group: int, take: int, zone_groups: int):
    """The silent policy's grow selection for every lane: in the groups
    of zone ``zone[lane]`` (recovered from its ``(L, n_zones, P)``
    column map), the ``take`` cheapest wear-bounded free elements, of
    which the claim takes ``k[lane]``.  Returns ``(eids (L, zone_groups,
    take), feasible (L,) bool)``."""
    f = _fields(lanes)
    w2, a2 = _grids(wear, avail, n_groups, per_group)
    dev = w2.device
    L, P = zone_cols.shape[0], zone_cols.shape[-1]
    zc = zone_cols[torch.arange(L, device=dev), zone.long()]
    pos = torch.arange(zone_groups, dtype=torch.int32, device=dev)[None, :]
    lpg = f["lpg"][:, None]
    at = torch.clamp(pos * lpg, 0, P - 1)
    win_g = torch.div(torch.gather(zc, 1, at.long()), lpg,
                      rounding_mode="floor")
    gidx = torch.where(pos < f["zone_groups"][:, None], win_g, n_groups)
    g = torch.arange(n_groups, dtype=torch.int32, device=dev)
    elig = (gidx[:, :, None] == g).any(1)
    cols, ok, _, _ = zns_alloc_rows_ref(
        w2, _wear_bounded(w2, a2, f), elig.to(torch.int32),
        torch.ones_like(k), k, f["per_group"], take=take)
    feasible = ((ok >= k[:, None]) | ~elig).all(1)
    return _claim(elig, cols, per_group, zone_groups)[1], feasible
