"""Opt-in :class:`~repro_torch.core.engine.DeviceState` invariant checker
(the port of ``repro.check.sanitizer``).

:func:`check_state` pulls one device state host-side and audits the
cross-array invariants the engine maintains by construction -- the
things a corrupted state (bad deserialization, hand-edited state, a
future engine bug) would silently violate while every individual array
still "looks" plausible:

* availability / zone-state codes are in range, scratch wear is zero,
  union-grid padding cells are untouched;
* the zone table and the element reverse map agree in both directions,
  and no element is committed to two zones (zone-element disjointness).
  One engine-legal exception is tolerated: silent allocation against a
  dyn-shrunk ``zone_pages`` can collide two claims on one slot, leaving
  the loser ALLOCATED with zero pages and a stale ``elem_zone`` entry
  (see the inline note and ``docs/CHECKING.md``);
* ``0 <= host_wp <= wp <= dyn.zone_pages`` per zone, EMPTY zones are
  fully unmapped with zeroed pointers;
* ``n_active`` equals the OPEN-zone count;
* counters reconcile: ``dlwa == (host + dummy) / host`` against an
  optional external metrics dict, and (for states driven through a
  single effective :class:`~repro_torch.core.engine.DynConfig`, the batched
  engine's per-lane situation) ``block_erases == total element wear *
  blocks_per_element`` -- every erase the engine defers at claim time
  increments exactly one element's wear;
* the silent policy's wear bound (opt-in, ``strict_wear_bound=True``):
  the wear spread of the lane's grid is within ``dyn.wear_bound``.
  This one is *warning-grade by default* because it is not an
  invariant of legal histories: an element can legally sit VALID and
  least-worn forever while the free set churns far past the bound (the
  bound constrains each *claim* against the then-free minimum, not the
  final snapshot) -- see ``docs/CHECKING.md``.

Everything is numpy on fetched values (tensors on any device are read
back first): sanitizing between dispatches adds no device work.  :func:`check_states` / :func:`assert_states`
run the same audit per lane over the stacked states ``run_programs``
returns.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import engine as E
from repro_torch.core.alloc_exact import (AVAIL_ALLOCATED, AVAIL_FREE,
                                    AVAIL_INVALID, AVAIL_VALID)


class SanitizerError(AssertionError):
    """A :class:`DeviceState` violated an engine invariant.  Carries
    the full violation list in ``violations``."""

    def __init__(self, violations: Sequence[str], where: str = "state"):
        self.violations = list(violations)
        lines = "\n  - ".join(self.violations)
        super().__init__(
            f"{where}: {len(self.violations)} device-state invariant "
            f"violation(s):\n  - {lines}")


def _np(leaf, lane: Optional[int] = None) -> np.ndarray:
    a = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
         else np.asarray(leaf))
    if lane is not None:
        a = a[lane]
    return a


def check_state(cfg: E.EngineConfig, state, dyn=None,
                lane: Optional[int] = None, *,
                metrics: Optional[dict] = None,
                check_wear: bool = True,
                strict_wear_bound: bool = False) -> List[str]:
    """Audit one device state; returns the violation list (empty when
    clean).  ``lane`` selects one row of a stacked state/DynConfig (as
    returned by ``run_programs``).  ``metrics`` cross-checks an external
    ``ZoneEngine.metrics`` dict against the state's own counters;
    ``check_wear=False`` skips the wear/erase reconciliation (for
    states merged across heterogeneous lanes, where blocks-per-element
    is not a single scalar); ``strict_wear_bound=True`` additionally
    flags a wear spread beyond ``dyn.wear_bound`` (advisory -- legal
    histories can exceed it, see the module docstring)."""
    dv = E.dyn_values(cfg, dyn, lane)
    v: List[str] = []
    n = cfg.n_elements

    wear = _np(state.elem_wear, lane)
    avail = _np(state.elem_avail, lane)
    pages = _np(state.elem_pages, lane)
    ezone = _np(state.elem_zone, lane)
    zstate = _np(state.zone_state, lane)
    zwp = _np(state.zone_wp, lane)
    zhwp = _np(state.zone_host_wp, lane)
    zelems = _np(state.zone_elems, lane)
    zcols = _np(state.zone_cols, lane)
    n_active = int(_np(state.n_active, lane))
    host = int(_np(state.host_pages, lane))
    dummy = int(_np(state.dummy_pages, lane))
    erases = int(_np(state.block_erases, lane))

    if wear.shape != (n + 1,):
        v.append(f"elem_wear shape {wear.shape}, want ({n + 1},) "
                 f"(n_elements + scratch)")
        return v  # nothing else is trustworthy
    if zelems.shape != (cfg.n_zones, cfg.n_slots):
        v.append(f"zone_elems shape {zelems.shape}, want "
                 f"({cfg.n_zones}, {cfg.n_slots})")
        return v

    # -- code ranges ---------------------------------------------------- #
    bad = ~np.isin(avail[:n], (AVAIL_FREE, AVAIL_ALLOCATED,
                               AVAIL_VALID, AVAIL_INVALID))
    for e in np.nonzero(bad)[0][:3]:
        v.append(f"element {e}: avail code {int(avail[e])} not in 0..3")
    bad = ~np.isin(zstate, (E.ZONE_EMPTY, E.ZONE_OPEN, E.ZONE_FULL))
    for z in np.nonzero(bad)[0][:3]:
        v.append(f"zone {z}: state code {int(zstate[z])} not in "
                 f"EMPTY/OPEN/FULL")
    if wear[n] != 0:
        v.append(f"scratch element wear {int(wear[n])} != 0 (masked "
                 f"scatters must not accumulate wear)")
    if (wear[:n] < 0).any():
        e = int(np.nonzero(wear[:n] < 0)[0][0])
        v.append(f"element {e}: negative wear {int(wear[e])}")

    # -- zone table -> element reverse map ------------------------------ #
    owner = np.full(n, -1, np.int64)   # element -> owning zone (forward)
    for z in range(cfg.n_zones):
        row = zelems[z]
        ids = row[row >= 0]
        if (row < -1).any() or (ids >= n).any():
            v.append(f"zone {z}: slot ids outside [-1, {n})")
            continue
        uniq = np.unique(ids)
        dup_other = uniq[(owner[uniq] >= 0)]
        for e in dup_other[:3]:
            v.append(f"element {int(e)} committed to zones "
                     f"{int(owner[e])} and {z} (disjointness)")
        owner[uniq] = z
        if zstate[z] == E.ZONE_EMPTY:
            if ids.size:
                v.append(f"zone {z}: EMPTY but {ids.size} slots mapped")
            if zwp[z] != 0 or zhwp[z] != 0:
                v.append(f"zone {z}: EMPTY with wp={int(zwp[z])} "
                         f"host_wp={int(zhwp[z])}")
        for e in uniq[:cfg.n_slots]:
            if ezone[e] != z:
                v.append(f"element {int(e)}: elem_zone={int(ezone[e])} "
                         f"but mapped in zone {z}'s slot row")
            if avail[e] not in (AVAIL_ALLOCATED, AVAIL_VALID):
                v.append(f"element {int(e)}: mapped in zone {z} with "
                         f"avail code {int(avail[e])} (want ALLOCATED "
                         f"or VALID)")

    unmapped = owner < 0
    # Silent-policy allocation under a dyn-shrunk zone (zone_pages below
    # the spec's static capacity) computes slot indices against the
    # static stride, so two claimed elements can collide on one slot:
    # the slot-row scatter keeps the last writer and drops the other,
    # while the elem_zone/avail scatters cover every claimed id.  The
    # dropped element stays ALLOCATED with zero live pages and a stale
    # reverse-map entry; the engine never reads elem_zone for
    # correctness, so this is a legal (if leaky) state, not corruption.
    orphan_ok = (avail[:n] == AVAIL_ALLOCATED) & (pages[:n] == 0)
    stray = unmapped & (ezone[:n] >= 0) & ~orphan_ok
    for e in np.nonzero(stray)[0][:3]:
        v.append(f"element {e}: elem_zone={int(ezone[e])} but absent "
                 f"from every zone's slot row")
    freeish = np.isin(avail[:n], (AVAIL_FREE, AVAIL_INVALID))
    bad = freeish & ~unmapped
    for e in np.nonzero(bad)[0][:3]:
        v.append(f"element {e}: avail FREE/INVALID but mapped in zone "
                 f"{int(owner[e])}")
    bad = freeish & (pages[:n] != 0)
    for e in np.nonzero(bad)[0][:3]:
        v.append(f"element {e}: avail FREE/INVALID with "
                 f"{int(pages[e])} live pages")
    bad = (pages[:n] < 0) | (pages[:n] > dv["pages_per_element"])
    for e in np.nonzero(bad)[0][:3]:
        v.append(f"element {e}: pages {int(pages[e])} outside "
                 f"[0, {dv['pages_per_element']}]")

    # -- per-zone pointers ---------------------------------------------- #
    bad = (zwp < 0) | (zwp > dv["zone_pages"])
    for z in np.nonzero(bad)[0][:3]:
        v.append(f"zone {z}: wp {int(zwp[z])} outside "
                 f"[0, {dv['zone_pages']}]")
    bad = (zhwp < 0) | (zhwp > zwp)
    for z in np.nonzero(bad)[0][:3]:
        v.append(f"zone {z}: host_wp {int(zhwp[z])} outside "
                 f"[0, wp={int(zwp[z])}]")
    bad = (zcols < 0) | (zcols >= cfg.n_groups * cfg.parallelism)
    for z in np.nonzero(bad.any(axis=1))[0][:3]:
        v.append(f"zone {z}: column map entries outside "
                 f"[0, {cfg.n_groups * cfg.parallelism})")

    # -- union-grid padding stays untouched ----------------------------- #
    ng_eff = dv["n_elements"] // max(dv["per_group"], 1)
    grid = np.arange(n)
    in_lane = ((grid // cfg.per_group < ng_eff)
               & (grid % cfg.per_group < dv["per_group"]))
    pad_dirty = ~in_lane & ((avail[:n] != AVAIL_FREE) | (wear[:n] != 0)
                            | (pages[:n] != 0) | (ezone[:n] != -1))
    for e in np.nonzero(pad_dirty)[0][:3]:
        v.append(f"element {e}: union-grid padding cell touched "
                 f"(avail={int(avail[e])} wear={int(wear[e])})")

    # -- counters ------------------------------------------------------- #
    open_count = int((zstate == E.ZONE_OPEN).sum())
    if n_active != open_count:
        v.append(f"n_active={n_active} but {open_count} zones are OPEN")
    if host < 0 or dummy < 0:
        v.append(f"negative page counters host={host} dummy={dummy}")
    if check_wear:
        bpe = dv["pages_per_element"] // cfg.pages_per_block
        want = int(wear[:n].sum()) * bpe
        if erases != want:
            v.append(
                f"block_erases={erases} but total element wear "
                f"{int(wear[:n].sum())} x {bpe} blocks/element = {want} "
                f"(every deferred erase increments one element's wear)")
    if metrics is not None:
        want_dlwa = (host + dummy) / host if host else 1.0
        for key, want in (("host_pages", float(host)),
                          ("dummy_pages", float(dummy)),
                          ("block_erases", float(erases)),
                          ("dlwa", want_dlwa)):
            got = metrics.get(key)
            if got is not None and not np.isclose(got, want):
                v.append(f"metrics[{key!r}]={got} but state implies "
                         f"{want}")

    # -- wear-bound spread (advisory) ----------------------------------- #
    if (strict_wear_bound and dv["alloc_policy"] == E.POLICY_SILENT
            and in_lane.any()):
        lane_wear = wear[:n][in_lane]
        spread = int(lane_wear.max()) - int(lane_wear.min())
        if spread > dv["wear_bound"]:
            v.append(f"wear spread {spread} exceeds wear_bound="
                     f"{dv['wear_bound']} (advisory: legal histories "
                     f"can exceed a per-claim bound in snapshot)")
    return v


def assert_state(cfg: E.EngineConfig, state, dyn=None,
                 lane: Optional[int] = None, *,
                 where: str = "state", **kw) -> None:
    """:func:`check_state`, raising :class:`SanitizerError` on any
    violation."""
    v = check_state(cfg, state, dyn, lane, **kw)
    if v:
        raise SanitizerError(v, where=where)


def check_states(cfg: E.EngineConfig, states, dyn=None, *,
                 lanes: Optional[Sequence[int]] = None,
                 **kw) -> List[List[str]]:
    """Per-lane :func:`check_state` over the stacked states (leading
    lane axis on every leaf) that ``run_programs`` returns.  ``dyn``
    may be a matching stacked DynConfig, a single one, or ``None``."""
    n_lanes = int(states.n_active.shape[0])
    stacked = dyn is not None and _np(dyn.zone_pages).ndim > 0
    out = []
    for k in (lanes if lanes is not None else range(n_lanes)):
        out.append(check_state(cfg, states, dyn, lane=int(k),
                               **kw) if stacked else
                   check_state(cfg, _slice_lane(states, int(k)), dyn,
                               **kw))
    return out


def _slice_lane(states, k: int):
    return type(states)(*[_np(leaf, k) for leaf in states])


def assert_states(cfg: E.EngineConfig, states, dyn=None, *,
                  where: str = "states", **kw) -> None:
    for k, v in enumerate(check_states(cfg, states, dyn, **kw)):
        if v:
            raise SanitizerError(v, where=f"{where}[lane {k}]")
