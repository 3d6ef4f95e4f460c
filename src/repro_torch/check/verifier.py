"""Static op-program verifier: a numpy abstract interpreter over the
width-5 op-program IR (the port of ``repro.check.verifier``).

:func:`verify_program` walks a program against a *symbolic device
model* -- a host-side numpy mirror of the :mod:`repro_torch.core.engine`
state machine (per-zone EMPTY/OPEN/FULL states, write pointers,
active-set occupancy, element commitments, and the lane's effective
:class:`~repro_torch.core.engine.DynConfig` geometry) -- without dispatching
anything, and predicts, per op, the exact ok/illegal verdict the
engine's ``trace.ok`` would report, plus the *error class* a shim
(:class:`repro_torch.core.device.ZNSDevice` /
:class:`repro_torch.storage.compile.RecordingBackend`) would raise for the
same op, formatted with the shim's own message strings.

The hard guarantee (fuzzed in ``tests/test_check.py`` across all five
element specs x both allocation policies, and held to the reference in
``tests/test_torch_check.py``): the predicted ok-mask is
bit-identical to ``trace.ok`` from ``run_program``.  That requires the
model to reproduce the engine's semantics exactly, including the
deliberately-odd corners:

* op codes are clipped into ``[NOP, READ]`` and zones into
  ``[0, dyn.n_zones)`` -- out-of-range rows never fail, they alias;
* READ/NOP/FINISH/RESET always report ``ok`` engine-side (an unmapped
  READ is a *control-plane* error: the shims raise, the data plane is
  a no-op) -- the verifier reports those as ok-verdicts carrying an
  *advisory* error class instead;
* a failed WRITE keeps its side effects up to the failure point: the
  implicit ALLOC of a write to an EMPTY zone persists even when the
  write itself then overflows (legacy-device parity);
* a traditional ALLOC advances the round-robin window even when
  infeasible (but not past an active-limit refusal), and falls back to
  the cheapest-groups selection when the window is exhausted;
* a silent ALLOC sizes its claim to the op's page hint, draws from the
  cheapest wear-bounded groups, never consumes the round-robin window,
  and :func:`_grow` claims missing ranks on the fly mid-WRITE.

Beyond the per-op verdicts, :class:`ProgramReport` derives the static
analyses the paper's predictability claim wants provable up front:
superfluous-write (dummy-page) sites, a DLWA lower bound, peak
active-zone pressure, the ops a silent lane's wear bound (rather than
raw capacity) would block, and policy/spec incompatibilities
(silent-on-FIXED).  :func:`validate_rows` is the cheap malformed-row
pre-check the dispatch layers run before burning a batched scan.

Everything here is pure numpy on host values: verifying dispatches
nothing to a device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import engine as E
from repro_torch.core.alloc_exact import (AVAIL_ALLOCATED, AVAIL_FREE,
                                    AVAIL_INVALID, AVAIL_VALID)
from repro_torch.core.elements import ElementKind

_BIG = 2**30  # engine's sentinel wear for unavailable slots

OP_NAMES = {E.OP_NOP: "NOP", E.OP_ALLOC: "ALLOC", E.OP_WRITE: "WRITE",
            E.OP_FINISH: "FINISH", E.OP_RESET: "RESET", E.OP_READ: "READ"}

#: error classes (the shim RuntimeError families)
ERR_FULL = "full"
ERR_OVERFLOW = "overflow"
ERR_ACTIVE_LIMIT = "active-limit"
ERR_ALLOC_INFEASIBLE = "alloc-infeasible"
ERR_UNMAPPED_READ = "unmapped-read"  # advisory: engine READs never fail


@dataclasses.dataclass(frozen=True)
class OpVerdict:
    """One op's predicted outcome.  ``ok`` mirrors the engine's
    ``trace.ok`` bit; ``error`` is the shim error class (also set --
    advisory -- on ok READ ops touching an unmapped zone); ``message``
    is the exact string the shim would raise."""

    index: int
    op: int
    zone: int
    ok: bool
    error: Optional[str] = None
    message: Optional[str] = None

    @property
    def op_name(self) -> str:
        return OP_NAMES.get(self.op, f"op{self.op}")


@dataclasses.dataclass
class ProgramReport:
    """The verifier's verdicts + derived static analyses for one lane.

    ``ok`` is the predicted per-op legality mask (bit-identical to the
    engine's ``trace.ok``); ``advisories`` are control-plane-only
    diagnostics (unmapped READs) the engine data plane tolerates.
    ``dummy_sites`` lists ``(op index, zone, pages)`` of superfluous
    writes: FINISH padding the device emits to seal a partial zone,
    plus explicit non-host (``flags bit0 = 0``) write rows.
    ``wear_bound_blocked`` lists silent-lane ops whose allocation
    failed *only* because of the wear-leveling bound (the same claim
    with an unbounded ``wear_bound`` would have been feasible) -- the
    feasibility signal for picking a bound.  ``conflicts`` are
    policy/spec incompatibilities detected before walking a single op.
    """

    ok: np.ndarray
    verdicts: List[OpVerdict]
    advisories: List[OpVerdict]
    dummy_sites: List[Tuple[int, int, int]]
    host_pages: int
    dummy_pages: int
    peak_active: int
    wear_bound_blocked: List[int]
    conflicts: List[str]

    @property
    def dlwa_lower_bound(self) -> float:
        """Device-level write amplification implied by the program's
        legal ops alone -- a lower bound on what any dispatch of it can
        achieve (illegal ops move no pages; reads amplify nothing)."""
        if self.host_pages <= 0:
            return 1.0
        return (self.host_pages + self.dummy_pages) / self.host_pages

    def first_failure(self) -> Optional[OpVerdict]:
        for v in self.verdicts:
            if not v.ok:
                return v
        return None

    @property
    def all_ok(self) -> bool:
        return bool(self.ok.all())


class _Dv:
    """Effective per-lane dyn values as attributes (plain ints)."""

    def __init__(self, values: Dict):
        self.__dict__.update(values)


def _spec_name(cfg: E.EngineConfig, dv: _Dv) -> str:
    """The member spec name matching a lane's dyn values (for shim-
    format messages); falls back to the primary spec."""
    for spec, v in cfg.members:
        if (v.n_elements == dv.n_elements and v.per_group == dv.per_group
                and v.take == dv.take and v.zone_groups == dv.zone_groups
                and v.slot_stride == dv.slot_stride
                and v.pages_per_element == dv.pages_per_element):
            return spec.name
    return cfg.spec.name


def _dyn_conflicts(cfg: E.EngineConfig, dv: _Dv) -> List[str]:
    """Policy/spec incompatibilities of one lane's effective dyn.
    ``make_dyn`` rejects these eagerly, but hand-stacked DynConfigs
    (or deserialized ones) can smuggle them past it."""
    out = []
    if (dv.alloc_policy == E.POLICY_SILENT
            and cfg.kind is ElementKind.FIXED):
        out.append("alloc_policy 'silent' on a FIXED-kind config: FIXED "
                   "elements are the whole static zone, there is no "
                   "block collection for the policy to size")
    if not 0 < dv.zone_pages <= cfg.zone_pages:
        out.append(f"zone_pages {dv.zone_pages} outside the static "
                   f"config's (0, {cfg.zone_pages}]")
    if (cfg.kind is ElementKind.FIXED
            and dv.zone_pages < cfg.zone_pages):
        out.append(f"zone_pages {dv.zone_pages} shrinks a FIXED lane "
                   f"(static capacity {cfg.zone_pages})")
    if not 0 < dv.n_zones <= cfg.n_zones:
        out.append(f"n_zones {dv.n_zones} outside the static config's "
                   f"(0, {cfg.n_zones}]")
    if not 0 < dv.max_active <= cfg.max_active:
        out.append(f"max_active {dv.max_active} outside the static "
                   f"config's (0, {cfg.max_active}]")
    if dv.wear_bound < 0:
        out.append(f"negative wear_bound {dv.wear_bound}")
    return out


class _Model:
    """Numpy mirror of the engine state machine for ONE lane (one
    program under one effective dyn).  Method structure shadows the
    engine's ``_alloc`` / ``_grow_silent`` / ``_write`` / ``_finish``
    / ``_reset`` transitions; every formula is a transliteration, so a
    semantic change engine-side shows up as an ok-mask mismatch in the
    differential fuzz tests rather than silently here."""

    def __init__(self, cfg: E.EngineConfig, dv: _Dv):
        self.cfg = cfg
        self.dv = dv
        n = cfg.n_elements
        self.ng = max(dv.n_elements // max(dv.per_group, 1), 1)
        self.wear = np.zeros(n, np.int64)
        self.avail = np.full(n, AVAIL_FREE, np.int64)
        self.pages = np.zeros(n, np.int64)
        self.ezone = np.full(n, -1, np.int64)
        self.zone_state = np.full(cfg.n_zones, E.ZONE_EMPTY, np.int64)
        self.zone_wp = np.zeros(cfg.n_zones, np.int64)
        self.zone_host_wp = np.zeros(cfg.n_zones, np.int64)
        self.zone_elems = np.full((cfg.n_zones, cfg.n_slots), -1, np.int64)
        self.zone_cols = np.zeros((cfg.n_zones, cfg.parallelism), np.int64)
        self.rr_next = 0
        self.n_active = 0
        self.host_pages = 0
        self.dummy_pages = 0
        # derived (value-level) geometry, exactly as the engine computes
        # it from the lane's DynConfig
        self.n_slots_eff = dv.zone_pages // dv.pages_per_element
        self.take_eff = int(np.clip(
            self.n_slots_eff // max(dv.slot_stride, 1), 1, dv.take))
        self.wear_bound_blocked: List[int] = []
        self.block_erases = 0
        self._idx = 0  # current op index (for report sites)

    # -- selection helpers (numpy twins of the engine's) --------------- #
    def _grids(self):
        n = self.cfg.n_elements
        w2 = self.wear[:n].reshape(self.cfg.n_groups, self.cfg.per_group)
        a2 = self.avail[:n].reshape(self.cfg.n_groups, self.cfg.per_group)
        return w2, a2

    def _rr_mask(self, start: int) -> np.ndarray:
        elig = np.zeros(self.cfg.n_groups, bool)
        for pos in range(min(self.dv.zone_groups, self.cfg.zone_groups)):
            elig[(start + pos) % self.ng] = True
        return elig

    def _take_lowest(self, w2, a2, elig, by_wear: bool, take_eff: int):
        cfg, dv = self.cfg, self.dv
        col = np.arange(cfg.per_group, dtype=np.int64)[None, :]
        free = ((a2 == AVAIL_FREE) | (a2 == AVAIL_INVALID))
        free = free & elig[:, None] & (col < dv.per_group)
        composite = w2 * cfg.per_group + col
        key = np.where(free,
                       composite if by_wear
                       else np.broadcast_to(col, w2.shape),
                       _BIG)
        cols = np.argsort(key, axis=1, kind="stable")[:, : cfg.take]
        kth = np.take_along_axis(key, cols, axis=1)[:, take_eff - 1]
        feasible = bool(np.all((kth < _BIG) | ~elig))
        sel_free = np.take_along_axis(free, cols, axis=1)
        sel_key = np.where(
            sel_free,
            np.take_along_axis(w2, cols, axis=1) * cfg.per_group + cols,
            _BIG)
        order = np.argsort(sel_key, axis=1, kind="stable")
        cols = np.take_along_axis(cols, order, axis=1)
        return cols, feasible

    def _cheapest_groups(self, w2, a2, take_eff: int) -> np.ndarray:
        cfg, dv = self.cfg, self.dv
        grow = np.arange(cfg.n_groups, dtype=np.int64)[:, None]
        col = np.arange(cfg.per_group, dtype=np.int64)[None, :]
        ok = ((a2 == AVAIL_FREE) | (a2 == AVAIL_INVALID))
        ok = ok & (grow < self.ng) & (col < dv.per_group)
        keyed = np.where(ok, w2.astype(np.float32), np.float32(np.inf))
        part = np.sort(keyed, axis=1)[:, : cfg.take]
        rank = np.arange(cfg.take)[None, :]
        cost = np.where(rank < take_eff, part,
                        np.float32(0.0)).sum(axis=1, dtype=np.float32)
        order = np.argsort(cost, kind="stable")[: cfg.zone_groups]
        picked = np.arange(cfg.zone_groups) < dv.zone_groups
        elig = np.zeros(cfg.n_groups, bool)
        elig[order[picked]] = True
        return elig

    def _wear_bounded(self, w2, a2, bound: Optional[int] = None):
        cfg, dv = self.cfg, self.dv
        bound = dv.wear_bound if bound is None else bound
        grow = np.arange(cfg.n_groups, dtype=np.int64)[:, None]
        col = np.arange(cfg.per_group, dtype=np.int64)[None, :]
        free = ((a2 == AVAIL_FREE) | (a2 == AVAIL_INVALID))
        free = free & (grow < self.ng) & (col < dv.per_group)
        min_wear = int(w2[free].min()) if free.any() else _BIG
        in_bound = (w2 - min_wear) <= bound
        return np.where(in_bound, a2, AVAIL_VALID)

    def _win(self, elig: np.ndarray) -> np.ndarray:
        idx = np.nonzero(elig)[0]
        out = np.zeros(self.cfg.zone_groups, np.int64)
        out[: min(len(idx), self.cfg.zone_groups)] = \
            idx[: self.cfg.zone_groups]
        return out

    def _written_per_slot(self, wp: int) -> np.ndarray:
        cfg, dv = self.cfg, self.dv
        P, ppb = cfg.parallelism, cfg.pages_per_block
        seg = np.arange(cfg.n_segments, dtype=np.int64)
        seg_pages = P * ppb
        w_seg = np.clip(wp - seg * seg_pages, 0, seg_pages)
        col = np.arange(P, dtype=np.int64)
        blk = np.clip((w_seg[:, None] - col[None, :] + P - 1) // P,
                      0, ppb)
        lpg = P // dv.zone_groups
        seg_span = dv.pages_per_element // (lpg * ppb)
        slot = ((seg[:, None] // seg_span) * dv.slot_stride
                + col[None, :] // lpg)
        out = np.zeros(cfg.n_slots, np.int64)
        keep = slot.reshape(-1) < cfg.n_slots  # masked scatters drop
        np.add.at(out, slot.reshape(-1)[keep], blk.reshape(-1)[keep])
        return out

    # -- transitions ---------------------------------------------------- #
    def _alloc(self, zone: int, hint: int) -> Tuple[bool, Optional[str],
                                                    Optional[str]]:
        """Mirror of engine ``_alloc``; applies effects when ok.
        Returns (ok, error class, shim message) for the failure case."""
        cfg, dv = self.cfg, self.dv
        limit_ok = self.n_active < dv.max_active

        if cfg.kind is ElementKind.FIXED:
            free = ((self.avail == AVAIL_FREE)
                    | (self.avail == AVAIL_INVALID))
            key = np.where(
                free,
                self.wear if dv.wear_aware
                else np.arange(cfg.n_elements, dtype=np.int64),
                _BIG)
            e = int(np.argmin(key))
            feasible = bool(free.any())
            band = e % cfg.n_groups
            cols_row = (band * cfg.parallelism
                        + np.arange(cfg.parallelism, dtype=np.int64))
            claimed_ids = np.asarray([e], np.int64)
            elems_row = np.full(cfg.n_slots, e, np.int64)
            rr_next = self.rr_next
        else:
            w2, a2 = self._grids()
            if dv.alloc_policy == E.POLICY_SILENT:
                per_rank = dv.pages_per_element * dv.zone_groups
                ranks_hint = -(-hint // max(per_rank, 1))
                take_s = int(np.clip(ranks_hint if hint > 0
                                     else self.take_eff,
                                     1, self.take_eff))
                a2b = self._wear_bounded(w2, a2)
                elig = self._cheapest_groups(w2, a2b, take_s)
                cols, feasible = self._take_lowest(w2, a2b, elig, True,
                                                   take_s)
                if not feasible and dv.wear_bound < _BIG and limit_ok:
                    # would the same claim succeed unbounded?  report
                    # the op as blocked by the wear bound, not capacity
                    elig_u = self._cheapest_groups(w2, a2, take_s)
                    _, feas_u = self._take_lowest(w2, a2, elig_u, True,
                                                  take_s)
                    if feas_u:
                        self.wear_bound_blocked.append(self._idx)
                rr_next = self.rr_next
                rank_lim = take_s
            else:
                elig = self._rr_mask(self.rr_next)
                cols, f1 = self._take_lowest(w2, a2, elig,
                                             dv.wear_aware,
                                             self.take_eff)
                feasible = f1
                if not f1:
                    elig = self._cheapest_groups(w2, a2, self.take_eff)
                    cols, f2 = self._take_lowest(w2, a2, elig, True,
                                                 self.take_eff)
                    feasible = f2
                rr_next = (self.rr_next + dv.zone_groups) % self.ng
                rank_lim = dv.take

            win = self._win(elig)
            eids = win[:, None] * cfg.per_group + cols[win]
            ranks = np.arange(cfg.take, dtype=np.int64)[None, :]
            cpos = np.arange(cfg.zone_groups, dtype=np.int64)[:, None]
            valid = cpos < dv.zone_groups
            raw_slots = ranks * dv.slot_stride + cpos
            claimed = (valid & (raw_slots < self.n_slots_eff)
                       & (ranks < rank_lim))
            elems_row = np.full(cfg.n_slots, -1, np.int64)
            elems_row[raw_slots[claimed]] = eids[claimed]
            claimed_ids = eids[claimed].reshape(-1)
            lpg = cfg.parallelism // dv.zone_groups
            c = np.arange(cfg.parallelism, dtype=np.int64)
            pos = np.clip(c // lpg, 0, cfg.zone_groups - 1)
            cols_row = win[pos] * lpg + c % lpg

        ok = bool(limit_ok and feasible)
        if ok:
            inv = self.avail[claimed_ids] == AVAIL_INVALID
            self.wear[claimed_ids] += inv.astype(np.int64)
            self.erase_count(int(inv.sum()))
            self.avail[claimed_ids] = AVAIL_ALLOCATED
            self.pages[claimed_ids] = 0
            self.ezone[claimed_ids] = zone
            self.zone_state[zone] = E.ZONE_OPEN
            self.zone_wp[zone] = 0
            self.zone_host_wp[zone] = 0
            self.zone_elems[zone] = elems_row
            self.zone_cols[zone] = cols_row
            self.n_active += 1
        if limit_ok:  # rr advance survives an infeasible attempt
            self.rr_next = rr_next
        if ok:
            return True, None, None
        if not limit_ok:
            return False, ERR_ACTIVE_LIMIT, (
                f"open/active zone limit ({dv.max_active}) reached")
        return False, ERR_ALLOC_INFEASIBLE, (
            f"no free storage elements for zone {zone} "
            f"({_spec_name(cfg, dv)})")

    def erase_count(self, n_invalid: int) -> None:
        self.block_erases += n_invalid * (
            self.dv.pages_per_element // self.cfg.pages_per_block)

    def _grow(self, zone: int, wp1: int, pred: bool) -> bool:
        """Mirror of engine ``_grow_silent``."""
        cfg, dv = self.cfg, self.dv
        if cfg.kind is ElementKind.FIXED:
            return True
        per_rank = dv.pages_per_element * dv.zone_groups
        need = int(np.clip(-(-wp1 // max(per_rank, 1)), 1, self.take_eff))
        have = int((self.zone_elems[zone] >= 0).sum()
                   // max(dv.zone_groups, 1))
        if not (pred and dv.alloc_policy == E.POLICY_SILENT
                and need > have):
            return True
        w2, a2 = self._grids()
        a2b = self._wear_bounded(w2, a2)
        lpg = cfg.parallelism // dv.zone_groups
        pos = np.arange(cfg.zone_groups, dtype=np.int64)
        win_g = self.zone_cols[zone][
            np.clip(pos * lpg, 0, cfg.parallelism - 1)] // lpg
        elig = np.zeros(cfg.n_groups, bool)
        elig[win_g[pos < dv.zone_groups]] = True
        k = need - have
        cols, fg = self._take_lowest(w2, a2b, elig, True, k)
        if not fg:
            if dv.wear_bound < _BIG:
                _, fu = self._take_lowest(w2, a2, elig, True, k)
                if fu:
                    self.wear_bound_blocked.append(self._idx)
            return False
        win = self._win(elig)
        eids = win[:, None] * cfg.per_group + cols[win]
        ranks = np.arange(cfg.take, dtype=np.int64)[None, :]
        cpos = np.arange(cfg.zone_groups, dtype=np.int64)[:, None]
        raw_slots = (have + ranks) * dv.slot_stride + cpos
        claimed = ((cpos < dv.zone_groups) & (ranks < k)
                   & (raw_slots < self.n_slots_eff))
        self.zone_elems[zone][raw_slots[claimed]] = eids[claimed]
        ids = eids[claimed].reshape(-1)
        inv = self.avail[ids] == AVAIL_INVALID
        self.wear[ids] += inv.astype(np.int64)
        self.erase_count(int(inv.sum()))
        self.avail[ids] = AVAIL_ALLOCATED
        self.pages[ids] = 0
        self.ezone[ids] = zone
        return True

    def _write(self, zone: int, n_pages: int, host: bool
               ) -> Tuple[bool, Optional[str], Optional[str]]:
        dv = self.dv
        zst0 = self.zone_state[zone]
        aok, aerr, amsg = True, None, None
        if zst0 == E.ZONE_EMPTY:
            # the implicit ALLOC persists even if the write then fails
            aok, aerr, amsg = self._alloc(zone, hint=n_pages)
        wp0 = int(self.zone_wp[zone])
        wp1 = wp0 + n_pages
        fits = wp1 <= dv.zone_pages
        gok = self._grow(zone, wp1,
                         bool(zst0 != E.ZONE_FULL and aok and fits))
        ok = bool(zst0 != E.ZONE_FULL and aok and fits and gok)
        if ok:
            written = self._written_per_slot(wp1)
            elems = self.zone_elems[zone]
            valid = elems >= 0
            touched = valid & (written > 0)
            self.pages[elems[valid]] = written[valid]
            self.avail[elems[touched]] = AVAIL_VALID
            self.zone_wp[zone] = wp1
            self.zone_host_wp[zone] += n_pages if host else 0
            seal = wp1 == dv.zone_pages
            self.zone_state[zone] = (E.ZONE_FULL if seal
                                     else E.ZONE_OPEN)
            self.n_active -= int(seal)
            self.host_pages += n_pages if host else 0
            self.dummy_pages += 0 if host else n_pages
            return True, None, None
        # classification follows the shim's raise order: FULL, then the
        # implicit allocation, then overflow, then on-the-fly growth
        if zst0 == E.ZONE_FULL:
            return False, ERR_FULL, f"write to FULL zone {zone}"
        if not aok:
            return False, aerr, amsg
        if not fits:
            return False, ERR_OVERFLOW, (
                f"zone {zone} overflow: wp={wp0} + {n_pages} "
                f"> {dv.zone_pages}")
        return False, ERR_ALLOC_INFEASIBLE, (
            f"no free storage elements for zone {zone} "
            f"({_spec_name(self.cfg, dv)})")

    def _finish(self, zone: int) -> int:
        """Mirror of engine ``_finish``; returns the dummy padding the
        seal emitted (0 for FULL/EMPTY zones).  Always ok."""
        dv = self.dv
        zst0 = self.zone_state[zone]
        if zst0 == E.ZONE_FULL:
            return 0
        is_open = zst0 == E.ZONE_OPEN
        wp = int(self.zone_wp[zone])
        written = self._written_per_slot(wp)
        elems = self.zone_elems[zone]
        valid = elems >= 0
        untouched = valid & (written == 0) & is_open
        touched = valid & (written > 0) & is_open
        cap = dv.pages_per_element
        pad = int(np.where(touched, cap - written, 0).sum())
        u = elems[untouched]
        t = elems[touched]
        self.avail[u] = AVAIL_FREE
        self.pages[u] = 0
        self.ezone[u] = -1
        self.avail[t] = AVAIL_VALID
        self.pages[t] = cap
        self.zone_elems[zone][untouched] = -1
        self.zone_state[zone] = E.ZONE_FULL
        self.dummy_pages += pad
        self.n_active -= int(is_open)
        return pad

    def _reset(self, zone: int) -> None:
        zst0 = self.zone_state[zone]
        elems = self.zone_elems[zone]
        ids = elems[elems >= 0]
        cur = self.avail[ids]
        self.avail[ids] = np.where(
            cur == AVAIL_VALID, AVAIL_INVALID,
            np.where(cur == AVAIL_ALLOCATED, AVAIL_FREE, cur))
        self.ezone[ids] = -1
        self.pages[ids] = 0
        self.zone_state[zone] = E.ZONE_EMPTY
        self.zone_wp[zone] = 0
        self.zone_host_wp[zone] = 0
        self.zone_elems[zone] = -1
        self.zone_cols[zone] = 0
        self.n_active -= int(zst0 == E.ZONE_OPEN)

    # -- op dispatch ---------------------------------------------------- #
    def apply(self, index: int, row: np.ndarray
              ) -> Tuple[OpVerdict, Optional[OpVerdict], int]:
        """One op row -> (verdict, advisory or None, dummy pad pages)."""
        self._idx = index
        op = int(row[0])
        opc = min(max(op, 0), E.OP_READ)  # the engine's clip
        zone = int(np.clip(row[1], 0, self.dv.n_zones - 1))
        n_pages = int(row[2])
        host = bool(int(row[3]) & E.F_HOST)
        err = msg = None
        advisory = None
        pad = 0
        ok = True
        if opc == E.OP_ALLOC:
            if self.zone_state[zone] == E.ZONE_EMPTY:
                ok, err, msg = self._alloc(zone, hint=n_pages)
            # non-EMPTY: no-op, ok (and no round-robin consumption)
        elif opc == E.OP_WRITE:
            ok, err, msg = self._write(zone, n_pages, host)
        elif opc == E.OP_FINISH:
            pad = self._finish(zone)
        elif opc == E.OP_RESET:
            self._reset(zone)
        elif opc == E.OP_READ:
            if self.zone_state[zone] == E.ZONE_EMPTY:
                advisory = OpVerdict(
                    index, op, zone, True, ERR_UNMAPPED_READ,
                    f"read from unmapped zone {zone}")
        return (OpVerdict(index, op, zone, ok, err, msg), advisory, pad)


def verify_program(cfg: E.EngineConfig, program: np.ndarray,
                   dyn: Optional[E.DynConfig] = None,
                   lane: Optional[int] = None) -> ProgramReport:
    """Walk one ``(n_ops, >=4)`` program through the symbolic device
    model and predict every op's verdict without dispatching.

    ``dyn`` / ``lane`` select the lane's effective geometry exactly as
    the engine would (``lane`` indexes a stacked DynConfig).  The
    predicted ``report.ok`` is bit-identical to ``run_program``'s
    ``trace.ok`` -- the differential guarantee the fuzz tests enforce.
    """
    dv = _Dv(E.dyn_values(cfg, dyn, lane))
    program = np.asarray(program)
    if program.ndim != 2 or program.shape[1] < 4:
        raise ValueError(f"want an (n_ops, >=4) program, got "
                         f"{program.shape}")
    conflicts = _dyn_conflicts(cfg, dv)
    model = _Model(cfg, dv)
    verdicts: List[OpVerdict] = []
    advisories: List[OpVerdict] = []
    dummy_sites: List[Tuple[int, int, int]] = []
    peak_active = 0
    for i, row in enumerate(program):
        verdict, advisory, pad = model.apply(i, row)
        verdicts.append(verdict)
        if advisory is not None:
            advisories.append(advisory)
        if pad > 0:
            dummy_sites.append((i, verdict.zone, pad))
        if (verdict.ok and verdict.op == E.OP_WRITE
                and not (int(row[3]) & E.F_HOST)):
            dummy_sites.append((i, verdict.zone, int(row[2])))
        peak_active = max(peak_active, model.n_active)
    return ProgramReport(
        ok=np.asarray([v.ok for v in verdicts], bool),
        verdicts=verdicts,
        advisories=advisories,
        dummy_sites=dummy_sites,
        host_pages=model.host_pages,
        dummy_pages=model.dummy_pages,
        peak_active=peak_active,
        wear_bound_blocked=sorted(set(model.wear_bound_blocked)),
        conflicts=conflicts,
    )


def verify_programs(cfg: E.EngineConfig, programs: np.ndarray,
                    dyn: Optional[E.DynConfig] = None
                    ) -> List[ProgramReport]:
    """Per-lane :func:`verify_program` over an ``(L, n_ops, >=4)``
    batch (``dyn`` stacked per lane, as ``run_programs`` consumes)."""
    programs = np.asarray(programs)
    if programs.ndim != 3:
        raise ValueError(f"want (L, n_ops, >=4) programs, got "
                         f"{programs.shape}")
    stacked = dyn is not None and dyn.zone_pages.ndim > 0
    return [verify_program(cfg, programs[k], dyn,
                           lane=k if stacked else None)
            for k in range(programs.shape[0])]


def explain_op(cfg: E.EngineConfig, program: np.ndarray, index: int,
               dyn: Optional[E.DynConfig] = None,
               lane: Optional[int] = None) -> OpVerdict:
    """The predicted verdict of one op of a program (walks the prefix
    up to and including ``index``) -- what ``assert_all_ok`` uses to
    name the error class of the first failing op."""
    report = verify_program(cfg, np.asarray(program)[: index + 1],
                            dyn, lane)
    return report.verdicts[index]


# --------------------------------------------------------------------- #
# malformed-row pre-checks (before any dispatch)
# --------------------------------------------------------------------- #
def validate_rows(programs: np.ndarray, *,
                  n_tenants: Optional[int] = None,
                  parity_tenant: Optional[int] = None,
                  where: str = "program") -> np.ndarray:
    """Reject malformed width-5 rows with a clear ``ValueError`` before
    they reach a batched scan (where a bad op code aliases to NOP/READ,
    a negative page count walks the write pointer backwards, and an
    out-of-range tenant tag silently skews the per-class rollups).

    Accepts ``(n_ops, w)`` or ``(L, n_ops, w)`` with ``w >= 4``;
    returns the validated int32 array.  ``n_tenants`` (with the
    optional ``parity_tenant``, default ``n_tenants``) additionally
    bounds the tenant column of width-5 rows.  NOP rows are exempt from
    the page/tenant bounds -- they are padding.
    """
    arr = np.asarray(programs)
    if arr.ndim == 2:
        batch = arr[None]
    elif arr.ndim == 3:
        batch = arr
    else:
        raise ValueError(f"{where}: want (n_ops, >=4) or (L, n_ops, >=4) "
                         f"rows, got shape {arr.shape}")
    if batch.shape[-1] < 4:
        raise ValueError(f"{where}: rows need >= 4 columns "
                         f"(op, zone, n_pages, flags), got "
                         f"{batch.shape[-1]}")

    def _first(mask) -> Tuple[int, int]:
        lane, idx = np.argwhere(mask)[0]
        return int(lane), int(idx)

    op = batch[:, :, 0]
    real = op != E.OP_NOP
    bad_op = (op < E.OP_NOP) | (op > E.OP_READ)
    if bad_op.any():
        lane, idx = _first(bad_op)
        raise ValueError(
            f"{where}: lane {lane} row {idx}: op code "
            f"{int(op[lane, idx])} not in [{E.OP_NOP}, {E.OP_READ}]")
    bad_zone = real & (batch[:, :, 1] < 0)
    if bad_zone.any():
        lane, idx = _first(bad_zone)
        raise ValueError(
            f"{where}: lane {lane} row {idx}: negative zone "
            f"{int(batch[lane, idx, 1])}")
    bad_pages = real & (batch[:, :, 2] < 0)
    if bad_pages.any():
        lane, idx = _first(bad_pages)
        raise ValueError(
            f"{where}: lane {lane} row {idx}: negative page count "
            f"{int(batch[lane, idx, 2])}")
    if n_tenants is not None and batch.shape[-1] > 4:
        hi = n_tenants if parity_tenant is None else max(
            n_tenants - 1, parity_tenant)
        tenant = batch[:, :, 4]
        bad_t = real & ((tenant < 0) | (tenant > hi))
        if bad_t.any():
            lane, idx = _first(bad_t)
            raise ValueError(
                f"{where}: lane {lane} row {idx}: tenant "
                f"{int(tenant[lane, idx])} outside [0, {hi}] "
                f"({n_tenants} tenant classes"
                + (f", parity {parity_tenant})" if parity_tenant
                   is not None else ")"))
    return arr.astype(np.int32) if arr.dtype != np.int32 else arr
