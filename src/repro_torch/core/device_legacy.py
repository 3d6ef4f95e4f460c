"""The original stateful-Python ZNS device (differential oracle), PyTorch
port.

The port of ``repro.core.device_legacy``: the pre-engine device, one numpy
state update per command, kept as the oracle of the engine and its shim
(the differential tests replay random op sequences through all three and
require bit-identical state) and as the per-op-loop baseline the
engine-vs-legacy comparators time.  Its wear-aware ALLOC goes through
:func:`repro_torch.core.allocator.allocate`, so on a card every such
allocation launches the ``zns_alloc`` row kernel (two when the round-robin
window is exhausted and the cheapest groups are tried); FIXED and
wear-oblivious selection stay numpy, as in the reference.  Wear stays
int64 on the host.  New code should use
:class:`repro_torch.core.device.ZNSDevice` (the engine-backed shim).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import zns
from repro_torch.core.alloc_exact import (AVAIL_ALLOCATED, AVAIL_FREE,
                                          AVAIL_INVALID, AVAIL_VALID)
from repro_torch.core.allocator import RoundRobin, allocate, eligible_mask
from repro_torch.core.device import IOTrace, ZoneInfo, ZoneState
from repro_torch.core.elements import (ElementKind, ElementLayout,
                                       ElementSpec, build_layout,
                                       elements_per_zone, groups_per_zone)
from repro_torch.core.geometry import FlashGeometry, ZoneGeometry


class LegacyZNSDevice:
    """One emulated ZNS SSD, stateful-Python edition (pre-engine); its
    wear-aware selection runs on ``device``."""

    def __init__(self,
                 flash: FlashGeometry,
                 zone_geom: ZoneGeometry,
                 spec: ElementSpec,
                 *,
                 max_active: int = 14,
                 wear_aware: Optional[bool] = None,
                 device="cuda"):
        self.flash = flash
        self.zone_geom = zone_geom
        self.spec = spec
        self.max_active = max_active
        # where the wear-aware selection runs (the zns_alloc row kernel on
        # a card, its plain version on the CPU); the state stays numpy
        self.device = resolve_device(device)
        # the ConfZNS++ fixed baseline ignores wear (paper §6.2)
        self.wear_aware = (spec.kind is not ElementKind.FIXED
                           if wear_aware is None else wear_aware)

        self.layout: ElementLayout = build_layout(flash, spec, zone_geom)
        self.elems_per_zone = elements_per_zone(self.layout, zone_geom)
        self.zone_groups = groups_per_zone(self.layout, zone_geom)
        self.take_per_group = self.elems_per_zone // self.zone_groups
        self.zone_pages = zone_geom.zone_pages(flash)
        self.n_zones = flash.n_blocks // zone_geom.blocks_per_zone

        n = self.layout.n_elements
        self.per_group = n // self.layout.n_groups
        self.elem_wear = np.zeros(n, dtype=np.int64)
        self.elem_avail = np.full(n, AVAIL_FREE, dtype=np.int32)
        self.elem_pages = np.zeros(n, dtype=np.int64)
        self.elem_zone = np.full(n, -1, dtype=np.int32)
        self.zones: Dict[int, ZoneInfo] = {z: ZoneInfo() for z in range(self.n_zones)}
        self.rr = RoundRobin(self.layout.n_groups, self.zone_groups)

        # counters
        self.host_pages = 0
        self.dummy_pages = 0
        self.block_erases = 0
        self.alloc_calls = 0
        self.alloc_seconds = 0.0
        self.alloc_latencies_us: List[float] = []
        # allocate() calls (each one zns_alloc row launch on a card),
        # the fallback's and warmup_alloc's included
        self.allocate_calls = 0

    # ------------------------------------------------------------------ #
    # metrics
    # ------------------------------------------------------------------ #
    @property
    def dlwa(self) -> float:
        if self.host_pages == 0:
            return 1.0
        return (self.host_pages + self.dummy_pages) / self.host_pages

    @property
    def n_active(self) -> int:
        return sum(1 for z in self.zones.values() if z.state is ZoneState.OPEN)

    def block_wear(self) -> np.ndarray:
        """Per erase-block wear (all blocks of an element share wear)."""
        wear = np.zeros(self.flash.n_blocks, dtype=np.int64)
        wear[self.layout.blocks.reshape(-1)] = np.repeat(
            self.elem_wear, self.layout.blocks_per_element)
        return wear

    def pending_erases(self) -> int:
        """Block erases implied by a=3 elements not yet re-allocated."""
        inv = self.elem_avail == AVAIL_INVALID
        return int(inv.sum()) * self.layout.blocks_per_element

    # ------------------------------------------------------------------ #
    # allocation (paper §5)
    # ------------------------------------------------------------------ #
    def _wear2d(self) -> np.ndarray:
        return self.elem_wear.reshape(self.layout.n_groups, self.per_group)

    def _avail2d(self) -> np.ndarray:
        return self.elem_avail.reshape(self.layout.n_groups, self.per_group)

    def _allocate_zone(self, zone_id: int) -> None:
        info = self.zones[zone_id]
        if self.n_active >= self.max_active:
            raise RuntimeError(
                f"open/active zone limit ({self.max_active}) reached")

        t0 = time.perf_counter()
        if self.spec.kind is ElementKind.FIXED:
            sel_ids = self._allocate_fixed()  # shape (1,): one static zone
            window_groups = np.asarray(
                [self.layout.group[int(sel_ids[0])]], dtype=np.int64)
        else:
            eligible = self.rr.next_window()
            if self.wear_aware:
                sel, feasible = self._select(self._wear2d(),
                                             self._avail2d(), eligible)
            else:
                sel, feasible = self._first_available(eligible)
            if not feasible:
                # round-robin window exhausted: activate the cheapest
                # feasible groups instead (ILP with L_min = zone_groups --
                # optimal group choice = smallest sum of take-lowest wears)
                eligible = self._cheapest_groups()
                sel, feasible = self._select(self._wear2d(),
                                             self._avail2d(), eligible)
            if not feasible:
                raise RuntimeError("no free storage elements for zone "
                                   f"{zone_id} ({self.spec.name})")
            sel2d = sel.reshape(self.layout.n_groups, self.per_group)
            window_groups = np.nonzero(sel2d.any(axis=1))[0]
            sel_ids = self._arrange(sel2d, window_groups)
        self.alloc_calls += 1
        dt = time.perf_counter() - t0
        self.alloc_seconds += dt
        self.alloc_latencies_us.append(dt * 1e6)

        flat = sel_ids.reshape(-1)
        # deferred physical erase of invalid elements (paper §5 RESET)
        invalid = flat[self.elem_avail[flat] == AVAIL_INVALID]
        if invalid.size:
            self.elem_wear[invalid] += 1
            self.block_erases += invalid.size * self.layout.blocks_per_element
        self.elem_avail[flat] = AVAIL_ALLOCATED
        self.elem_pages[flat] = 0
        self.elem_zone[flat] = zone_id

        info.elements = sel_ids
        info.column_luns = self._column_luns(window_groups)
        info.state = ZoneState.OPEN
        info.wp = 0
        info.host_wp = 0

    def _select(self, wear2d: np.ndarray, avail2d: np.ndarray,
                eligible: np.ndarray) -> Tuple[np.ndarray, bool]:
        """The balanced-ILP selection on the device (one ``zns_alloc``
        row launch on a card)."""
        self.allocate_calls += 1
        return allocate(wear2d, avail2d, eligible, self.take_per_group,
                        device=self.device)

    def _cheapest_groups(self) -> np.ndarray:
        """Pick the ``zone_groups`` groups minimizing the sum of their
        ``take`` lowest available wears (exact for the balanced ILP)."""
        wear2d = self._wear2d().astype(np.float64)
        avail2d = self._avail2d()
        ok = (avail2d == AVAIL_FREE) | (avail2d == AVAIL_INVALID)
        keyed = np.where(ok, wear2d, np.inf)
        part = np.sort(keyed, axis=1)[:, : self.take_per_group]
        cost = part.sum(axis=1)  # inf when < take available
        order = np.argsort(cost, kind="stable")[: self.zone_groups]
        mask = np.zeros(self.layout.n_groups, dtype=bool)
        mask[order] = True
        return mask

    def _first_available(self, eligible: np.ndarray
                         ) -> Tuple[np.ndarray, bool]:
        """Wear-oblivious first-fit (baseline allocation policy)."""
        avail2d = self._avail2d()
        ok = ((avail2d == AVAIL_FREE) | (avail2d == AVAIL_INVALID))
        ok &= eligible[:, None]
        idx = np.argsort(~ok, axis=1, kind="stable")  # available first
        ranks = np.argsort(idx, axis=1, kind="stable")
        sel = ok & (ranks < self.take_per_group)
        feasible = bool(np.all(np.where(
            eligible, ok.sum(axis=1) >= self.take_per_group, True)))
        return sel, feasible

    def _allocate_fixed(self) -> np.ndarray:
        ok = np.isin(self.elem_avail, (AVAIL_FREE, AVAIL_INVALID))
        ids = np.nonzero(ok)[0]
        if not ids.size:
            raise RuntimeError("no free physical zone (fixed mapping)")
        if self.wear_aware:
            e = ids[np.argmin(self.elem_wear[ids])]
        else:
            e = ids[0]
        return np.asarray([e], dtype=np.int64)

    def _arrange(self, sel2d: np.ndarray, window_groups: np.ndarray
                 ) -> np.ndarray:
        """Order selected elements into zone slots (see zns.py ordering).

        Returns (n_slots,) element ids; within each group, selected
        elements are ranked by wear and assigned to segments bottom-up.
        """
        n_slots = zns.n_slots(self.spec, self.zone_geom.parallelism,
                              self.zone_geom.n_segments)
        out = np.full(n_slots, -1, dtype=np.int64)
        for c, g in enumerate(window_groups):
            cols = np.nonzero(sel2d[g])[0]
            ids = g * self.per_group + cols
            order = np.argsort(self.elem_wear[ids], kind="stable")
            for rank, eid in enumerate(ids[order]):
                slot = zns.slot_of_group_rank(
                    self.spec, self.zone_geom.parallelism,
                    self.zone_geom.n_segments, c, rank)
                out[slot] = eid
        assert (out >= 0).all(), "zone slot assignment incomplete"
        return out

    def _column_luns(self, window_groups: np.ndarray) -> np.ndarray:
        """Zone column -> LUN id, from the groups that won the allocation.

        FIXED-zone column convention: a static physical zone is pinned to
        ``parallelism`` *adjacent* LUNs starting at ``group * parallelism``
        (its erase blocks are laid out contiguously, so the winning group
        index alone determines every column).  Dynamic elements instead
        contribute ``luns_per_group`` columns per winning group.
        """
        s = self.layout.luns_per_group
        luns = []
        for g in window_groups:
            if self.spec.kind is ElementKind.FIXED:
                base = int(g) * self.zone_geom.parallelism
                luns.extend(range(base, base + self.zone_geom.parallelism))
            else:
                luns.extend(range(int(g) * s, int(g) * s + s))
        return np.asarray(luns[: self.zone_geom.parallelism], dtype=np.int64)

    # ------------------------------------------------------------------ #
    # ZNS commands
    # ------------------------------------------------------------------ #
    def zone_write(self, zone_id: int, n_pages: int,
                   *, host: bool = True, trace: bool = False
                   ) -> Optional[IOTrace]:
        info = self.zones[zone_id]
        if info.state is ZoneState.FULL:
            raise RuntimeError(f"write to FULL zone {zone_id}")
        if info.state is ZoneState.EMPTY:
            self._allocate_zone(zone_id)
        if info.wp + n_pages > self.zone_pages:
            raise RuntimeError(
                f"zone {zone_id} overflow: wp={info.wp} + {n_pages} "
                f"> {self.zone_pages}")
        start = info.wp
        info.wp += n_pages
        if host:
            info.host_wp += n_pages
            self.host_pages += n_pages
        else:
            self.dummy_pages += n_pages
        self._refresh_element_pages(info)
        if info.wp == self.zone_pages:
            self._seal(info)
        if trace:
            luns, chans = zns.page_stream(
                start, n_pages, self.zone_geom.parallelism,
                self.flash.pages_per_block, info.column_luns,
                self.flash.n_channels)
            return IOTrace(luns, chans, "write")
        return None

    def zone_read(self, zone_id: int, pages: np.ndarray) -> IOTrace:
        info = self.zones[zone_id]
        if info.column_luns is None:
            raise RuntimeError(f"read from unmapped zone {zone_id}")
        luns, chans = zns.read_stream(
            pages, self.zone_geom.parallelism, self.flash.pages_per_block,
            info.column_luns, self.flash.n_channels)
        return IOTrace(luns, chans, "read")

    def zone_finish(self, zone_id: int, *, trace: bool = False
                    ) -> Optional[IOTrace]:
        """FINISH: pad partially-written elements, release untouched ones.

        Returns the dummy-write IOTrace when ``trace`` (for interference
        simulation).
        """
        info = self.zones[zone_id]
        if info.state is ZoneState.FULL:
            return None
        if info.state is ZoneState.EMPTY:
            info.state = ZoneState.FULL  # finishing an empty zone is a no-op
            return None
        written = zns.element_pages(
            info.wp, self.spec, self.zone_geom.parallelism,
            self.zone_geom.n_segments, self.flash.pages_per_block)
        cap = self.layout.pages_per_element
        elems = info.elements
        padded_slots: List[int] = []

        for slot, eid in enumerate(elems):
            if eid < 0:
                continue
            w = int(written[slot])
            if w == 0:
                # untouched: release back to the pool (a=1 -> a=0)
                self.elem_avail[eid] = AVAIL_FREE
                self.elem_zone[eid] = -1
                self.elem_pages[eid] = 0
                info.elements[slot] = -1
            else:
                pad = cap - w
                if pad:
                    self.dummy_pages += pad
                    padded_slots.append(slot)
                self.elem_pages[eid] = cap
                self.elem_avail[eid] = AVAIL_VALID
        wp_at_finish = info.wp
        self._seal(info)
        if trace:
            luns, chans = zns.pad_stream(
                wp_at_finish, self.zone_pages, self.spec,
                self.zone_geom.parallelism, self.flash.pages_per_block,
                info.column_luns, np.asarray(padded_slots, dtype=np.int64),
                self.flash.n_channels)
            return IOTrace(luns, chans, "write")
        return None

    def zone_reset(self, zone_id: int) -> None:
        """Partial + asynchronous RESET (paper §5): invalidate metadata,
        defer physical erase to re-allocation."""
        info = self.zones[zone_id]
        if info.elements is not None:
            for eid in info.elements:
                if eid < 0:
                    continue
                if self.elem_avail[eid] == AVAIL_VALID:
                    self.elem_avail[eid] = AVAIL_INVALID
                elif self.elem_avail[eid] == AVAIL_ALLOCATED:
                    self.elem_avail[eid] = AVAIL_FREE
                self.elem_zone[eid] = -1
                self.elem_pages[eid] = 0
        self.zones[zone_id] = ZoneInfo()

    # ------------------------------------------------------------------ #
    # helpers
    # ------------------------------------------------------------------ #
    def _seal(self, info: ZoneInfo) -> None:
        info.state = ZoneState.FULL

    def _refresh_element_pages(self, info: ZoneInfo) -> None:
        written = zns.element_pages(
            info.wp, self.spec, self.zone_geom.parallelism,
            self.zone_geom.n_segments, self.flash.pages_per_block)
        elems = info.elements
        valid = elems >= 0
        self.elem_pages[elems[valid]] = written[valid]
        # first host byte into an element transitions it a=1 -> a=2? The
        # paper marks written elements valid at WRITE time (§5 READ/WRITE).
        touched = valid & (written > 0)
        self.elem_avail[elems[touched]] = AVAIL_VALID

    def warmup_alloc(self) -> None:
        """Run the allocator's paths (primary window + cheapest-groups
        fallback) on copies, so timed samples exclude the kernel's first
        build and load and its launch plan (paper Table 4
        methodology)."""
        if self.spec.kind is ElementKind.FIXED:
            return  # pure-numpy selection: no kernel behind it
        eligible = eligible_mask(self.layout.n_groups, 0, self.zone_groups)
        self._select(self._wear2d().copy(), self._avail2d().copy(),
                     eligible)
        self._select(self._wear2d().copy(), self._avail2d().copy(),
                     self._cheapest_groups())

    def median_alloc_latency_us(self) -> float:
        if not self.alloc_latencies_us:
            return 0.0
        return float(np.median(self.alloc_latencies_us))
