"""The emulated ZNS device: a thin stateful shim over the port's engine.

The port of ``repro.core.device``.  The device's *data plane*
(wear/avail/pages, the zone mapping table, counters) lives in a
:class:`repro_torch.core.engine.DeviceState` of int32 tensors on the
shim's device, and every command runs one pure transition
(:func:`repro_torch.core.engine.apply_op`); this class keeps a host-side
control-plane mirror (zone states, write pointers, Python-int counters)
so it raises the reference's ``RuntimeError``\\ s eagerly, with the same
strings, serves :class:`ZoneInfo` views to hosts like ``ZoneFS``, and
builds ``trace=True`` IO streams without reading the device back.

One command is one op step of the engine (every branch, each lane's
opcode selected), so on a card the shim is launch-bound: application
traffic goes through a recorded program and one batched dispatch
instead (:mod:`repro_torch.storage.compile`).

Availability codes: 0 free, 1 allocated-empty, 2 valid, 3 invalid.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import engine as zengine
from repro_torch.core import zns
from repro_torch.core.alloc_exact import AVAIL_INVALID
from repro_torch.core.elements import ElementLayout, ElementSpec
from repro_torch.core.geometry import FlashGeometry, ZoneGeometry


class ZoneState(enum.Enum):
    EMPTY = 0
    OPEN = 1
    FULL = 2


@dataclasses.dataclass
class ZoneInfo:
    state: ZoneState = ZoneState.EMPTY
    wp: int = 0                                  # pages written (host+dummy)
    host_wp: int = 0                             # pages written by host
    elements: Optional[np.ndarray] = None        # slot -> element id (-1 = released)
    column_luns: Optional[np.ndarray] = None     # zone column -> LUN id


@dataclasses.dataclass
class IOTrace:
    """Per-page (op, lun, channel) streams for the timing model."""
    luns: np.ndarray
    channels: np.ndarray
    op: str  # 'write' | 'read' | 'erase'


class ZNSDevice:
    """One emulated ZNS SSD with a pluggable zone-allocation granularity,
    its state on ``device``.

    A stateful facade: commands are validated against the host-side
    mirror, executed as pure engine transitions on ``self.state``, and
    the mirror is refreshed from the returned trace.  ``alloc_impl`` is
    kept for the reference's signature; the engine's ALLOC always runs
    the ``zns_alloc`` selection (the kernel on a card, its plain version
    on the CPU).
    """

    def __init__(self,
                 flash: FlashGeometry,
                 zone_geom: ZoneGeometry,
                 spec: ElementSpec,
                 *,
                 max_active: int = 14,
                 alloc_impl: str = "kernel",
                 wear_aware: Optional[bool] = None,
                 device="cuda"):
        self.flash = flash
        self.zone_geom = zone_geom
        self.spec = spec
        self.max_active = max_active
        self.alloc_impl = alloc_impl

        self.engine = zengine.ZoneEngine(
            flash, zone_geom, spec, max_active=max_active,
            wear_aware=wear_aware, device=device)
        self.device = self.engine.device
        cfg = self.engine.cfg
        self.wear_aware = cfg.wear_aware
        self.layout: ElementLayout = self.engine.layout
        self.elems_per_zone = cfg.take * cfg.zone_groups
        self.zone_groups = cfg.zone_groups
        self.take_per_group = cfg.take
        self.per_group = cfg.per_group
        self.zone_pages = cfg.zone_pages
        self.n_zones = cfg.n_zones

        self.state: zengine.DeviceState = self.engine.init_state()
        self.zones: Dict[int, ZoneInfo] = {
            z: ZoneInfo() for z in range(self.n_zones)}

        # counters (host-side mirrors of the state's scalars, as Python
        # ints so long workloads can't overflow int32)
        self.host_pages = 0
        self.dummy_pages = 0
        self.block_erases = 0
        self.alloc_calls = 0
        self.alloc_seconds = 0.0
        self.alloc_latencies_us: List[float] = []

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
        return sum(1 for z in self.zones.values()
                   if z.state is ZoneState.OPEN)

    # element-state views (numpy copies of the device's data plane)
    def _elem(self, t) -> np.ndarray:
        return t[: self.layout.n_elements].cpu().numpy()

    @property
    def elem_wear(self) -> np.ndarray:
        return self._elem(self.state.elem_wear).astype(np.int64)

    @property
    def elem_avail(self) -> np.ndarray:
        return self._elem(self.state.elem_avail).astype(np.int32)

    @property
    def elem_pages(self) -> np.ndarray:
        return self._elem(self.state.elem_pages).astype(np.int64)

    @property
    def elem_zone(self) -> np.ndarray:
        return self._elem(self.state.elem_zone).astype(np.int32)

    def block_wear(self) -> np.ndarray:
        """Per erase-block wear (all blocks of an element share wear)."""
        return self.engine.block_wear(self.state)

    def pending_erases(self) -> int:
        """Block erases implied by a=3 elements not yet re-allocated."""
        inv = self.elem_avail == AVAIL_INVALID
        return int(inv.sum()) * self.layout.blocks_per_element

    # ------------------------------------------------------------------ #
    # engine dispatch + mirror upkeep
    # ------------------------------------------------------------------ #
    def _dispatch(self, op: int, zone_id: int, n_pages: int = 0,
                  host: bool = True) -> zengine.OpTrace:
        self.state, tr = self.engine.apply(
            self.state,
            (op, zone_id, n_pages, zengine.F_HOST if host else 0))
        return tr

    def _allocate_zone(self, zone_id: int) -> None:
        if self.n_active >= self.max_active:
            raise RuntimeError(
                f"open/active zone limit ({self.max_active}) reached")
        t0 = time.perf_counter()
        tr = self._dispatch(zengine.OP_ALLOC, zone_id)
        ok = bool(tr.ok)  # waits for the transition
        dt = time.perf_counter() - t0
        if not ok:
            raise RuntimeError("no free storage elements for zone "
                               f"{zone_id} ({self.spec.name})")
        self.alloc_calls += 1
        self.alloc_seconds += dt
        self.alloc_latencies_us.append(dt * 1e6)
        self.block_erases += int(tr.erase_delta)
        info = self.zones[zone_id]
        info.elements = tr.elems.cpu().numpy().astype(np.int64)
        info.column_luns = tr.cols.cpu().numpy().astype(np.int64)
        info.state = ZoneState.OPEN
        info.wp = 0
        info.host_wp = 0

    def warmup_alloc(self) -> None:
        """Run every engine transition once on a scratch state, so timed
        allocation samples exclude the kernels' first build and load
        (paper Table 4 methodology)."""
        self.engine.warmup()

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
        self._dispatch(zengine.OP_WRITE, zone_id, n_pages, host=host)
        start = info.wp
        info.wp += n_pages
        if host:
            info.host_wp += n_pages
            self.host_pages += n_pages
        else:
            self.dummy_pages += n_pages
        if info.wp == self.zone_pages:
            info.state = ZoneState.FULL
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
            self._dispatch(zengine.OP_FINISH, zone_id)
            info.state = ZoneState.FULL  # finishing an empty zone is a no-op
            return None
        wp_at_finish = info.wp
        tr = self._dispatch(zengine.OP_FINISH, zone_id)
        self.dummy_pages += int(tr.dummy_delta)
        info.elements = tr.elems.cpu().numpy().astype(np.int64)
        info.state = ZoneState.FULL
        if trace:
            written = zns.element_pages(
                wp_at_finish, self.spec, self.zone_geom.parallelism,
                self.zone_geom.n_segments, self.flash.pages_per_block)
            padded_slots = np.nonzero(
                (info.elements >= 0) & (written > 0)
                & (written < self.layout.pages_per_element))[0]
            luns, chans = zns.pad_stream(
                wp_at_finish, self.zone_pages, self.spec,
                self.zone_geom.parallelism, self.flash.pages_per_block,
                info.column_luns, padded_slots.astype(np.int64),
                self.flash.n_channels)
            return IOTrace(luns, chans, "write")
        return None

    def zone_reset(self, zone_id: int) -> None:
        """Partial + asynchronous RESET (paper §5): invalidate metadata,
        defer physical erase to re-allocation."""
        self._dispatch(zengine.OP_RESET, zone_id)
        self.zones[zone_id] = ZoneInfo()

    def median_alloc_latency_us(self) -> float:
        if not self.alloc_latencies_us:
            return 0.0
        return float(np.median(self.alloc_latencies_us))
