"""ZenFS-like zoned filesystem (paper §6.1 "RocksDB with ZenFS"), the
port of ``repro.storage.zonefs``.

Semantics reproduced from the paper + ZenFS:

* Files carry *write-lifetime hints*; a new file prefers an open zone with
  a matching hint.  A zone admits one concurrent writer at a time (zone
  appends are strictly sequential), so concurrent flush/compaction jobs
  each need their own zone -- this is what pressures the device's
  open/active zone limit.
* When the limit binds, ZenFS picks a FINISH victim whose occupancy is at
  least ``finish_threshold``; if none qualifies, it *relaxes lifetime
  matching* and mixes the file into a zone holding other-lifetime data,
  which delays that zone's reclamation and inflates space amplification
  (paper Fig. 1 / 7b).
* A zone is RESET (reclaimed) as soon as every byte in it is invalid.

SA is tracked per :class:`repro_torch.core.metrics.SATracker`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.backend import ZoneBackend, check_backend
from repro_torch.core.device import ZoneState
from repro_torch.core.metrics import SATracker


@dataclasses.dataclass
class _Extent:
    zone: int
    pages: int
    valid: bool = True


@dataclasses.dataclass
class _File:
    file_id: int
    lifetime: int
    extents: List[_Extent] = dataclasses.field(default_factory=list)
    open: bool = False

    @property
    def pages(self) -> int:
        return sum(e.pages for e in self.extents)


@dataclasses.dataclass
class FSStats:
    host_pages: int = 0
    relaxed_placements: int = 0
    finishes: int = 0
    resets: int = 0
    failed_allocs: int = 0


@dataclasses.dataclass
class _Session:
    file: _File
    zone: Optional[int] = None
    expected_pages: int = 0  # remaining pages the writer still intends to write


class ZoneFS:
    """Lifetime-aware zoned filesystem over any :class:`ZoneBackend`
    (a bare :class:`repro_torch.core.device.ZNSDevice` or a multi-device
    :class:`repro_torch.array.ZNSArray`) with concurrent file sessions."""

    def __init__(self, dev: ZoneBackend, *, finish_threshold: float = 0.1):
        """``finish_threshold`` is expressed as *occupancy*: a victim zone
        may be FINISHed only if wp/capacity >= threshold (paper §6.2)."""
        check_backend(dev)
        self.dev = dev
        self.finish_threshold = finish_threshold
        self.max_open = dev.max_active
        self.files: Dict[int, _File] = {}
        self.sessions: Dict[int, _Session] = {}
        self.zone_lifetime: Dict[int, int] = {}
        self.zone_valid_pages: Dict[int, int] = {}
        self.zone_total_pages: Dict[int, int] = {}
        self.zone_busy: Dict[int, bool] = {}
        self.sa = SATracker()
        self.stats = FSStats()

    # ------------------------------------------------------------------ #
    def _open_zones(self) -> List[int]:
        return [z for z, info in self.dev.zones.items()
                if info.state is ZoneState.OPEN]

    def _free_zones(self) -> List[int]:
        return [z for z, info in self.dev.zones.items()
                if info.state is ZoneState.EMPTY]

    def _zone_room(self, z: int) -> int:
        return self.dev.zone_pages - self.dev.zones[z].wp

    def _fresh_zone(self, lifetime: int) -> Optional[int]:
        free = self._free_zones()
        if not free:
            return None
        z = free[0]
        self.zone_lifetime[z] = lifetime
        return z

    def _finish_victim(self) -> Optional[int]:
        best, best_occ = None, -1.0
        for z in self._open_zones():
            if self.zone_busy.get(z):
                continue
            occ = self.dev.zones[z].wp / self.dev.zone_pages
            if occ >= self.finish_threshold and occ > best_occ:
                best, best_occ = z, occ
        if best is not None:
            self.dev.zone_finish(best)
            self.stats.finishes += 1
            self._maybe_reclaim(best)
        return best

    def _pick_zone(self, lifetime: int, need_pages: int) -> Optional[int]:
        # 1. idle open zone with matching lifetime that fits the whole
        #    file (ZenFS avoids splitting files across zones)
        fit = min(need_pages, self.dev.zone_pages)
        for z in self._open_zones():
            if (not self.zone_busy.get(z)
                    and self.zone_lifetime.get(z) == lifetime
                    and self._zone_room(z) >= fit):
                return z
        # 2. fresh zone if under the active-zone limit
        if len(self._open_zones()) < self.max_open:
            z = self._fresh_zone(lifetime)
            if z is not None:
                return z
        # 3. finish a victim above the occupancy threshold, then reopen
        if self._finish_victim() is not None:
            z = self._fresh_zone(lifetime)
            if z is not None:
                return z
        # 4. relaxed match: any idle open zone with room (lifetime mixing)
        candidates = [z for z in self._open_zones()
                      if not self.zone_busy.get(z) and self._zone_room(z) > 0]
        if candidates:
            z = min(candidates,
                    key=lambda zz: abs(self.zone_lifetime.get(zz, 0)
                                       - lifetime))
            self.stats.relaxed_placements += 1
            return z
        return None

    # ------------------------------------------------------------------ #
    # session API (concurrent writers)
    # ------------------------------------------------------------------ #
    def begin(self, file_id: int, lifetime: int,
              expected_pages: int = 0) -> bool:
        f = _File(file_id, lifetime, open=True)
        self.files[file_id] = f
        self.sessions[file_id] = _Session(f, expected_pages=expected_pages)
        return True

    def write(self, file_id: int, n_pages: int) -> bool:
        """Append ``n_pages`` to an open file, acquiring zones as needed."""
        sess = self.sessions[file_id]
        remaining = n_pages
        while remaining > 0:
            if sess.zone is None or self._zone_room(sess.zone) == 0:
                if sess.zone is not None:
                    self.zone_busy[sess.zone] = False
                need = max(remaining, sess.expected_pages)
                z = self._pick_zone(sess.file.lifetime, need)
                if z is None:
                    self.stats.failed_allocs += 1
                    return False
                sess.zone = z
                self.zone_busy[z] = True
            z = sess.zone
            chunk = min(self._zone_room(z), remaining)
            self.dev.zone_write(z, chunk)
            self.zone_valid_pages[z] = self.zone_valid_pages.get(z, 0) + chunk
            self.zone_total_pages[z] = self.zone_total_pages.get(z, 0) + chunk
            sess.file.extents.append(_Extent(z, chunk))
            remaining -= chunk
            sess.expected_pages = max(0, sess.expected_pages - chunk)
            if self._zone_room(z) == 0:
                self.zone_busy[z] = False  # zone sealed itself (FULL)
        self.stats.host_pages += n_pages
        self.sa.on_host_write(n_pages * self.dev.flash.page_bytes)
        self.sa.sample()
        return True

    def end(self, file_id: int) -> None:
        sess = self.sessions.pop(file_id, None)
        if sess is None:
            return
        if sess.zone is not None:
            z = sess.zone
            self.zone_busy[z] = False
            # proactive FINISH (ZenFS): once a file closes, a zone whose
            # occupancy is already >= the threshold is finished to release
            # controller resources -- this is the paper's Fig. 1 knob:
            # finishing at low occupancy buys SA (fresh zones -> no
            # lifetime mixing) at the price of DLWA (padding).
            info = self.dev.zones[z]
            if (info.state is ZoneState.OPEN
                    and info.wp / self.dev.zone_pages
                    >= self.finish_threshold):
                self.dev.zone_finish(z)
                self.stats.finishes += 1
                self._maybe_reclaim(z)
        sess.file.open = False

    def create(self, file_id: int, n_pages: int, lifetime: int) -> bool:
        """Convenience: begin + write + end in one call."""
        self.begin(file_id, lifetime, expected_pages=n_pages)
        ok = self.write(file_id, n_pages)
        self.end(file_id)
        return ok

    # ------------------------------------------------------------------ #
    def delete(self, file_id: int) -> None:
        """Invalidate a file's extents; reclaim any zone that becomes
        fully invalid."""
        f = self.files.pop(file_id, None)
        if f is None:
            return
        page_bytes = self.dev.flash.page_bytes
        touched = set()
        for e in f.extents:
            if not e.valid:
                continue
            e.valid = False
            self.zone_valid_pages[e.zone] -= e.pages
            self.sa.on_invalidate(e.pages * page_bytes)
            touched.add(e.zone)
        for z in touched:
            self._maybe_reclaim(z)
        self.sa.sample()

    def invalidate_partial(self, file_id: int, n_pages: int) -> None:
        """Logically invalidate part of a live file (obsolete versions
        overwritten by updates); the garbage stays pinned until the whole
        zone is invalid."""
        f = self.files.get(file_id)
        if f is None:
            return
        page_bytes = self.dev.flash.page_bytes
        remaining = n_pages
        touched = set()
        for e in f.extents:
            if remaining <= 0:
                break
            if not e.valid or e.pages == 0:
                continue
            cut = min(e.pages, remaining)
            e.pages -= cut
            self.zone_valid_pages[e.zone] -= cut
            self.sa.on_invalidate(cut * page_bytes)
            remaining -= cut
            touched.add(e.zone)
        for z in touched:
            self._maybe_reclaim(z)
        self.sa.sample()

    def _maybe_reclaim(self, z: int) -> None:
        info = self.dev.zones[z]
        if info.state is ZoneState.EMPTY:
            return
        if self.zone_valid_pages.get(z, 0) > 0:
            return
        if self.zone_busy.get(z):
            return
        if info.state is ZoneState.OPEN and info.wp == 0:
            return
        written = self.zone_total_pages.get(z, 0)
        self.dev.zone_reset(z)
        self.stats.resets += 1
        self.sa.on_reclaim(written * self.dev.flash.page_bytes)
        self.zone_valid_pages.pop(z, None)
        self.zone_total_pages.pop(z, None)
        self.zone_lifetime.pop(z, None)
        self.zone_busy.pop(z, None)

    # ------------------------------------------------------------------ #
    def report(self) -> Dict[str, float]:
        return {
            "dlwa": self.dev.dlwa,
            "sa": self.sa.sa,
            "host_pages": float(self.stats.host_pages),
            "dummy_pages": float(self.dev.dummy_pages),
            "relaxed_placements": float(self.stats.relaxed_placements),
            "finishes": float(self.stats.finishes),
            "resets": float(self.stats.resets),
            "failed_allocs": float(self.stats.failed_allocs),
        }
