"""Log-structured ZNS-RAID: superzones striped over N emulated devices
(the port of ``repro.array.raid``).

Design follows Log-RAIZN-style zone-granular RAID (Li et al.,
arXiv:2402.17963) composed with the paper's SilentZNS allocation:

* A logical **superzone** ``z`` maps to physical zone ``z`` on *every*
  member device.  Its host-visible capacity is ``n_data * zone_pages``.
* Host pages are striped at **zone-chunk** granularity: ``chunk_pages``
  consecutive pages go to one device before the stripe rotates to the
  next.  Chunk row ``s`` of every member zone belongs to **stripe** ``s``,
  so each device sees a strictly sequential append stream -- exactly what
  a ZNS zone requires, and what lets SilentZNS allocate elements lazily
  underneath.
* With ``parity=True`` each stripe carries one parity chunk, rotated
  RAID-5 style across devices (``(superzone + stripe) % n_devices``).
  Parity is *log-structured*: it is appended when its stripe completes
  (or at FINISH for the final partial stripe), never updated in place.
* **Degraded reads**: with one device failed, a page on the failed device
  is reconstructed by reading the same chunk row from every surviving
  device.
* FINISH/RESET fan out to every member; member FINISH padding rolls up
  into the array's dummy-page count, so DLWA composes across layers.

The array implements :class:`repro_torch.core.backend.ZoneBackend`, so
``ZoneFS`` (and the LSM / checkpoint workloads above it) mount it
unchanged.  A 1-device, parity-off array is bit-identical to the bare
device (tested).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.device import IOTrace, ZNSDevice, ZoneState
from repro_torch.core.elements import ElementSpec
from repro_torch.core.geometry import FlashGeometry, ZoneGeometry
from repro_torch.core.metrics import wear_report


@dataclasses.dataclass(frozen=True)
class ArrayGeometry:
    """Shape of the RAID layer: member count, stripe unit, parity."""

    n_devices: int
    chunk_pages: int          # stripe unit (pages written per device turn)
    parity: bool = False

    def __post_init__(self) -> None:
        if self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        if self.chunk_pages < 1:
            raise ValueError("chunk_pages must be >= 1")
        if self.parity and self.n_devices < 2:
            raise ValueError("parity needs >= 2 devices")

    @property
    def n_data(self) -> int:
        """Data chunks per stripe (devices minus the parity chunk)."""
        return self.n_devices - (1 if self.parity else 0)

    def describe(self) -> str:
        return (f"D{self.n_devices} x C{self.chunk_pages}"
                f"{'+P' if self.parity else ''}")


@dataclasses.dataclass
class SuperZoneInfo:
    """Host-visible state of one superzone (logical page units)."""
    state: ZoneState = ZoneState.EMPTY
    wp: int = 0                # logical data pages written (host + padding)
    host_wp: int = 0           # logical data pages written by the host
    parity_emitted: int = 0    # stripes whose parity chunk has been written


#: (device index, per-device trace) -- the array's tagged trace unit.
TaggedTrace = Tuple[int, IOTrace]


# --------------------------------------------------------------------- #
# stripe math (module-level: shared with the program-space striper in
# repro_torch.fleet.tenants, so there is exactly one source of truth)
# --------------------------------------------------------------------- #
def parity_device_of(zone_id: int, stripe: int, n_devices: int) -> int:
    """Member holding ``stripe``'s parity chunk (RAID-5 rotation)."""
    return (zone_id + stripe) % n_devices


def data_device_of(zone_id: int, stripe: int, slot: int, n_devices: int,
                   parity: bool) -> int:
    """Member holding data slot ``slot`` of ``stripe`` (skipping the
    stripe's parity device when parity is on)."""
    if not parity:
        return slot
    p = parity_device_of(zone_id, stripe, n_devices)
    return slot if slot < p else slot + 1


def locate_page(zone_id: int, page: int, chunk_pages: int, n_data: int,
                n_devices: int, parity: bool) -> Tuple[int, int, int, int]:
    """Logical page -> (stripe, data slot, page-in-chunk, device)."""
    stripe, off = divmod(page, chunk_pages * n_data)
    slot, r = divmod(off, chunk_pages)
    return stripe, slot, r, data_device_of(zone_id, stripe, slot,
                                           n_devices, parity)


def member_chunk_pages(zone_id: int, stripe: int, idx: int, *,
                       chunk_pages: int, n_data: int, n_devices: int,
                       parity: bool, wp: int, parity_emitted: int) -> int:
    """Pages member ``idx`` physically wrote for chunk row ``stripe`` of
    superzone ``zone_id`` (its parity chunk, or its data chunk's written
    prefix), reconstructed from superzone metadata alone -- the member
    itself may be gone.  Shared by the object array's rebuild and the
    engine-native compiler's degraded-read / rebuild planners."""
    c = chunk_pages
    if parity:
        p = parity_device_of(zone_id, stripe, n_devices)
        if p == idx:
            return c if stripe < parity_emitted else 0
        slot = idx if idx < p else idx - 1
    else:
        slot = idx
    if slot >= n_data:
        return 0
    start = stripe * c * n_data + slot * c
    return max(0, min(c, wp - start))


class ZNSArray:
    """N independent :class:`ZNSDevice` members behind one zone surface."""

    def __init__(self, devices: Sequence[ZNSDevice], geom: ArrayGeometry):
        if len(devices) != geom.n_devices:
            raise ValueError(
                f"got {len(devices)} devices for geometry {geom.describe()}")
        zp = {d.zone_pages for d in devices}
        if len(zp) != 1:
            raise ValueError("member devices must share a zone geometry")
        self.devices = list(devices)
        self.geom = geom
        self.dev_zone_pages = zp.pop()
        if self.dev_zone_pages % geom.chunk_pages:
            raise ValueError(
                f"chunk_pages={geom.chunk_pages} must divide the member "
                f"zone capacity ({self.dev_zone_pages} pages)")
        self.stripes_per_zone = self.dev_zone_pages // geom.chunk_pages
        self.n_zones = min(d.n_zones for d in devices)
        self.max_active = min(d.max_active for d in devices)
        self.flash: FlashGeometry = devices[0].flash
        self.zones: Dict[int, SuperZoneInfo] = {
            z: SuperZoneInfo() for z in range(self.n_zones)}
        self.failed: set[int] = set()

        # array-level counters (logical pages)
        self.host_pages = 0
        self.parity_pages = 0

    # ------------------------------------------------------------------ #
    # construction helper
    # ------------------------------------------------------------------ #
    @classmethod
    def build(cls, flash: FlashGeometry, zone_geom: ZoneGeometry,
              spec: ElementSpec, *, n_devices: int,
              chunk_pages: Optional[int] = None, parity: bool = False,
              **device_kw) -> "ZNSArray":
        """Construct ``n_devices`` identical members and the array over
        them.  ``chunk_pages`` defaults to one segment (P erase-block
        rows), the natural stripe unit for the striped write order."""
        devices = [ZNSDevice(flash, zone_geom, spec, **device_kw)
                   for _ in range(n_devices)]
        if chunk_pages is None:
            chunk_pages = zone_geom.segment_pages(flash)
        return cls(devices, ArrayGeometry(n_devices, chunk_pages, parity))

    # ------------------------------------------------------------------ #
    # geometry / metrics (ZoneBackend surface)
    # ------------------------------------------------------------------ #
    @property
    def zone_pages(self) -> int:
        """Host-visible capacity of a superzone (data chunks only)."""
        return self.dev_zone_pages * self.geom.n_data

    @property
    def dummy_pages(self) -> int:
        return sum(d.dummy_pages for d in self.devices)

    @property
    def dlwa(self) -> float:
        """Array-level DLWA: every page the fleet programs (data + parity
        + member FINISH padding) per host data page."""
        if self.host_pages == 0:
            return 1.0
        return ((self.host_pages + self.parity_pages + self.dummy_pages)
                / self.host_pages)

    @property
    def n_active(self) -> int:
        return sum(1 for z in self.zones.values()
                   if z.state is ZoneState.OPEN)

    # ------------------------------------------------------------------ #
    # stripe math
    # ------------------------------------------------------------------ #
    def _parity_device(self, zone_id: int, stripe: int) -> int:
        return parity_device_of(zone_id, stripe, self.geom.n_devices)

    def _data_device(self, zone_id: int, stripe: int, slot: int) -> int:
        return data_device_of(zone_id, stripe, slot, self.geom.n_devices,
                              self.geom.parity)

    def _locate(self, zone_id: int, page: int) -> Tuple[int, int, int, int]:
        """Logical page -> (stripe, data slot, page-in-chunk, device)."""
        return locate_page(zone_id, page, self.geom.chunk_pages,
                           self.geom.n_data, self.geom.n_devices,
                           self.geom.parity)

    # ------------------------------------------------------------------ #
    # ZNS commands (ZoneBackend surface)
    # ------------------------------------------------------------------ #
    def zone_write(self, zone_id: int, n_pages: int, *, host: bool = True,
                   trace: bool = False) -> Optional[List[TaggedTrace]]:
        info = self.zones[zone_id]
        if info.state is ZoneState.FULL:
            raise RuntimeError(f"write to FULL superzone {zone_id}")
        if info.state is ZoneState.EMPTY:
            if self.n_active >= self.max_active:
                raise RuntimeError(
                    f"open/active superzone limit ({self.max_active}) "
                    "reached")
            info.state = ZoneState.OPEN
        if info.wp + n_pages > self.zone_pages:
            raise RuntimeError(
                f"superzone {zone_id} overflow: wp={info.wp} + {n_pages} "
                f"> {self.zone_pages}")

        traces: List[TaggedTrace] = []
        c = self.geom.chunk_pages
        remaining = n_pages
        page = info.wp
        while remaining > 0:
            stripe, slot, r, dev_idx = self._locate(zone_id, page)
            # parity for every completed stripe must land before this
            # device appends its next chunk row (log-structured order)
            self._emit_parity(zone_id, info, upto_stripe=stripe,
                              trace=trace, traces=traces)
            take = min(c - r, remaining)
            tr = self.devices[dev_idx].zone_write(
                zone_id, take, host=host, trace=trace)
            if trace and tr is not None:
                traces.append((dev_idx, tr))
            page += take
            remaining -= take
        info.wp = page
        if host:
            info.host_wp += n_pages
            self.host_pages += n_pages
        # stripe that just completed exactly at wp
        self._emit_parity(zone_id, info,
                          upto_stripe=info.wp // (c * self.geom.n_data),
                          trace=trace, traces=traces)
        if info.wp == self.zone_pages:
            info.state = ZoneState.FULL
        return traces if trace else None

    def _emit_parity(self, zone_id: int, info: SuperZoneInfo, *,
                     upto_stripe: int, trace: bool,
                     traces: List[TaggedTrace]) -> None:
        """Append parity chunks for every completed stripe < upto_stripe."""
        if not self.geom.parity:
            return
        c = self.geom.chunk_pages
        while info.parity_emitted < upto_stripe:
            s = info.parity_emitted
            p = self._parity_device(zone_id, s)
            tr = self.devices[p].zone_write(zone_id, c, host=True,
                                            trace=trace)
            if trace and tr is not None:
                traces.append((p, tr))
            self.parity_pages += c
            info.parity_emitted += 1

    def zone_finish(self, zone_id: int, *, trace: bool = False
                    ) -> Optional[List[TaggedTrace]]:
        """FINISH a superzone.

        1. the final partial stripe (if any) gets its parity chunk --
           parity covers the written prefix, unwritten data reads as
           zeros (log-structured RAID semantics);
        2. every member zone is FINISHed, padding partially-written
           elements (rolls up into ``dummy_pages``).
        """
        info = self.zones[zone_id]
        if info.state is ZoneState.FULL:
            return None
        traces: List[TaggedTrace] = []
        if info.state is ZoneState.OPEN:
            c, k = self.geom.chunk_pages, self.geom.n_data
            full_stripes = info.wp // (c * k)
            self._emit_parity(zone_id, info, upto_stripe=full_stripes,
                              trace=trace, traces=traces)
            if self.geom.parity and info.wp % (c * k):
                # parity over the partial stripe: a full chunk, appended
                # to the stripe's parity device before its zone pads
                s = full_stripes
                p = self._parity_device(zone_id, s)
                tr = self.devices[p].zone_write(zone_id, c, host=True,
                                                trace=trace)
                if trace and tr is not None:
                    traces.append((p, tr))
                self.parity_pages += c
                info.parity_emitted += 1
        for i, dev in enumerate(self.devices):
            tr = dev.zone_finish(zone_id, trace=trace)
            if trace and tr is not None and len(tr.luns):
                traces.append((i, tr))
        info.state = ZoneState.FULL
        return traces if trace else None

    def zone_reset(self, zone_id: int) -> None:
        for dev in self.devices:
            dev.zone_reset(zone_id)
        self.zones[zone_id] = SuperZoneInfo()

    def zone_read(self, zone_id: int, pages: np.ndarray
                  ) -> List[TaggedTrace]:
        """Read logical pages; reconstructs pages on failed devices from
        the surviving members of their stripe (degraded read)."""
        info = self.zones[zone_id]
        if info.state is ZoneState.EMPTY:
            raise RuntimeError(f"read from unmapped superzone {zone_id}")
        c = self.geom.chunk_pages
        per_dev: List[List[int]] = [[] for _ in self.devices]
        for page in np.asarray(pages, dtype=np.int64):
            stripe, _, r, dev_idx = self._locate(zone_id, int(page))
            if dev_idx in self.failed:
                if not self.geom.parity:
                    raise RuntimeError(
                        f"device {dev_idx} failed and parity is off: "
                        f"superzone {zone_id} page {int(page)} lost")
                if stripe >= info.parity_emitted:
                    # log-structured parity is appended only once the
                    # stripe completes (or at FINISH); until then a lost
                    # chunk of the open stripe is unrecoverable
                    raise RuntimeError(
                        f"superzone {zone_id} page {int(page)}: stripe "
                        f"{stripe} parity not yet written, page lost")
                # degraded: same chunk row from every surviving member
                # that physically wrote it -- chunks a FINISHed partial
                # stripe never wrote contribute zeros to the parity and
                # need no read
                off = stripe * c + r
                for other in range(self.geom.n_devices):
                    if other == dev_idx or other in self.failed:
                        continue
                    if self.devices[other].zones[zone_id].wp <= off:
                        continue
                    per_dev[other].append(off)
            else:
                per_dev[dev_idx].append(stripe * c + r)
        out: List[TaggedTrace] = []
        for i, plist in enumerate(per_dev):
            if not plist:
                continue
            tr = self.devices[i].zone_read(
                zone_id, np.asarray(plist, dtype=np.int64))
            out.append((i, tr))
        return out

    # ------------------------------------------------------------------ #
    # failure injection + rebuild
    # ------------------------------------------------------------------ #
    def fail_device(self, idx: int) -> None:
        if self.geom.parity and len(self.failed) >= 1 and idx not in self.failed:
            raise RuntimeError("single-parity array cannot survive a "
                               "second device failure")
        self.failed.add(idx)

    def heal_device(self, idx: int) -> None:
        self.failed.discard(idx)

    def _member_chunk(self, zone_id: int, stripe: int, idx: int,
                      info: SuperZoneInfo) -> int:
        """Pages member ``idx`` physically wrote for chunk row ``stripe``
        of ``zone_id`` -- see :func:`member_chunk_pages` (module-level so
        the engine-native planner shares the same source of truth)."""
        return member_chunk_pages(
            zone_id, stripe, idx, chunk_pages=self.geom.chunk_pages,
            n_data=self.geom.n_data, n_devices=self.geom.n_devices,
            parity=self.geom.parity, wp=info.wp,
            parity_emitted=info.parity_emitted)

    def rebuild_device(self, idx: int) -> List[TaggedTrace]:
        """Replace member ``idx`` with a blank device and reconstruct its
        chunks (data *and* rotated parity) from the survivors.

        For every chunk row the lost member held, the same row is read
        from each surviving member that wrote it (stripe XOR, exactly the
        degraded-read access pattern) and the reconstructed chunk is
        appended to the replacement -- a strictly sequential per-zone
        stream, so SilentZNS allocation works unchanged underneath.
        Zones of FULL superzones are FINISHed on the replacement.

        Returns the rebuild's tagged traces (reads on survivors, writes
        on the replacement) for :func:`repro_torch.core.timing.run_fleet_trace`
        interference studies; the replacement is installed and the member
        healed on return.
        """
        if not self.geom.parity:
            raise RuntimeError("rebuild requires parity")
        if any(f != idx for f in self.failed):
            raise RuntimeError("cannot rebuild with another member down")
        old = self.devices[idx]
        replacement = ZNSDevice(old.flash, old.zone_geom, old.spec,
                                max_active=old.max_active,
                                device=old.device)
        c = self.geom.chunk_pages
        tagged: List[TaggedTrace] = []
        for z, info in self.zones.items():
            if info.wp == 0 and info.parity_emitted == 0:
                continue
            wrote = 0
            for s in range(self.stripes_per_zone):
                pages_here = self._member_chunk(z, s, idx, info)
                if pages_here <= 0:
                    continue
                off = s * c
                for other in range(self.geom.n_devices):
                    if other == idx or other in self.failed:
                        continue
                    dwp = self.devices[other].zones[z].wp
                    if dwp <= off:
                        continue
                    n_read = min(pages_here, dwp - off)
                    tr = self.devices[other].zone_read(
                        z, np.arange(off, off + n_read, dtype=np.int64))
                    tagged.append((other, tr))
                tr = replacement.zone_write(z, pages_here, trace=True)
                tagged.append((idx, tr))
                wrote += pages_here
            if info.state is ZoneState.FULL and wrote > 0:
                tr = replacement.zone_finish(z, trace=True)
                if tr is not None and len(tr.luns):
                    tagged.append((idx, tr))
        self.devices[idx] = replacement
        self.failed.discard(idx)
        return tagged

    # ------------------------------------------------------------------ #
    # rollups
    # ------------------------------------------------------------------ #
    def device_reports(self) -> List[Dict[str, float]]:
        """Per-member DLWA / wear / erase rollup (paper metrics, fleet
        edition)."""
        out = []
        for i, dev in enumerate(self.devices):
            rep = {"device": float(i),
                   "dlwa": dev.dlwa,
                   "host_pages": float(dev.host_pages),
                   "dummy_pages": float(dev.dummy_pages),
                   "failed": float(i in self.failed)}
            rep.update(wear_report(dev))
            out.append(rep)
        return out

    def report(self) -> Dict[str, float]:
        """Array-level rollup: logical traffic + fleet aggregates."""
        per = self.device_reports()
        return {
            "n_devices": float(self.geom.n_devices),
            "chunk_pages": float(self.geom.chunk_pages),
            "parity": float(self.geom.parity),
            "host_pages": float(self.host_pages),
            "parity_pages": float(self.parity_pages),
            "dummy_pages": float(self.dummy_pages),
            "dlwa": self.dlwa,
            "parity_overhead": (self.parity_pages / self.host_pages
                                if self.host_pages else 0.0),
            "max_device_dlwa": max(r["dlwa"] for r in per),
            "total_block_erases": sum(r["total_block_erases"] for r in per),
            "total_incl_pending": sum(r["total_incl_pending"] for r in per),
            "max_wear": max(r["max_wear"] for r in per),
        }
