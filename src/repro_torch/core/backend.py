"""The ``ZoneBackend`` protocol: the zone-command surface hosts consume.

:class:`repro_torch.storage.zonefs.ZoneFS` (and through it the LSM simulator,
the checkpoint benchmark, and every other host-side workload) only ever
touches a device through this surface:

* geometry     -- ``zone_pages``, ``n_zones``, ``max_active``,
                  ``flash`` (for ``page_bytes`` and timing constants);
* zone state   -- ``zones[z].state`` / ``zones[z].wp``;
* commands     -- ``zone_write`` / ``zone_read`` / ``zone_finish`` /
                  ``zone_reset``;
* metrics      -- ``dlwa``, ``host_pages``, ``dummy_pages``.

Anything implementing this protocol can be mounted by a host unchanged.
Today there are two implementations: a single emulated
:class:`repro_torch.core.device.ZNSDevice` and the multi-device
:class:`repro_torch.array.ZNSArray` (zone-chunk striping + log-structured
parity), which is what turns every single-device workload into a
multi-device scenario for free.

Units: every page quantity (``zone_pages``, ``n_pages``, write
pointers, ``host_pages``/``dummy_pages``) counts *flash pages* of
``flash.page_bytes`` bytes -- for an array these are logical pages of
the superzone address space.  ``zones`` maps dense zone indexes to
objects exposing at least ``.state`` (EMPTY/OPEN/FULL) and ``.wp``
(pages written).  DLWA is dimensionless: (host + device-generated
pages) / host pages.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.geometry import FlashGeometry


@runtime_checkable
class ZoneBackend(Protocol):
    """Structural type for anything that serves ZNS zone commands."""

    flash: FlashGeometry
    max_active: int

    @property
    def zone_pages(self) -> int: ...          # host-visible pages per zone

    @property
    def n_zones(self) -> int: ...

    @property
    def zones(self) -> Mapping[int, Any]: ...  # z -> obj with .state / .wp

    @property
    def dlwa(self) -> float: ...

    @property
    def host_pages(self) -> int: ...

    @property
    def dummy_pages(self) -> int: ...

    def zone_write(self, zone_id: int, n_pages: int, *, host: bool = True,
                   trace: bool = False) -> Optional[Any]:
        """Append ``n_pages`` pages at the zone's write pointer.

        Opens (and allocates) an EMPTY zone; raises ``RuntimeError`` on
        a FULL zone, overflow, or the active-zone limit.  ``host=False``
        marks device-internal (dummy) traffic.  With ``trace`` returns
        the per-page IO stream(s) for the timing model (an ``IOTrace``,
        or ``(device, IOTrace)`` pairs from an array)."""
        ...

    def zone_read(self, zone_id: int, pages: np.ndarray) -> Any:
        """Read the given page offsets (0-based within the zone);
        returns IO stream(s) as in :meth:`zone_write`.  Arrays serve
        reads of failed members degraded, via parity reconstruction."""
        ...

    def zone_finish(self, zone_id: int, *, trace: bool = False
                    ) -> Optional[Any]:
        """Transition the zone to FULL: pad partially-written storage
        elements (counted in ``dummy_pages``) and release untouched
        ones.  No-op on FULL; with ``trace`` returns the padding
        stream(s)."""
        ...

    def zone_reset(self, zone_id: int) -> None:
        """Return the zone to EMPTY.  Physical erase is deferred to
        re-allocation (paper §5); the zone's valid elements are only
        invalidated here."""
        ...


def set_stream_class(dev: Any, name: str) -> None:
    """Announce the traffic class of the next commands to ``dev``.

    Host front-ends (the LSM simulator's WAL/flush/compaction writers,
    the checkpoint manager's ckpt/log streams, the flash cache's
    admission/hit paths) call this before issuing zone commands.  A
    backend that understands stream classes (the trace recorder in
    :mod:`repro_torch.storage.compile`, which maps classes to tenant tags)
    implements ``set_stream_class``; every other backend ignores the
    announcement -- the call is a no-op on devices without the hook, so
    front-ends stay backend-agnostic."""
    hook = getattr(dev, "set_stream_class", None)
    if hook is not None and hook is not set_stream_class:
        hook(name)


def check_backend(obj: Any) -> None:
    """Raise ``TypeError`` if ``obj`` is missing part of the surface."""
    missing = [name for name in
               ("flash", "max_active", "zone_pages", "n_zones", "zones",
                "dlwa", "host_pages", "dummy_pages", "zone_write",
                "zone_read", "zone_finish", "zone_reset")
               if not hasattr(obj, name)]
    if missing:
        raise TypeError(
            f"{type(obj).__name__} does not implement ZoneBackend "
            f"(missing: {', '.join(missing)})")
