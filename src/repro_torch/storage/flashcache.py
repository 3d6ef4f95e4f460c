"""Zone-granular flash cache on ZNS (arXiv 2410.11260 style), the port
of ``repro.storage.flashcache``.

A flash cache in front of slow storage, mounted directly on any
:class:`repro_torch.core.backend.ZoneBackend`:

* **admission** -- an object is admitted only after
  ``admission_misses`` misses (one-hit-wonders never pollute flash);
* **lifetime-binned placement** -- admitted objects append to the open
  zone of their *hotness bin* (access-frequency bucket), so objects
  with similar expected lifetimes share zones -- the ZNS analogue of
  ZenFS's write-lifetime hints (arXiv 2402.17963), and what makes
  whole-zone eviction cheap;
* **zone-granular eviction** -- when the cache is at its zone budget,
  the least-recently-*accessed* zone is dropped wholesale (its
  residents vanish, the zone is RESET); no page-granular GC exists, so
  cache DLWA stays at the device's own padding overhead.

Hits issue zone reads, admissions issue zone appends, evictions issue
RESETs -- all through the backend protocol, so the same cache runs on a
per-op device, an array, or the trace recorder
(:mod:`repro_torch.storage.compile`), which lowers a whole cache run into one
batched engine dispatch.  Stream classes (``hit`` / ``admit``) are
announced via :func:`repro_torch.core.backend.set_stream_class` so recorded
traffic carries per-class tenant tags.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.core.backend import ZoneBackend, check_backend, set_stream_class
from repro_torch.core.device import ZoneState

__all__ = ["CacheConfig", "CacheStats", "FlashCache"]


@dataclasses.dataclass
class CacheConfig:
    """Knobs of the zoned cache (zone budget, admission, binning)."""

    capacity_zones: int        # zones the cache may occupy (open + sealed)
    obj_pages: int = 1         # default object size (pages)
    admission_misses: int = 1  # misses before an object is admitted
    hot_hits: int = 3          # accesses per hotness-bin promotion
    n_bins: int = 2            # lifetime bins (0 = coldest)

    def __post_init__(self) -> None:
        if self.capacity_zones < self.n_bins + 1:
            raise ValueError(
                f"capacity_zones ({self.capacity_zones}) must exceed "
                f"n_bins ({self.n_bins}): one open zone per bin plus "
                f"at least one evictable zone")
        if self.admission_misses < 1 or self.hot_hits < 1:
            raise ValueError("admission_misses and hot_hits must be >= 1")


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    admitted: int = 0
    rejected: int = 0        # misses below the admission threshold
    evicted_objects: int = 0
    evicted_zones: int = 0
    read_pages: int = 0
    write_pages: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


@dataclasses.dataclass
class _Resident:
    zone: int
    start: int
    pages: int


class FlashCache:
    """LRU-of-zones flash cache over a :class:`ZoneBackend`."""

    def __init__(self, dev: ZoneBackend, cfg: CacheConfig):
        check_backend(dev)
        if cfg.obj_pages > dev.zone_pages:
            raise ValueError(
                f"obj_pages ({cfg.obj_pages}) exceeds zone capacity "
                f"({dev.zone_pages})")
        if cfg.capacity_zones > dev.n_zones:
            raise ValueError(
                f"capacity_zones ({cfg.capacity_zones}) exceeds the "
                f"device's {dev.n_zones} zones")
        if cfg.n_bins > dev.max_active:
            raise ValueError(
                f"n_bins ({cfg.n_bins}) open zones exceed the device's "
                f"active-zone limit ({dev.max_active})")
        self.dev = dev
        self.cfg = cfg
        self.residents: Dict[int, _Resident] = {}
        self.freq: Dict[int, int] = {}
        self._miss_streak: Dict[int, int] = {}
        self._open: Dict[int, int] = {}          # bin -> open zone
        self._zone_objs: Dict[int, Set[int]] = {}
        self._zone_touch: Dict[int, int] = {}    # zone -> last access clock
        self._clock = 0
        self.stats = CacheStats()

    # ------------------------------------------------------------------ #
    def _owned(self) -> List[int]:
        return sorted(self._zone_objs)

    def _bin_of(self, key: int) -> int:
        return min(self.cfg.n_bins - 1,
                   (self.freq.get(key, 1) - 1) // self.cfg.hot_hits)

    def _zone_room(self, z: int) -> int:
        return self.dev.zone_pages - self.dev.zones[z].wp

    def _evict_one(self) -> None:
        """Drop the least-recently-accessed whole zone (zone-granular
        eviction: no page GC, one RESET)."""
        candidates = [z for z in self._zone_objs
                      if z not in self._open.values()]
        if not candidates:         # every owned zone is an open appendee
            candidates = list(self._zone_objs)
        victim = min(candidates,
                     key=lambda z: (self._zone_touch.get(z, 0), z))
        for key in self._zone_objs.pop(victim):
            self.residents.pop(key, None)
            self.stats.evicted_objects += 1
        self.dev.zone_reset(victim)
        self.stats.evicted_zones += 1
        self._zone_touch.pop(victim, None)
        for b, z in list(self._open.items()):
            if z == victim:
                del self._open[b]

    def _acquire_zone(self, b: int) -> int:
        """An EMPTY zone for bin ``b``, evicting down to budget first."""
        while len(self._zone_objs) >= self.cfg.capacity_zones:
            self._evict_one()
        for z in range(self.dev.n_zones):
            if (self.dev.zones[z].state is ZoneState.EMPTY
                    and z not in self._zone_objs):
                self._open[b] = z
                self._zone_objs[z] = set()
                return z
        # the device has fewer EMPTY zones than our budget assumes
        self._evict_one()
        return self._acquire_zone(b)

    # ------------------------------------------------------------------ #
    def access(self, key: int, pages: Optional[int] = None) -> bool:
        """One object access; returns True on a cache hit."""
        pages = self.cfg.obj_pages if pages is None else int(pages)
        if not 1 <= pages <= self.dev.zone_pages:
            raise ValueError(f"object of {pages} pages does not fit a "
                             f"zone ({self.dev.zone_pages} pages)")
        self._clock += 1
        self.freq[key] = self.freq.get(key, 0) + 1
        res = self.residents.get(key)
        if res is not None:
            set_stream_class(self.dev, "hit")
            self.dev.zone_read(
                res.zone, np.arange(res.start, res.start + res.pages,
                                    dtype=np.int64))
            self._zone_touch[res.zone] = self._clock
            self.stats.hits += 1
            self.stats.read_pages += res.pages
            return True
        self.stats.misses += 1
        streak = self._miss_streak.get(key, 0) + 1
        self._miss_streak[key] = streak
        if streak < self.cfg.admission_misses:
            self.stats.rejected += 1
            return False
        self._miss_streak[key] = 0
        self._admit(key, pages)
        return False

    def _admit(self, key: int, pages: int) -> None:
        b = self._bin_of(key)
        z = self._open.get(b)
        if z is not None and self._zone_room(z) < pages:
            # seal the bin's zone: lifetimes in it are spent together
            set_stream_class(self.dev, "admit")
            self.dev.zone_finish(z)
            del self._open[b]
            z = None
        if z is None:
            z = self._acquire_zone(b)
        start = self.dev.zones[z].wp
        set_stream_class(self.dev, "admit")
        self.dev.zone_write(z, pages)
        self.residents[key] = _Resident(z, start, pages)
        self._zone_objs[z].add(key)
        self._zone_touch[z] = self._clock
        self.stats.admitted += 1
        self.stats.write_pages += pages
        if self.dev.zones[z].state is not ZoneState.OPEN:
            # the append sealed the zone (wp reached capacity)
            self._open.pop(b, None)

    def run(self, keys: np.ndarray) -> CacheStats:
        """Drive a whole access stream (e.g. from
        :func:`repro_torch.storage.traffic.zipfian_keys`)."""
        for k in np.asarray(keys).reshape(-1):
            self.access(int(k))
        return self.stats

    def report(self) -> Dict[str, float]:
        s = self.stats
        return {
            "hit_rate": s.hit_rate,
            "hits": float(s.hits),
            "misses": float(s.misses),
            "admitted": float(s.admitted),
            "rejected": float(s.rejected),
            "evicted_objects": float(s.evicted_objects),
            "evicted_zones": float(s.evicted_zones),
            "read_pages": float(s.read_pages),
            "write_pages": float(s.write_pages),
        }
