"""Trace -> op-program compiler: record any ZoneBackend consumer, replay
the whole application run as ONE batched engine dispatch (the port of
``repro.storage.compile``).

The storage front-ends (:class:`repro_torch.storage.zonefs.ZoneFS`, the
LSM simulator, checkpoint schedules, the flash cache) speak the
:class:`repro_torch.core.backend.ZoneBackend` protocol.  Mounting them on
a :class:`RecordingBackend` *records* the zone-command stream instead of
dispatching it per op: the recorder mirrors the device's control plane
exactly (zone states, write pointers, auto-seal, the active-zone limit,
with :class:`repro_torch.core.device.ZNSDevice`'s error strings), so the
front-end takes the same decisions it would on a real device, while
every command lands as one width-5 tenant-tagged op row
(:mod:`repro_torch.fleet.tenants` encoding).  The compiled program then
executes through ``run_programs`` on the engine's device -- per-lane
:class:`~repro_torch.core.engine.DynConfig` (spec / ``alloc_policy`` /
geometry) and op-granular
:func:`repro_torch.core.timing.simulate_fleet_ops` timing ride along
(:func:`replay_recorders`).  Replay is bit-identical to driving the
per-op :class:`~repro_torch.core.device.ZNSDevice` shim with the same
traffic, and to the reference's replay
(``tests/test_torch_trace_compile.py``).  On a card this is the path
for application traffic: one op step per recorded command for all lanes
at once, where the shim pays one op step per command and device.

Stream classes: front-ends announce their traffic class ("wal",
"flush", "compact", "ckpt", "log", "admit", "hit") via
:func:`repro_torch.core.backend.set_stream_class`; a recorder built with
``class_tenants`` maps classes to tenant tags, which is how the
per-tenant-class p99 predictability rollups in
:class:`repro_torch.fleet.runner.FleetResult` attribute latency.

Workloads: :data:`WORKLOADS` names three recorded application mixes --
``lsm`` (KVBench flush/compaction traffic), ``ckpt`` (checkpoint
bursts + log appends on :mod:`repro_torch.storage.traffic` burst
arrivals) and ``cache`` (Zipfian flash-cache admission/eviction);
:func:`run_workload` emits the class-tagged dispatch + report; each is
also registered as a tenant mix of the allocator search
(``repro_torch.fleet.search.MIXES``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.check import assert_states, validate_rows
from repro_torch.core import engine as zengine
from repro_torch.core.backend import set_stream_class
from repro_torch.core.device import ZoneInfo, ZoneState
from repro_torch.core.engine import (DeviceState, DynConfig, ZoneEngine,
                                     stack_dyn)
from repro_torch.core.geometry import FlashGeometry
from repro_torch.fleet import runner
from repro_torch.fleet.tenants import TENANT_COL, pad_programs
from repro_torch.storage.flashcache import CacheConfig, FlashCache
from repro_torch.storage.lsm import KVBenchConfig, LSMSimulator
from repro_torch.storage.traffic import burst_arrivals, zipfian_keys
from repro_torch.storage.zonefs import ZoneFS

__all__ = [
    "RecordingBackend", "replay_recorders", "lane_state", "lane_metrics",
    "scaled_kv_config", "record_lsm", "CheckpointSchedule",
    "record_checkpoints", "record_cache", "WORKLOADS", "workload_programs",
    "run_workload",
]

#: write-lifetime hints of the checkpoint front-end (those of the
#: reference's repro.train.checkpoint; duplicated to keep storage free of
#: a train dependency)
LIFETIME_CKPT = 2
LIFETIME_LOG = 0


class RecordingBackend:
    """A :class:`~repro_torch.core.backend.ZoneBackend` that records
    instead of executing.

    Control-plane state (zone state/wp/host_wp, the active-zone count,
    auto-seal at capacity) is tracked in plain Python with the exact
    transition rules -- and error strings -- of
    :class:`repro_torch.core.device.ZNSDevice`, so any front-end mounted on
    the recorder behaves exactly as it would on the real device.  Every
    accepted command appends one width-5 op row; writes to an EMPTY
    zone are preceded by an explicit ``OP_ALLOC`` row (size hint 0),
    mirroring the shim's dispatch order so replay is bit-identical
    under *both* allocation policies.

    ``zone_base`` offsets recorded zone ids (the recorder's window
    ``0..n_zones-1`` lands on device zones ``base..base+n_zones-1``),
    which is how multi-tenant mixes record on disjoint zone ranges.
    ``tenant`` stamps the tag column of every recorded row; with
    ``class_tenants`` the :meth:`set_stream_class` hook switches it per
    traffic class.

    Metrics: ``host_pages`` is exact from the control plane.
    ``dummy_pages`` / ``dlwa`` require executing FINISH padding: on a
    recorder built with :meth:`for_engine` they replay the recorded
    program lazily through that engine (cached until the next recorded
    command); a bare recorder reports the control-plane view (0 dummy
    pages, DLWA 1.0 -- recording never executes device-side work), and
    real metrics come from :func:`replay_recorders` /
    :func:`lane_metrics`.
    """

    def __init__(self, flash: FlashGeometry, *, zone_pages: int,
                 n_zones: int, max_active: int = 14, zone_base: int = 0,
                 tenant: int = 0,
                 class_tenants: Optional[Dict[str, int]] = None):
        if zone_pages < 1 or n_zones < 1 or max_active < 1:
            raise ValueError("zone_pages, n_zones and max_active must "
                             "be positive")
        self.flash = flash
        self.max_active = max_active
        self._zone_pages = zone_pages
        self._n_zones = n_zones
        self.zone_base = zone_base
        self.tenant = tenant
        self.class_tenants = class_tenants
        self._zones: Dict[int, ZoneInfo] = {
            z: ZoneInfo() for z in range(n_zones)}
        self._rows: List[Tuple[int, int, int, int, int]] = []
        self._host_pages = 0
        self._n_active = 0
        # lazy-replay attachments (for_engine)
        self._eng: Optional[ZoneEngine] = None
        self._dyn_overrides: Dict = {}
        self._dirty = True
        self._cached: Optional[Tuple] = None

    @classmethod
    def for_engine(cls, eng: ZoneEngine, *, n_zones: Optional[int] = None,
                   max_active: Optional[int] = None, zone_base: int = 0,
                   tenant: int = 0,
                   class_tenants: Optional[Dict[str, int]] = None,
                   **dyn_overrides) -> "RecordingBackend":
        """A recorder whose window and limits come from ``eng`` (after
        ``dyn_overrides`` -- ``zone_pages`` / ``spec`` /
        ``alloc_policy`` / ... as accepted by :meth:`ZoneEngine.dyn`)
        and whose ``dlwa`` / ``dummy_pages`` realize lazily by
        replaying the recorded program through it -- a mountable
        compiled device: ``ZoneFS(RecordingBackend.for_engine(eng))``
        records the whole mount, and ``fs.report()`` is one scan."""
        dyn = eng.dyn(**dyn_overrides)    # validates overrides eagerly
        rec = cls(eng.flash,
                  zone_pages=int(dyn.zone_pages),
                  n_zones=min(int(dyn.n_zones) - zone_base,
                              n_zones or int(dyn.n_zones)),
                  max_active=(max_active if max_active is not None
                              else int(dyn.max_active)),
                  zone_base=zone_base, tenant=tenant,
                  class_tenants=class_tenants)
        rec._eng = eng
        rec._dyn_overrides = dict(dyn_overrides)
        return rec

    # ------------------------------------------------------------------ #
    # ZoneBackend surface
    # ------------------------------------------------------------------ #
    @property
    def zone_pages(self) -> int:
        return self._zone_pages

    @property
    def n_zones(self) -> int:
        return self._n_zones

    @property
    def zones(self) -> Dict[int, ZoneInfo]:
        return self._zones

    @property
    def host_pages(self) -> int:
        return self._host_pages

    @property
    def n_active(self) -> int:
        return self._n_active

    @property
    def dummy_pages(self) -> int:
        if self._eng is None:
            return 0    # recording executes no FINISH padding
        return int(self._realize()["dummy_pages"])

    @property
    def dlwa(self) -> float:
        if self._eng is None:
            return 1.0
        return float(self._realize()["dlwa"])

    def set_stream_class(self, name: str) -> None:
        """Map a front-end traffic class to this recorder's tenant tag
        (no-op for classes the recorder was not built to separate)."""
        if self.class_tenants is not None and name in self.class_tenants:
            self.tenant = self.class_tenants[name]

    # -- commands ------------------------------------------------------- #
    def _emit(self, op: int, zone: int, n_pages: int, flags: int) -> None:
        self._rows.append((op, self.zone_base + zone, n_pages, flags,
                           self.tenant))
        self._dirty = True

    def _info(self, zone_id: int) -> ZoneInfo:
        if not 0 <= zone_id < self._n_zones:
            raise IndexError(f"zone {zone_id} out of range "
                             f"(n_zones={self._n_zones})")
        return self._zones[zone_id]

    def _allocate(self, zone_id: int, info: ZoneInfo) -> None:
        if self._n_active >= self.max_active:
            raise RuntimeError(
                f"open/active zone limit ({self.max_active}) reached")
        # explicit ALLOC row (hint 0): the shim's dispatch order, and
        # what keeps replay policy-agnostic
        self._emit(zengine.OP_ALLOC, zone_id, 0, 0)
        info.state = ZoneState.OPEN
        info.wp = 0
        info.host_wp = 0
        # mapped marker: reads are legal until the next RESET
        info.column_luns = np.empty(0, dtype=np.int64)
        self._n_active += 1

    def zone_write(self, zone_id: int, n_pages: int, *, host: bool = True,
                   trace: bool = False) -> None:
        info = self._info(zone_id)
        if info.state is ZoneState.FULL:
            raise RuntimeError(f"write to FULL zone {zone_id}")
        if info.state is ZoneState.EMPTY:
            self._allocate(zone_id, info)
        if info.wp + n_pages > self._zone_pages:
            raise RuntimeError(
                f"zone {zone_id} overflow: wp={info.wp} + {n_pages} "
                f"> {self._zone_pages}")
        self._emit(zengine.OP_WRITE, zone_id, n_pages,
                   zengine.F_HOST if host else 0)
        info.wp += n_pages
        if host:
            info.host_wp += n_pages
            self._host_pages += n_pages
        if info.wp == self._zone_pages:
            info.state = ZoneState.FULL    # auto-seal, as the engine does
            self._n_active -= 1
        return None    # IO streams are rebuilt at replay time

    def zone_read(self, zone_id: int, pages) -> None:
        info = self._info(zone_id)
        if info.column_luns is None:
            raise RuntimeError(f"read from unmapped zone {zone_id}")
        n = int(pages) if np.isscalar(pages) else len(np.asarray(pages))
        if n > 0:
            self._emit(zengine.OP_READ, zone_id, n, 0)
        return None

    def zone_finish(self, zone_id: int, *, trace: bool = False) -> None:
        info = self._info(zone_id)
        if info.state is ZoneState.FULL:
            return None
        self._emit(zengine.OP_FINISH, zone_id, 0, 0)
        if info.state is ZoneState.OPEN:
            self._n_active -= 1
        info.state = ZoneState.FULL
        return None

    def zone_reset(self, zone_id: int) -> None:
        info = self._info(zone_id)
        self._emit(zengine.OP_RESET, zone_id, 0, 0)
        if info.state is ZoneState.OPEN:
            self._n_active -= 1
        self._zones[zone_id] = ZoneInfo()

    # ------------------------------------------------------------------ #
    # the compiled program
    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self._rows)

    def program(self) -> np.ndarray:
        """The recorded command stream as a ``(n_ops, 5)`` tenant-tagged
        op program (the :mod:`repro_torch.fleet.tenants` encoding)."""
        return zengine.encode_program(self._rows, width=TENANT_COL + 1)

    def _realize(self) -> Dict[str, float]:
        if self._eng is None:
            raise RuntimeError(
                "bare RecordingBackend has no dummy_pages/dlwa: attach "
                "an engine with RecordingBackend.for_engine(...) or "
                "replay the program explicitly (replay_recorders)")
        if self._dirty or self._cached is None:
            prog = self.program()
            dyn = (self._eng.dyn(**self._dyn_overrides)
                   if self._dyn_overrides else None)
            state, trace = self._eng.run(self._eng.init_state(), prog, dyn)
            ok = trace.ok.cpu().numpy()
            real = prog[:, 0] != zengine.OP_NOP
            if (real & ~ok).any():
                i = int(np.argwhere(real & ~ok)[0][0])
                raise AssertionError(
                    f"recorder/engine divergence: replayed op {i} "
                    f"{prog[i].tolist()} illegal")
            self._cached = (self._eng.metrics(state), state, trace)
            self._dirty = False
        return self._cached[0]

    def result(self):
        """(state, trace) of the lazy engine replay (``for_engine``
        recorders only) -- cached until the next recorded command."""
        self._realize()
        return self._cached[1], self._cached[2]


# --------------------------------------------------------------------- #
# batched replay
# --------------------------------------------------------------------- #
def replay_recorders(eng: ZoneEngine,
                     recorders: Sequence[RecordingBackend], *,
                     dyns: Optional[Sequence[DynConfig]] = None,
                     n_tenants: int = 1,
                     parity_tenant: Optional[int] = None,
                     pad_quantum: int = 64, obs=None, profiler=None,
                     check: bool = True,
                     sanitize: bool = False) -> runner.FleetResult:
    """Execute every recorder's compiled program as ONE batched fleet
    dispatch (one lane per recorder).

    ``dyns`` supplies one per-lane :class:`DynConfig` (specs,
    ``alloc_policy``, effective geometry); default lanes run the
    engine's primary config.  ``pad_quantum`` rounds the op axis as the
    reference does, so the traces line up with its replay.  ``obs`` /
    ``profiler`` pass through to
    :func:`repro_torch.fleet.runner.run_fleet`.  ``check`` asserts every
    real replayed op was legal -- a recorder/engine divergence fails
    loudly.  ``sanitize`` additionally audits every lane's final device
    state with the :mod:`repro_torch.check` sanitizer (host-side
    numpy).

    Malformed rows (op code outside the IR, negative zone/page counts,
    tenant tags outside the class range) are rejected with a
    ``ValueError`` *before* dispatch: inside the batched scan they
    would not fail, they alias (op/zone clipping) or walk pointers
    backwards -- scan-time garbage with no error at all.
    """
    programs = [np.asarray(r.program(), dtype=np.int32)
                for r in recorders]
    for k, p in enumerate(programs):
        validate_rows(p, n_tenants=n_tenants,
                      parity_tenant=parity_tenant,
                      where=f"recorder {k} program")
    q = max(1, pad_quantum)
    n_ops = -(-max((len(p) for p in programs), default=1) // q) * q
    batch = pad_programs(programs, n_ops=max(n_ops, q))
    dyn = None
    if dyns is not None:
        if len(dyns) != len(recorders):
            raise ValueError(f"{len(dyns)} dyns for {len(recorders)} "
                             f"recorders")
        dyn = stack_dyn(list(dyns))
    res = runner.run_fleet(eng, batch, dyn=dyn, n_tenants=n_tenants,
                           parity_tenant=parity_tenant, obs=obs,
                           profiler=profiler)
    if check:
        runner.assert_all_ok(res)
    if sanitize:
        assert_states(eng.cfg, res.states, dyn, where="replay states")
    return res


def lane_state(res: runner.FleetResult, lane: int) -> DeviceState:
    """One lane's final :class:`DeviceState` out of the stacked batch."""
    return DeviceState(*[x[lane] for x in res.states])


def lane_metrics(eng: ZoneEngine, res: runner.FleetResult,
                 lane: int) -> Dict[str, float]:
    """``eng.metrics`` of one replay lane (host/dummy/DLWA/erases)."""
    return eng.metrics(lane_state(res, lane))


# --------------------------------------------------------------------- #
# workload recorders (application front-ends -> recorded traffic)
# --------------------------------------------------------------------- #
def scaled_kv_config(zone_pages: int, page_bytes: int, *, seed: int = 0,
                     n_flushes: int = 8, max_jobs: int = 2
                     ) -> KVBenchConfig:
    """A KVBench config scaled to the mounted zone capacity: flushes of
    roughly a sixth of a zone (capped), enough mutations for
    ``n_flushes`` memtable flushes (compactions follow from the size
    ratio) -- milliseconds to record at any geometry."""
    entry = 512
    flush_pages = max(2, min(zone_pages // 6, 4096))
    memtable_entries = max(16, flush_pages * page_bytes // entry)
    mutations = memtable_entries * n_flushes
    return KVBenchConfig(
        n_ops=int(mutations / 0.85) + 16,   # mix is ~85% mutations
        entry_bytes=entry,
        memtable_entries=memtable_entries,
        size_ratio=3,
        max_levels=3,
        seed=seed,
        max_concurrent_jobs=max_jobs,
        io_chunk_pages=max(1, flush_pages // 4),
    )


def _lsm_jobs(dev) -> int:
    """Concurrent LSM jobs a mount can sustain: the WAL session plus
    every job holds an open zone, so stay under both the active-zone
    limit and the zone count (placement needs slack to rotate)."""
    return max(1, min(2, dev.max_active - 1, dev.n_zones - 2))


def record_lsm(dev: RecordingBackend, cfg: Optional[KVBenchConfig] = None,
               *, finish_threshold: float = 0.1, seed: int = 0
               ) -> LSMSimulator:
    """Run the KVBench LSM simulator against ``dev`` (scaled to its
    geometry unless ``cfg`` is given) and return the simulator; with a
    recorder the whole run is now ``dev.program()``."""
    if cfg is None:
        cfg = scaled_kv_config(dev.zone_pages, dev.flash.page_bytes,
                               seed=seed, max_jobs=_lsm_jobs(dev))
    sim = LSMSimulator(ZoneFS(dev, finish_threshold=finish_threshold), cfg)
    sim.run()
    if sim.failed:
        raise RuntimeError(
            "LSM run failed to place a file (window too small for the "
            "config: raise n_zones/max_active or shrink the workload)")
    return sim


@dataclasses.dataclass
class CheckpointSchedule:
    """A checkpoint-burst schedule (what the reference's
    ``repro.train.checkpoint`` generates, parameterized): every step
    writes ``shards`` checkpoint shard files and a burst of log appends,
    keeping the last ``keep`` steps live (older shards/logs are deleted
    -> RESET churn).  Log bursts come from
    :func:`repro_torch.storage.traffic.burst_arrivals`."""

    n_steps: int = 8
    shards: int = 3
    shard_pages: int = 0      # 0 -> about a third of a zone
    log_pages: int = 1
    log_rate: int = 2         # baseline log appends per step
    burst_prob: float = 0.25
    burst_mult: int = 6
    keep: int = 2
    seed: int = 0


def record_checkpoints(dev: RecordingBackend,
                       sched: Optional[CheckpointSchedule] = None, *,
                       finish_threshold: float = 0.1) -> ZoneFS:
    """Drive a checkpoint/log workload over ``ZoneFS(dev)`` per
    ``sched`` and return the filesystem."""
    sched = sched or CheckpointSchedule()
    fs = ZoneFS(dev, finish_threshold=finish_threshold)
    shard_pages = sched.shard_pages or max(1, dev.zone_pages // 3)
    bursts = burst_arrivals(sched.n_steps, rate=sched.log_rate,
                            burst_prob=sched.burst_prob,
                            burst_mult=sched.burst_mult, seed=sched.seed)
    fid = 0
    live: Dict[int, List[int]] = {}
    for step in range(sched.n_steps):
        files: List[int] = []
        set_stream_class(dev, "ckpt")
        for _ in range(sched.shards):
            fid += 1
            fs.create(fid, shard_pages, LIFETIME_CKPT)
            files.append(fid)
        set_stream_class(dev, "log")
        for _ in range(int(bursts[step])):
            fid += 1
            fs.create(fid, sched.log_pages, LIFETIME_LOG)
            files.append(fid)
        live[step] = files
        old = step - sched.keep
        if old in live:
            for f in live.pop(old):
                fs.delete(f)
    return fs


def record_cache(dev: RecordingBackend, *, n_accesses: int = 300,
                 n_keys: int = 48, skew: float = 1.1, seed: int = 0,
                 capacity_zones: Optional[int] = None,
                 obj_pages: Optional[int] = None,
                 admission_misses: int = 1) -> FlashCache:
    """Run a Zipfian flash-cache workload over ``dev`` and return the
    cache (hits -> ``OP_READ`` rows, admissions -> appends, zone
    evictions -> RESETs)."""
    cap_zones = capacity_zones or dev.n_zones
    n_bins = 2 if cap_zones >= 3 else 1
    cache = FlashCache(dev, CacheConfig(
        capacity_zones=cap_zones,
        obj_pages=obj_pages or max(1, dev.zone_pages // 8),
        admission_misses=admission_misses,
        n_bins=min(n_bins, dev.max_active)))
    cache.run(zipfian_keys(n_accesses, n_keys, skew=skew, seed=seed))
    return cache


# --------------------------------------------------------------------- #
# fleet tenant mixes (repro_torch.fleet.search.MIXES entries)
# --------------------------------------------------------------------- #
#: workload name -> tenant-class names (tag column order of
#: run_workload's class-tagged dispatch)
WORKLOADS: Dict[str, Tuple[str, ...]] = {
    "lsm": ("wal", "flush", "compact"),
    "ckpt": ("ckpt", "log"),
    "cache": ("admit", "hit"),
}

#: zones one recorded instance needs (LSM rotates WAL + job sessions
#: through live zones and wedges below 6; ckpt/cache churn in place)
_MIN_WINDOW: Dict[str, int] = {"lsm": 6, "ckpt": 4, "cache": 4}


def _window(name: str, n_zones: int, n_lanes: int) -> int:
    need = _MIN_WINDOW[name]
    if n_zones // n_lanes < need:
        raise ValueError(
            f"workload {name!r} needs a {need}-zone window per instance "
            f"({n_lanes} instances -> >= {need * n_lanes} zones); the "
            f"engine exposes {n_zones}")
    return need


def _drive(name: str, dev: RecordingBackend, instance: int) -> None:
    """Record one tenant instance of a named workload (instances get
    seed-skewed traffic so the two fleet tenants are not clones)."""
    if name == "lsm":
        record_lsm(dev, seed=instance,
                   cfg=scaled_kv_config(
                       dev.zone_pages, dev.flash.page_bytes,
                       seed=instance, n_flushes=8 - 3 * instance,
                       max_jobs=_lsm_jobs(dev)))
    elif name == "ckpt":
        # instance 0: shard-heavy bursts; instance 1: log-dominated
        sched = (CheckpointSchedule(shards=3, log_rate=1, seed=0)
                 if instance == 0 else
                 CheckpointSchedule(shards=1, log_rate=5, burst_prob=0.4,
                                    seed=1))
        record_checkpoints(dev, sched)
    elif name == "cache":
        record_cache(dev, skew=1.3 if instance == 0 else 0.7,
                     seed=instance)
    else:
        raise KeyError(f"unknown workload {name!r} "
                       f"(have: {sorted(WORKLOADS)})")


@functools.lru_cache(maxsize=128)
def _recorded_mix(name: str, cap: int, page_bytes: int, n_zones: int,
                  max_active: int, n_tenants: int
                  ) -> Tuple[np.ndarray, ...]:
    """Record ``n_tenants`` instances of workload ``name`` on disjoint
    zone windows (cached: recording is pure Python and depends only on
    these scalars, and the evaluator rebuilds mixes every dispatch)."""
    window = _window(name, n_zones, n_tenants)
    ma = max_active // n_tenants
    if ma < 2:
        raise ValueError(
            f"workload mix {name!r} needs max_active >= {2 * n_tenants} "
            f"({n_tenants} tenants, >= 2 active zones each); engine has "
            f"{max_active}")
    flash = _mix_flash(page_bytes)
    progs = []
    for t in range(n_tenants):
        dev = RecordingBackend(flash, zone_pages=cap, n_zones=window,
                               max_active=ma, zone_base=t * window)
        _drive(name, dev, t)
        progs.append(dev.program())
    return tuple(progs)


@functools.lru_cache(maxsize=8)
def _mix_flash(page_bytes: int) -> FlashGeometry:
    """A minimal FlashGeometry carrying only what front-ends read off a
    recorder (``page_bytes``); the replay engine supplies the real
    geometry."""
    return FlashGeometry(n_channels=1, ways_per_channel=1,
                         blocks_per_lun=1, pages_per_block=1,
                         page_bytes=page_bytes)


def _workload_mix(name: str) -> Callable:
    """The tenant-mix builder of workload ``name``: ``build(eng, cap)``
    records one instance per tenant on disjoint zone windows."""
    def build(eng: ZoneEngine, cap: int) -> List[np.ndarray]:
        from repro_torch.fleet.search import N_TENANTS

        progs = _recorded_mix(name, int(cap), eng.flash.page_bytes,
                              eng.cfg.n_zones, eng.cfg.max_active,
                              N_TENANTS)
        return [p.copy() for p in progs]

    build.__name__ = f"_mix_{name}"
    build.__doc__ = (f"Recorded {name!r} application traffic, one "
                     f"instance per tenant on disjoint zone windows.")
    return build


def _register_mixes() -> None:
    from repro_torch.fleet import search

    for name in WORKLOADS:
        search.MIXES.setdefault(name, _workload_mix(name))


_register_mixes()


# --------------------------------------------------------------------- #
# class-tagged workload dispatch + report
# --------------------------------------------------------------------- #
def workload_programs(eng: ZoneEngine, name: str, *, n_lanes: int = 2,
                      seed: int = 0) -> List[RecordingBackend]:
    """``n_lanes`` recorded instances of workload ``name``, rows tagged
    by *traffic class* (:data:`WORKLOADS` order) rather than by
    instance -- the input of :func:`run_workload`."""
    classes = WORKLOADS[name]
    tags = {c: i for i, c in enumerate(classes)}
    window = _window(name, eng.cfg.n_zones, n_lanes)
    ma = eng.cfg.max_active // n_lanes
    if ma < 2:
        raise ValueError(
            f"workload {name!r} needs max_active >= {2 * n_lanes} for "
            f"{n_lanes} lanes; engine has {eng.cfg.max_active}")
    recs = []
    for lane in range(n_lanes):
        dev = RecordingBackend(eng.flash, zone_pages=eng.cfg.zone_pages,
                               n_zones=window, max_active=ma,
                               zone_base=lane * window,
                               class_tenants=tags)
        _drive(name, dev, (lane + seed) % 2)
        recs.append(dev)
    return recs


def run_workload(eng: ZoneEngine, name: str, *, n_lanes: int = 2,
                 seed: int = 0, pad_quantum: int = 64, obs=None,
                 profiler=None, sanitize: bool = False
                 ) -> Tuple[runner.FleetResult, Dict]:
    """Record workload ``name``, execute it as ONE class-tagged batched
    dispatch, and roll up per-tenant-class p99 predictability.

    Returns ``(FleetResult, report)`` where ``report`` carries one
    entry per traffic class (ops, pages, p50/p99/max latency,
    ``p99_over_p50`` predictability) plus dispatch-level totals.
    Rows are pre-validated and (with ``sanitize=True``) the final
    device states audited, as in :func:`replay_recorders`."""
    classes = WORKLOADS[name]
    recs = workload_programs(eng, name, n_lanes=n_lanes, seed=seed)
    res = replay_recorders(eng, recs, n_tenants=len(classes),
                           pad_quantum=pad_quantum, obs=obs,
                           profiler=profiler, sanitize=sanitize)
    report = {
        "workload": name,
        "n_lanes": float(len(recs)),
        "recorded_ops": float(sum(len(r) for r in recs)),
        "makespan_s": float(res.makespans.max()),
        "host_pages": float(sum(r.host_pages for r in recs)),
        "tenant_classes": res.tenant_class_report(names=classes),
    }
    return res, report
