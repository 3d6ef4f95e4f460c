"""The paper's benchmark workloads (§6.1) on the emulated device, PyTorch
port.

* ``dlwa_benchmark``        -- fill zones to a target occupancy, FINISH,
                               count dummy pages (Fig. 4a / 7a / 8).
* ``interference_benchmark``-- N zones being FINISHed while the host
                               writes N other zones (Fig. 4b / 7d, Table 3).
* ``write_benchmark``       -- FIO-like sequential writes, varying request
                               size and concurrent zones (Fig. 9).
* ``alloc_latency_benchmark``-- median zone-allocation latency (Table 4).

The per-op benchmarks take a device shim
(:class:`repro_torch.core.device.ZNSDevice`) or the per-op legacy device
(:class:`repro_torch.core.device_legacy.LegacyZNSDevice`) and time its
page streams with :func:`repro_torch.core.timing.run_trace` on the
device's own ``device`` (the ``page_clock`` kernel on a card).

Each benchmark also has a **batched engine driver** (``*_engine`` /
``dlwa_sweep_engine``) that encodes the workload as an op program and
executes it through :mod:`repro_torch.core.engine`: a whole occupancy
sweep, or a whole interference concurrency sweep, runs as one
``run_programs`` dispatch.  The engine drivers are metric-identical to
the per-op paths (tested), and :func:`engine_vs_legacy_speedup` times the
two against each other.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import engine as zengine
from repro_torch.core import timing
from repro_torch.core.device import IOTrace, ZNSDevice
from repro_torch.core.elements import ElementSpec
from repro_torch.core.geometry import FlashGeometry, ZoneGeometry


def make_device(flash: FlashGeometry, zone: ZoneGeometry, spec: ElementSpec,
                *, max_active: int = 14, device="cuda") -> ZNSDevice:
    return ZNSDevice(flash, zone, spec, max_active=max_active,
                     device=device)


# --------------------------------------------------------------------- #
# DLWA benchmark (paper Fig. 4a, 7a, 8)
# --------------------------------------------------------------------- #
def dlwa_benchmark(dev, *, occupancy: float,
                   n_zones: Optional[int] = None) -> Dict[str, float]:
    """Fill ``n_zones`` zones to ``occupancy`` then FINISH each; report
    dummy pages (pages 'finished') and DLWA."""
    n_zones = n_zones or min(8, dev.n_zones)
    pages = max(1, int(round(dev.zone_pages * occupancy)))
    pages = min(pages, dev.zone_pages)
    host0, dummy0 = dev.host_pages, dev.dummy_pages
    for z in range(n_zones):
        dev.zone_write(z, pages)
        dev.zone_finish(z)
    host = dev.host_pages - host0
    dummy = dev.dummy_pages - dummy0
    return _dlwa_metrics(host, dummy, occupancy, n_zones)


# --------------------------------------------------------------------- #
# Interference benchmark (paper Fig. 4b, 7d, Table 3)
# --------------------------------------------------------------------- #
def _interference_metrics(flash: FlashGeometry, concurrency: int,
                          host_traces: List[IOTrace],
                          finish_traces: List[IOTrace], device
                          ) -> Dict[str, float]:
    """Host streams alone, then host + FINISH dummy streams interleaved:
    interference = host-only throughput / contended host throughput."""
    base = timing.run_trace(flash, host_traces, device=device)
    base_tp = sum(base[f"owner{i}_throughput_pages_s"]
                  for i in range(len(host_traces)))
    cont = timing.run_trace(flash, host_traces + finish_traces,
                            device=device)
    cont_tp = sum(cont[f"owner{i}_throughput_pages_s"]
                  for i in range(len(host_traces)))
    return {
        "concurrency": float(concurrency),
        "baseline_pages_s": base_tp,
        "contended_pages_s": cont_tp,
        "interference": base_tp / cont_tp if cont_tp else float("inf"),
        "dummy_pages": float(sum(len(t.luns) for t in finish_traces)),
    }


def interference_benchmark(dev, *, concurrency: int,
                           fill_occupancy: float = 0.4,
                           host_pages_per_zone: Optional[int] = None
                           ) -> Dict[str, float]:
    """``concurrency`` zones are FINISHed while the host writes to
    ``concurrency`` other zones.  Interference = host-only throughput /
    host throughput under concurrent FINISH."""
    fill = max(1, int(round(dev.zone_pages * fill_occupancy)))
    hpz = host_pages_per_zone or fill

    # victims: partially filled zones that will be finished
    victims = list(range(concurrency))
    writers = list(range(concurrency, 2 * concurrency))
    for z in victims:
        dev.zone_write(z, fill)

    host_traces: List[IOTrace] = []
    for z in writers:
        host_traces.append(dev.zone_write(z, hpz, trace=True))

    finish_traces: List[IOTrace] = []
    for z in victims:
        tr = dev.zone_finish(z, trace=True)
        if tr is not None and len(tr.luns):
            finish_traces.append(tr)
    return _interference_metrics(dev.flash, concurrency, host_traces,
                                 finish_traces, dev.device)


# --------------------------------------------------------------------- #
# FIO-like raw write benchmark (paper Fig. 9)
# --------------------------------------------------------------------- #
def _write_metrics(flash: FlashGeometry, request_kib: int, n_jobs: int,
                   traces: List[IOTrace], device) -> Dict[str, float]:
    stats = timing.run_trace(flash, traces, device=device)
    return {
        "request_kib": float(request_kib),
        "n_jobs": float(n_jobs),
        "pages": float(stats["n"]),
        "bandwidth_mib_s": timing.write_bandwidth_mib_s(flash, stats),
        "makespan_s": stats["makespan_s"],
    }


def write_benchmark(dev, *, request_kib: int, n_jobs: int,
                    mib_per_job: int = 16) -> Dict[str, float]:
    """``n_jobs`` concurrent sequential writers, one dedicated zone each,
    fixed request size.  Reports aggregate bandwidth (MiB/s)."""
    pages_per_req = max(1, request_kib * 1024 // dev.flash.page_bytes)
    reqs_per_job = max(1, mib_per_job * 1024 * 1024
                       // (pages_per_req * dev.flash.page_bytes))
    total_pages = pages_per_req * reqs_per_job
    total_pages = min(total_pages, dev.zone_pages)

    traces = [dev.zone_write(j, total_pages, trace=True)
              for j in range(n_jobs)]
    return _write_metrics(dev.flash, request_kib, n_jobs, traces,
                          dev.device)


# --------------------------------------------------------------------- #
# Zone-allocation latency (paper Table 4)
# --------------------------------------------------------------------- #
def alloc_latency_benchmark(dev, *, n_allocs: int = 32
                            ) -> Dict[str, float]:
    """Median wall-clock latency of zone allocation.  Exercises the
    allocate -> write -> finish -> reset cycle so re-allocation hits the
    deferred-erase path too."""
    n = min(n_allocs, dev.n_zones)
    # Warm up *before* timing: every path with a kernel behind it (the
    # engine's op step, or the legacy allocator's primary window +
    # cheapest-groups fallback) -- otherwise the first build, load and
    # launch plan land in the sample set and skew small-sample medians
    # (paper Table 4 methodology).
    warmup = getattr(dev, "warmup_alloc", None)
    if warmup is not None:
        warmup()
    dev.zone_write(0, 1)
    dev.zone_finish(0)
    dev.zone_reset(0)
    dev.alloc_latencies_us.clear()
    for i in range(n):
        z = i % max(1, dev.n_zones // 2)
        dev.zone_write(z, 1)
        dev.zone_finish(z)
        dev.zone_reset(z)
    return {
        "n_allocs": float(len(dev.alloc_latencies_us)),
        "median_us": dev.median_alloc_latency_us(),
        "mean_us": float(np.mean(dev.alloc_latencies_us)),
    }


# --------------------------------------------------------------------- #
# Batched engine drivers: workloads as op programs (one dispatch)
# --------------------------------------------------------------------- #
def make_engine(flash: FlashGeometry, zone: ZoneGeometry,
                spec: ElementSpec, *, max_active: int = 14,
                wear_aware: Optional[bool] = None,
                device="cuda") -> zengine.ZoneEngine:
    return zengine.ZoneEngine(flash, zone, spec, max_active=max_active,
                              wear_aware=wear_aware, device=device)


def dlwa_program(eng: zengine.ZoneEngine, *, occupancy: float,
                 n_zones: Optional[int] = None, zone_base: int = 0,
                 zone_pages: Optional[int] = None) -> np.ndarray:
    """Encode the DLWA benchmark (fill, FINISH) as an op program.

    ``zone_base`` offsets the zones touched (the fleet layer namespaces
    tenants into disjoint zone ranges); ``zone_pages`` overrides the
    capacity occupancy is computed against (a fleet superzone's logical
    capacity, or a ``DynConfig`` effective geometry)."""
    cfg = eng.cfg
    n_zones = n_zones or min(8, cfg.n_zones)
    cap = zone_pages or cfg.zone_pages
    pages = max(1, int(round(cap * occupancy)))
    pages = min(pages, cap)
    rows = []
    for z in range(zone_base, zone_base + n_zones):
        rows.append((zengine.OP_WRITE, z, pages, zengine.F_HOST))
        rows.append((zengine.OP_FINISH, z, 0, 0))
    return zengine.encode_program(rows)


def _dlwa_metrics(host: int, dummy: int, occupancy: float,
                  n_zones: int) -> Dict[str, float]:
    return {
        "occupancy": occupancy,
        "host_pages": float(host),
        "dummy_pages": float(dummy),
        "dummy_pages_per_zone": dummy / n_zones,
        "dlwa": (host + dummy) / host if host else 1.0,
    }


def dlwa_benchmark_engine(eng: zengine.ZoneEngine, *, occupancy: float,
                          n_zones: Optional[int] = None) -> Dict[str, float]:
    """The DLWA benchmark as one engine dispatch (fresh device state)."""
    n_zones = n_zones or min(8, eng.cfg.n_zones)
    prog = dlwa_program(eng, occupancy=occupancy, n_zones=n_zones)
    state, _ = eng.run(eng.init_state(), prog)
    return _dlwa_metrics(int(state.host_pages), int(state.dummy_pages),
                         occupancy, n_zones)


def dlwa_sweep_engine(eng: zengine.ZoneEngine,
                      occupancies: Sequence[float],
                      *, n_zones: Optional[int] = None
                      ) -> List[Dict[str, float]]:
    """A whole occupancy sweep in ONE dispatch: every program has the
    same shape (pages varies per row), so the sweep batches cleanly."""
    n_zones = n_zones or min(8, eng.cfg.n_zones)
    programs = np.stack([
        dlwa_program(eng, occupancy=o, n_zones=n_zones)
        for o in occupancies])
    states, _ = eng.run_batch(eng.init_state(), programs)
    hosts = states.host_pages.cpu().numpy()
    dummies = states.dummy_pages.cpu().numpy()
    return [_dlwa_metrics(int(hosts[k]), int(dummies[k]), occ, n_zones)
            for k, occ in enumerate(occupancies)]


def _op_traces(eng: zengine.ZoneEngine, program: np.ndarray, trace
               ) -> List[Optional[IOTrace]]:
    """Per-op IOTraces of an executed program (None for no-IO ops)."""
    wp_b = trace.wp_before.cpu().numpy()
    wp_a = trace.wp_after.cpu().numpy()
    dummy = trace.dummy_delta.cpu().numpy()
    elems = trace.elems.cpu().numpy()
    cols = trace.cols.cpu().numpy()
    out: List[Optional[IOTrace]] = []
    for i in range(len(program)):
        s = eng.op_stream(int(program[i, 0]), int(wp_b[i]), int(wp_a[i]),
                          int(dummy[i]), elems[i], cols[i])
        out.append(None if s is None else IOTrace(s[0], s[1], s[2]))
    return out


def interference_program(eng: zengine.ZoneEngine, *, concurrency: int,
                         fill_occupancy: float = 0.4,
                         host_pages_per_zone: Optional[int] = None,
                         zone_base: int = 0,
                         zone_pages: Optional[int] = None) -> np.ndarray:
    """Fused finish+host-write program (victim fills, host writes, victim
    FINISHes) -- the op order of the interference benchmark.
    ``zone_base`` / ``zone_pages`` as in :func:`dlwa_program`."""
    cfg = eng.cfg
    cap = zone_pages or cfg.zone_pages
    fill = max(1, int(round(cap * fill_occupancy)))
    hpz = host_pages_per_zone or fill
    rows = []
    b = zone_base
    for z in range(b, b + concurrency):                    # victims fill
        rows.append((zengine.OP_WRITE, z, fill, zengine.F_HOST))
    for z in range(b + concurrency, b + 2 * concurrency):  # host writers
        rows.append((zengine.OP_WRITE, z, hpz, zengine.F_HOST))
    for z in range(b, b + concurrency):                    # victims FINISH
        rows.append((zengine.OP_FINISH, z, 0, 0))
    return zengine.encode_program(rows)


def _lane_interference(eng: zengine.ZoneEngine, concurrency: int,
                       program: np.ndarray, trace) -> Dict[str, float]:
    """The interference metrics of one executed interference program
    (stream rebuild on its unpadded prefix + ``run_trace`` timing)."""
    c = concurrency
    streams = _op_traces(eng, program, trace)
    host_traces = [t for t in streams[c: 2 * c] if t is not None]
    finish_traces = [t for t in streams[2 * c: len(program)]
                     if t is not None and len(t.luns)]
    return _interference_metrics(eng.flash, c, host_traces, finish_traces,
                                 eng.device)


def interference_benchmark_engine(eng: zengine.ZoneEngine, *,
                                  concurrency: int,
                                  fill_occupancy: float = 0.4,
                                  host_pages_per_zone: Optional[int] = None
                                  ) -> Dict[str, float]:
    """The interference benchmark via one dispatch + one stream rebuild;
    timing uses the same :func:`repro_torch.core.timing.run_trace`
    merge."""
    prog = interference_program(
        eng, concurrency=concurrency, fill_occupancy=fill_occupancy,
        host_pages_per_zone=host_pages_per_zone)
    _, trace = eng.run(eng.init_state(), prog)
    return _lane_interference(eng, concurrency, prog, trace)


def interference_sweep_engine(eng: zengine.ZoneEngine,
                              concurrencies: Sequence[int], *,
                              fill_occupancy: float = 0.4,
                              host_pages_per_zone: Optional[int] = None
                              ) -> List[Dict[str, float]]:
    """The whole concurrency sweep of
    :func:`interference_benchmark_engine` in ONE batched dispatch.

    The per-concurrency programs are NOP-padded to one rectangular batch
    and executed through a single ``run_programs`` dispatch: one op step
    per padded row for every point at once, and one set of launch plans
    for the whole sweep (stable across repeats, which
    :func:`engine_vs_legacy_speedup` checks with the
    ``repro_torch.obs`` plan counter).  Per-point metrics (stream rebuild
    + ``run_trace`` timing on the unpadded prefix) are exactly those of
    :func:`interference_benchmark_engine` (tested).
    """
    concurrencies = list(concurrencies)
    progs = [interference_program(
        eng, concurrency=c, fill_occupancy=fill_occupancy,
        host_pages_per_zone=host_pages_per_zone) for c in concurrencies]
    n_max = max((len(p) for p in progs), default=0)
    batch = np.zeros((len(progs), n_max, 4), dtype=np.int32)
    for i, p in enumerate(progs):
        batch[i, : len(p)] = p                 # NOP rows pad the tail
    _, traces = eng.run_batch(eng.init_state(), batch)
    return [_lane_interference(eng, c, prog,
                               type(traces)(*(x[i] for x in traces)))
            for i, (c, prog) in enumerate(zip(concurrencies, progs))]


def write_program(eng: zengine.ZoneEngine, *, request_kib: int,
                  n_jobs: int, mib_per_job: int = 16, zone_base: int = 0,
                  zone_pages: Optional[int] = None) -> np.ndarray:
    """Encode the write benchmark's sequential-writer jobs (one
    dedicated zone each) as an op program.  ``zone_base`` /
    ``zone_pages`` as in :func:`dlwa_program`."""
    cfg = eng.cfg
    cap = zone_pages or cfg.zone_pages
    pages_per_req = max(1, request_kib * 1024 // eng.flash.page_bytes)
    reqs_per_job = max(1, mib_per_job * 1024 * 1024
                       // (pages_per_req * eng.flash.page_bytes))
    total_pages = min(pages_per_req * reqs_per_job, cap)
    return zengine.encode_program(
        [(zengine.OP_WRITE, zone_base + j, total_pages, zengine.F_HOST)
         for j in range(n_jobs)])


def write_benchmark_engine(eng: zengine.ZoneEngine, *, request_kib: int,
                           n_jobs: int, mib_per_job: int = 16
                           ) -> Dict[str, float]:
    """The write benchmark as an op program + one stream rebuild."""
    prog = write_program(eng, request_kib=request_kib, n_jobs=n_jobs,
                         mib_per_job=mib_per_job)
    _, trace = eng.run(eng.init_state(), prog)
    traces = [t for t in _op_traces(eng, prog, trace) if t is not None]
    return _write_metrics(eng.flash, request_kib, n_jobs, traces,
                          eng.device)


# --------------------------------------------------------------------- #
# Engine vs the legacy per-op loop
# --------------------------------------------------------------------- #
def engine_vs_legacy_speedup(*, occupancies: Sequence[float] = tuple(
        np.linspace(0.05, 0.95, 16)), n_zones: int = 8,
        concurrencies: Sequence[int] = (1, 2, 4, 7),
        repeats: int = 3, device="cuda") -> Dict[str, float]:
    """Time the DLWA occupancy sweep and the interference benchmark on
    the legacy per-op ``LegacyZNSDevice`` loop vs the batched engine
    (steady state: the kernels' first build and launch plans excluded
    via a warm pass), both on ``device``.  Returns ops/sec for both plus
    the speedups.  The DLWA and dummy-page asserts hold the two paths to
    each other."""
    from repro_torch.core.device_legacy import LegacyZNSDevice
    from repro_torch.core.elements import SUPERBLOCK
    from repro_torch.core.geometry import zn540
    from repro_torch.obs.profile import RecompileCounter

    flash, zone = zn540()
    eng = make_engine(flash, zone, SUPERBLOCK, max_active=28,
                      device=device)

    # ---- dlwa sweep -------------------------------------------------- #
    n_ops_dlwa = 2 * n_zones * len(occupancies)
    dlwa_sweep_engine(eng, occupancies, n_zones=n_zones)  # warm
    t0 = time.perf_counter()
    for _ in range(repeats):
        eng_rows = dlwa_sweep_engine(eng, occupancies, n_zones=n_zones)
    t_eng_dlwa = (time.perf_counter() - t0) / repeats

    def legacy_sweep():
        rows = []
        for occ in occupancies:
            dev = LegacyZNSDevice(flash, zone, SUPERBLOCK, max_active=28,
                                  device=device)
            rows.append(dlwa_benchmark(dev, occupancy=occ,
                                       n_zones=n_zones))
        return rows
    legacy_sweep()  # warm the allocator kernel
    t0 = time.perf_counter()
    for _ in range(repeats):
        leg_rows = legacy_sweep()
    t_leg_dlwa = (time.perf_counter() - t0) / repeats
    assert [r["dlwa"] for r in eng_rows] == [r["dlwa"] for r in leg_rows]

    # ---- interference (whole sweep in ONE padded dispatch) ------------ #
    # the batched sweep holds one run_programs shape for the whole
    # sweep, and the plan counter certifies repeats add no launch plan
    n_ops_intf = sum(3 * c for c in concurrencies)

    def engine_intf():
        return interference_sweep_engine(eng, concurrencies)

    def legacy_intf():
        out = []
        for c in concurrencies:
            dev = LegacyZNSDevice(flash, zone, SUPERBLOCK, max_active=28,
                                  device=device)
            out.append(interference_benchmark(dev, concurrency=c))
        return out
    engine_intf(); legacy_intf()  # warm both paths
    rc = RecompileCounter(run_programs=zengine.run_programs)
    warm = rc.counts()
    t0 = time.perf_counter()
    for _ in range(repeats):
        ei = engine_intf()
    t_eng_intf = (time.perf_counter() - t0) / repeats
    intf_recompiles = rc.delta(warm)["run_programs"]
    t0 = time.perf_counter()
    for _ in range(repeats):
        li = legacy_intf()
    t_leg_intf = (time.perf_counter() - t0) / repeats
    assert [r["dummy_pages"] for r in ei] == [r["dummy_pages"] for r in li]

    return {
        "dlwa_ops": float(n_ops_dlwa),
        "dlwa_legacy_s": t_leg_dlwa,
        "dlwa_engine_s": t_eng_dlwa,
        "dlwa_legacy_ops_s": n_ops_dlwa / t_leg_dlwa,
        "dlwa_engine_ops_s": n_ops_dlwa / t_eng_dlwa,
        "dlwa_speedup": t_leg_dlwa / t_eng_dlwa,
        "interference_ops": float(n_ops_intf),
        "interference_legacy_s": t_leg_intf,
        "interference_engine_s": t_eng_intf,
        "interference_legacy_ops_s": n_ops_intf / t_leg_intf,
        "interference_engine_ops_s": n_ops_intf / t_eng_intf,
        "interference_speedup": t_leg_intf / t_eng_intf,
        # dispatches per sweep and launch-plan growth across the timed
        # repeats (0 = shape-stable)
        "interference_dispatches": 1.0,
        "interference_recompiles": float(intf_recompiles),
    }
