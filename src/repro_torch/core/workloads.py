"""The paper's benchmark workloads (§6.1) as engine op programs, PyTorch port.

The batched engine drivers of ``repro.core.workloads``: each workload is
encoded as an op program and executed through
:mod:`repro_torch.core.engine`, a whole occupancy sweep as one
``run_programs`` dispatch.

* ``dlwa_program`` / ``dlwa_benchmark_engine`` / ``dlwa_sweep_engine``
  -- fill zones to a target occupancy, FINISH, count dummy pages
  (Fig. 4a / 7a / 8);
* ``interference_program`` -- N zones being FINISHed while the host
  writes N other zones (Fig. 4b / 7d, Table 3);
* ``write_program`` -- FIO-like sequential writes (Fig. 9).

The drivers that rebuild per-page IO streams and time them
(``interference_*_engine``, ``write_benchmark_engine``) and the
``ZNSDevice``-based benchmarks wait for the port of the device shim.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import engine as zengine
from repro_torch.core.elements import ElementSpec
from repro_torch.core.geometry import FlashGeometry, ZoneGeometry


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
