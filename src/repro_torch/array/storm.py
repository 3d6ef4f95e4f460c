"""Batched rebuild storms: K arrays x failure schedules in ONE dispatch
(the port of ``repro.array.storm``).

The reference's legacy rebuild mode times one scenario at a time --
three per-scenario ``run_fleet_trace`` calls over object-array traces.
Here every scenario compiles into THREE engine-native arrays on one
shared ``ZoneEngine``:

* ``host``      -- fill, then concurrent host writes alone,
* ``rebuild``   -- fill, fail a member, rebuild it (survivor degraded
  reads + replacement re-append) alone,
* ``contended`` -- fill, fail, rebuild *and* the host writes, the two
  streams round-robin merged per member lane (concurrent submission
  queues, the same merge model as ``timing.run_trace``),

and ALL ``3K`` arrays execute in one :func:`run_array_batch` dispatch
(obs telemetry optional) followed by ONE op-granular
:func:`simulate_fleet_ops` timing pass -- fill-phase rows are masked
out of the clock, so makespans cover only the storm phase.
``rebuild_interference = contended / host`` makespan, per scenario.

Repeated calls at the same scenario scale keep one set of launch plans
(same lane count, ``pad_quantum`` rounds the op axis), which a
``RecompileCounter`` shows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.array.engine import (ArrayEngine, run_array_batch,
                                      run_array_timing)
from repro_torch.array.raid import ArrayGeometry
from repro_torch.core import engine as zengine
from repro_torch.core.elements import ElementSpec
from repro_torch.core.engine import ZoneEngine


@dataclasses.dataclass(frozen=True)
class StormScenario:
    """One rebuild-storm cell: an array shape + a failure schedule.

    ``member_specs`` (optional) mixes element specs across members --
    the shared engine must then be built over the union of every
    scenario's specs.  ``fail_device`` defaults to the last member,
    like the legacy rebuild mode.
    """

    n_devices: int = 4
    chunk_pages: Optional[int] = None      # None -> one segment
    member_specs: Optional[Tuple[ElementSpec, ...]] = None
    n_zones_filled: int = 4
    occupancy: float = 0.6
    fail_device: Optional[int] = None
    host_occupancy: Optional[float] = None  # None -> occupancy

    def describe(self) -> str:
        spec = ("mix" if self.member_specs
                and len(set(self.member_specs)) > 1 else "uniform")
        return (f"d{self.n_devices}_c{self.chunk_pages or 'seg'}_"
                f"z{self.n_zones_filled}_o{self.occupancy:g}_{spec}")


def _rr_merge(a: List[tuple], b: List[tuple]) -> List[tuple]:
    """Round-robin interleave of two op-row streams (the concurrent
    submission-queue model ``timing`` uses to merge traces)."""
    out: List[tuple] = []
    for i in range(max(len(a), len(b))):
        if i < len(a):
            out.append(a[i])
        if i < len(b):
            out.append(b[i])
    return out


def _build_variant(eng: ZoneEngine, sc: StormScenario, *,
                   host: bool, rebuild: bool
                   ) -> Tuple[ArrayEngine, List[int]]:
    """Compile one scenario variant; returns the array and the per-lane
    fill-phase row counts (the prefix the timing clock masks out)."""
    chunk = (sc.chunk_pages if sc.chunk_pages is not None
             else eng.zone_geom.segment_pages(eng.flash))
    a = ArrayEngine(eng, ArrayGeometry(sc.n_devices, chunk, True),
                    member_specs=sc.member_specs)
    n_filled = min(sc.n_zones_filled, a.n_zones // 2, a.max_active)
    fill = max(1, int(round(a.zone_pages * sc.occupancy)))
    for z in range(n_filled):
        a.zone_write(z, fill)
        a.zone_finish(z)
    marks = [len(r) for r in a._rows]

    if rebuild:
        failed = (sc.fail_device if sc.fail_device is not None
                  else sc.n_devices - 1)
        a.fail_device(failed)
        a.rebuild_device(failed)
        marks[failed] = 0   # replacement lane: all rows are storm phase
    post_rebuild = [len(r) for r in a._rows]

    if host:
        host_fill = max(1, int(round(
            a.zone_pages * (sc.host_occupancy
                            if sc.host_occupancy is not None
                            else sc.occupancy))))
        for z in range(n_filled, min(2 * n_filled, a.n_zones)):
            a.zone_write(z, host_fill)

    if host and rebuild:
        # contended: merge the rebuild tail and the host tail per lane
        # round-robin -- appended sequentially they would serialize on
        # the member's LUN clock instead of contending
        for lane in range(sc.n_devices):
            rows = a._rows[lane]
            prefix = rows[: marks[lane]]
            reb = rows[marks[lane]: post_rebuild[lane]]
            hst = rows[post_rebuild[lane]:]
            a._rows[lane] = prefix + _rr_merge(hst, reb)
    return a, marks


def rebuild_storm(eng: ZoneEngine, scenarios: Sequence[StormScenario], *,
                  obs=None, pad_quantum: int = 64) -> Dict:
    """Run K rebuild-storm scenarios as one batched dispatch.

    Returns ``{"scenarios": [per-scenario report dicts],
    "telemetry": [per-scenario contended telemetry] | None}``; each
    report carries the legacy rebuild mode's keys (rebuild pages /
    traffic, host / rebuild / contended makespans, interference ratio)
    plus the scenario label.
    """
    scenarios = list(scenarios)
    if not scenarios:
        return {"scenarios": [], "telemetry": None}
    arrays: List[ArrayEngine] = []
    skips: List[List[int]] = []
    for sc in scenarios:
        for host, rebuild in ((True, False), (False, True), (True, True)):
            a, marks = _build_variant(eng, sc, host=host, rebuild=rebuild)
            arrays.append(a)
            skips.append(marks)

    results = run_array_batch(arrays, obs=obs, pad_quantum=pad_quantum)

    # ONE op-granular timing pass over every lane of every variant,
    # fill-phase pages zeroed so only the storm phase books LUN time
    programs = np.concatenate([r.programs for r in results])
    cols = np.concatenate([r.cols for r in results])
    pages = np.concatenate([r.pages for r in results]).copy()
    lane = 0
    for r, marks in zip(results, skips):
        for m in marks:
            pages[lane, :m] = 0
            lane += 1
    n_tenants = max(a.rebuild_tenant for a in arrays) + 1
    _, _, makespans = run_array_timing(
        eng.flash, programs, cols, pages, n_tenants=n_tenants,
        device=eng.device)

    reports: List[Dict[str, float]] = []
    telemetry = [] if obs is not None else None
    lane = 0
    for k, sc in enumerate(scenarios):
        spans = []
        for v in range(3):
            a = arrays[3 * k + v]
            spans.append(float(
                makespans[lane: lane + a.geom.n_devices].max()))
            lane += a.geom.n_devices
        host_s, rebuild_s, contended_s = spans

        reb_arr = arrays[3 * k + 1]
        reb_res = results[3 * k + 1]
        failed = (sc.fail_device if sc.fail_device is not None
                  else sc.n_devices - 1)
        reb_mask = reb_res.tenants == reb_arr.rebuild_tenant
        is_read = reb_res.programs[:, :, 0] == zengine.OP_READ
        reports.append({
            "scenario": sc.describe(),
            "n_devices": float(sc.n_devices),
            "failed_device": float(failed),
            "rebuild_pages": float(
                reb_res.pages[failed][reb_mask[failed]].sum()),
            "rebuild_traffic_pages": float(
                reb_res.pages[reb_mask].sum()),
            "rebuild_read_pages": float(
                reb_res.pages[reb_mask & is_read].sum()),
            "host_makespan_s": host_s,
            "rebuild_makespan_s": rebuild_s,
            "contended_makespan_s": contended_s,
            "rebuild_interference": (contended_s / host_s if host_s
                                     else float("inf")),
        })
        if telemetry is not None:
            telemetry.append(results[3 * k + 2].telemetry)
    return {"scenarios": reports, "telemetry": telemetry}
