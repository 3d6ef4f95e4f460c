"""The paper's tables and figures on the port (the counterpart of the
reference's ``benchmarks/paper_figures.py``).

Each ``fig*/table*`` function reproduces one artifact with the
reference's parameters, defaults and returned keys, and runs on
``device`` (``"cuda"`` unless the caller asks for ``"cpu"``).  Where the
reference builds one device per lane, the port builds one batched
dispatch per group of lanes:

* Fig. 4a / 7a, Fig. 8: ``workloads.dlwa_sweep_engine`` (an occupancy
  sweep a dispatch);
* Fig. 4b / 7d, Table 3: ``workloads.interference_sweep_engine``;
* Fig. 9: ``workloads.write_benchmark_engine`` (a point a dispatch);
* Fig. 7b / 7c: the LSM and churn traffic recorded on a
  :class:`~repro_torch.storage.compile.RecordingBackend` and replayed as
  one :func:`~repro_torch.storage.compile.replay_recorders` dispatch per
  spec (every replayed op checked legal), DLWA and wear read off each
  lane's final state;
* Table 4: the device shim (:class:`~repro_torch.core.device.ZNSDevice`),
  since allocation latency is one command's wall time.

Run facts go under keys that start with ``_``: ``_dispatches``,
``_op_steps`` (engine op steps over all dispatches and shim commands,
read off the programs each engine is given: :meth:`RunFacts.watch`),
``_lane_ops``, ``_seconds`` and the kernels' launches during the call
(``_alloc_select``, ``_grow_select``, ``_page_clock``).  On a card an op
step of a non-FIXED engine launches one ``alloc_select`` and one
``grow_select``; a FIXED engine's ALLOC is a plain argmin.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core import (BLOCK, FIXED, PAPER_GEOMETRIES, SUPERBLOCK,
                              ZNSDevice, ZoneGeometry, custom16, hchunk,
                              is_applicable, vchunk, workloads, zn540)
from repro_torch.core.alloc_exact import AVAIL_INVALID
from repro_torch.core.engine import DeviceState, ZoneEngine
from repro_torch.kernels.page_clock import ops as pc_ops
from repro_torch.kernels.zns_alloc import ops as zns_ops
from repro_torch.storage import (KVBenchConfig, LSMSimulator,
                                 RecordingBackend, ZoneFS, lane_metrics,
                                 lane_state, replay_recorders)

ELEMENTS = (FIXED, SUPERBLOCK, BLOCK, vchunk(2), vchunk(4), hchunk(2))


class RunFacts:
    """One figure's run facts: the dispatches and op steps of the engines
    it watches, read off the programs they are given, its seconds and the
    kernels' launches when it ends."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.dispatches = self.op_steps = self.lane_ops = 0
        self._zns = dict(zns_ops.counts)
        self._pc = pc_ops.launches
        self._t0 = time.perf_counter()

    def _count(self, lanes: int, n_ops: int) -> None:
        self.op_steps += n_ops
        self.lane_ops += lanes * n_ops

    def watch(self, eng: ZoneEngine) -> ZoneEngine:
        """``eng`` with its work counted: each ``run`` (one lane) and
        ``run_batch`` (a lane a program) a dispatch of the program's op
        steps, each ``apply`` (a shim command, or a step of its warm-up)
        one op step."""
        run, run_batch, apply = eng.run, eng.run_batch, eng.apply

        def counted_run(state, program, *args, **kw):
            self.dispatches += 1
            self._count(1, len(program))
            return run(state, program, *args, **kw)

        def counted_run_batch(state, programs, *args, **kw):
            self.dispatches += 1
            self._count(*programs.shape[:2])
            return run_batch(state, programs, *args, **kw)

        def counted_apply(*args, **kw):
            self._count(1, 1)
            return apply(*args, **kw)
        eng.run, eng.run_batch, eng.apply = (counted_run, counted_run_batch,
                                             counted_apply)
        return eng

    def close(self, out: Dict) -> Dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out.update(
            _dispatches=self.dispatches, _op_steps=self.op_steps,
            _lane_ops=self.lane_ops,
            _seconds=time.perf_counter() - self._t0,
            _alloc_select=zns_ops.counts["alloc_select"]
            - self._zns["alloc_select"],
            _grow_select=zns_ops.counts["grow_select"]
            - self._zns["grow_select"],
            _page_clock=pc_ops.launches - self._pc)
        return out


def sha256(program: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        program, dtype=np.int32).tobytes()).hexdigest()


def recorder(eng: ZoneEngine) -> RecordingBackend:
    """A bare recorder with ``eng``'s window and active limit.  (A
    ``for_engine`` recorder would replay its whole program again when a
    front end's report reads its DLWA; the figures read DLWA off the
    batched replay instead.)"""
    return RecordingBackend(eng.flash, zone_pages=eng.cfg.zone_pages,
                            n_zones=eng.cfg.n_zones,
                            max_active=eng.cfg.max_active)


def same_programs(recordings: Sequence[RecordingBackend], what: str
                  ) -> None:
    """The recorders' programs are equal (by sha256): the specs' zone
    pages, zone counts and active limits agree, so the front end took
    the same decisions on each."""
    digests = {sha256(r.program()) for r in recordings}
    if len(digests) != 1:
        raise AssertionError(f"{what}: the specs' recorded programs "
                             f"differ ({len(digests)} digests)")


def lane_wear_report(eng: ZoneEngine, state: DeviceState
                     ) -> Dict[str, float]:
    """:func:`repro_torch.core.metrics.wear_report` of the device whose
    final state is ``state`` (one lane): pending erases are the INVALID
    elements' blocks, not yet re-allocated."""
    w = eng.block_wear(state)
    avail = state.elem_avail[: eng.layout.n_elements].cpu().numpy()
    erases = int(state.block_erases)
    pending = (int((avail == AVAIL_INVALID).sum())
               * eng.layout.blocks_per_element)
    return {
        "total_block_erases": float(erases),
        "pending_block_erases": float(pending),
        "total_incl_pending": float(erases + pending),
        "mean_wear": float(w.mean()),
        "max_wear": float(w.max()),
        "std_wear": float(w.std()),
        "cv_wear": float(w.std() / w.mean()) if w.mean() > 0 else 0.0,
    }


# --------------------------------------------------------------------- #
def fig4a_7a_dlwa_vs_occupancy(*, device="cuda") -> Dict:
    """Fig. 4a / 7a: DLWA vs zone occupancy, baseline vs SilentZNS
    (ZN540 model).  Paper: -86.36% at 10% occupancy w/ superblock."""
    run = RunFacts(device)
    flash, zone = zn540()
    occs = (0.1, 0.3, 0.5, 0.7, 0.9)
    sweeps = {}
    for name, spec in (("baseline", FIXED), ("silentzns", SUPERBLOCK)):
        eng = run.watch(workloads.make_engine(flash, zone, spec,
                                              device=device))
        sweeps[name] = workloads.dlwa_sweep_engine(eng, occs, n_zones=4)
    rows = [{"occupancy": occ, "baseline_dlwa": b["dlwa"],
             "silentzns_dlwa": s["dlwa"]}
            for occ, b, s in zip(occs, sweeps["baseline"],
                                 sweeps["silentzns"])]
    r10 = rows[0]
    reduction = (r10["baseline_dlwa"] - r10["silentzns_dlwa"]) \
        / r10["baseline_dlwa"]
    return run.close({"rows": rows, "reduction_at_10pct": reduction,
                      "paper_claim": 0.8636})


def fig4b_7d_interference(*, device="cuda") -> Dict:
    """Fig. 4b / 7d: FINISH-vs-host interference vs concurrency.  Each
    spec's sweep rows stand whole under ``_sweeps``."""
    run = RunFacts(device)
    flash, zone = zn540()
    concs = (1, 2, 3, 4, 5, 6, 7)
    sweeps = {}
    for name, spec in (("baseline", FIXED), ("silentzns", SUPERBLOCK)):
        eng = run.watch(workloads.make_engine(flash, zone, spec,
                                              max_active=28, device=device))
        sweeps[spec.name] = workloads.interference_sweep_engine(eng, concs)
    rows = [{"concurrency": c, "baseline": b["interference"],
             "silentzns": s["interference"]}
            for c, b, s in zip(concs, sweeps["fixed"],
                               sweeps["superblock"])]
    return run.close({
        "rows": rows,
        "worst_baseline": max(r["baseline"] for r in rows),
        "worst_silentzns": max(r["silentzns"] for r in rows),
        "_sweeps": sweeps})


def fig7b_sa_dlwa_tradeoff(n_ops: int = 1_000_000, *, device="cuda"
                           ) -> Dict:
    """Fig. 1 / 7b: SA rises as FINISH is delayed; baseline DLWA falls;
    SilentZNS keeps DLWA ~1 at every threshold.  Each (threshold, spec)
    run is recorded; each spec's five thresholds replay as one
    dispatch."""
    run = RunFacts(device)
    flash, zone = zn540()
    thresholds = (0.1, 0.3, 0.5, 0.7, 0.9)
    specs = (("baseline", FIXED), ("silentzns", SUPERBLOCK))
    engines = {name: run.watch(workloads.make_engine(
        flash, zone, spec, max_active=14, device=device))
        for name, spec in specs}
    recs = {name: [] for name, _ in specs}
    rows = []
    for thr in thresholds:
        row = {"threshold": thr}
        for name, _ in specs:
            rec = recorder(engines[name])
            sim = LSMSimulator(ZoneFS(rec, finish_threshold=thr),
                               KVBenchConfig(n_ops=n_ops,
                                             max_concurrent_jobs=6))
            row["sa"] = sim.run()["sa"]   # host metric: same on both
            recs[name].append(rec)
        same_programs([recs[name][-1] for name, _ in specs],
                      f"fig7b threshold {thr}")
        rows.append(row)
    for name, _ in specs:
        eng = engines[name]
        res = replay_recorders(eng, recs[name], check=True)
        for k, row in enumerate(rows):
            row[f"{name}_dlwa"] = lane_metrics(eng, res, k)["dlwa"]
    lo, hi = rows[0], rows[-1]
    return run.close({
        "rows": rows,
        "dlwa_reduction_at_low_thr":
            (lo["baseline_dlwa"] - lo["silentzns_dlwa"])
            / lo["baseline_dlwa"],
        "sa_increase_delaying_finish": hi["sa"] / lo["sa"] - 1.0,
        "paper_sa_increase": 0.69,
        "_recorded_ops": [len(r) for r in recs["baseline"]],
    })


def fig7c_wear(n_ops: int = 1_000_000, repeats: int = 4, *,
               device="cuda") -> Dict:
    """Fig. 7c: total erase counts under repeated KVBench (the paper
    repeats the workload 8x to accumulate wear).  Each device's runs
    are recorded on one mount and replayed as one lane."""
    run = RunFacts(device)
    flash, zone = zn540()
    out, recs = {}, []
    for name, spec, aware in (("baseline", FIXED, False),
                              ("silentzns", SUPERBLOCK, True)):
        eng = run.watch(workloads.make_engine(
            flash, zone, spec, max_active=14, wear_aware=aware,
            device=device))
        rec = recorder(eng)
        fs = ZoneFS(rec, finish_threshold=0.1)
        for rep_i in range(repeats):
            LSMSimulator(fs, KVBenchConfig(
                n_ops=n_ops, seed=rep_i, max_concurrent_jobs=6)).run()
        recs.append(rec)
        res = replay_recorders(eng, [rec], check=True)
        out[name] = lane_wear_report(eng, lane_state(res, 0))
    same_programs(recs, "fig7c_wear")
    return run.close({
        "baseline_erases": out["baseline"]["total_incl_pending"],
        "silentzns_erases": out["silentzns"]["total_incl_pending"],
        "erase_reduction": 1 - out["silentzns"]["total_incl_pending"]
        / max(1, out["baseline"]["total_incl_pending"]),
        "_wear": out,
        "_recorded_ops": len(recs[0]),
    })


def fig7c_wear_leveling(rounds: int = 400, *, device="cuda") -> Dict:
    """Fig. 7c (distribution): isolate the leveling effect -- identical
    partial-fill churn under wear-aware SilentZNS vs the wear-oblivious
    first-fit baseline; compare the spread of per-block erase counts.
    Both lanes run the one recorded churn in one dispatch, each with
    its own ``wear_aware``."""
    run = RunFacts(device)
    flash, zone = zn540()
    eng = run.watch(workloads.make_engine(flash, zone, SUPERBLOCK,
                                          max_active=14, device=device))
    rec = recorder(eng)
    for i in range(rounds):
        z = i % 8
        rec.zone_write(z, max(1, rec.zone_pages // 3))
        rec.zone_finish(z)
        rec.zone_reset(z)
    lanes = (("baseline", False), ("silentzns", True))
    res = replay_recorders(
        eng, [rec] * len(lanes), check=True,
        dyns=[eng.dyn(wear_aware=aware) for _, aware in lanes])
    out = {}
    for k, (name, _) in enumerate(lanes):
        w = eng.block_wear(lane_state(res, k)) + 0.0
        out[name] = {"max": float(w.max()), "std": float(w.std()),
                     "total": float(w.sum())}
    return run.close({
        "baseline_max_wear": out["baseline"]["max"],
        "silentzns_max_wear": out["silentzns"]["max"],
        "baseline_std": out["baseline"]["std"],
        "silentzns_std": out["silentzns"]["std"],
        "_wear": out,
        "_recorded_ops": len(rec),
    })


def fig8_geometry_sweep(*, geometries=PAPER_GEOMETRIES, device="cuda"
                        ) -> Dict:
    """Fig. 8: pages finished across 6 zone geometries x 6 elements x
    occupancy; one occupancy sweep a (geometry, element) pair.
    ``geometries`` narrows the grid (the CPU tests run one)."""
    run = RunFacts(device)
    flash = custom16()
    occs = (0.0001, 0.1, 0.5, 0.9, 0.9999)
    rows: List[Dict] = []
    pairs = [(g, s) for g in geometries for s in ELEMENTS
             if is_applicable(s, g, flash)]
    for geom, spec in pairs:
        eng = run.watch(workloads.make_engine(flash, geom, spec,
                                              max_active=32, device=device))
        sweep = workloads.dlwa_sweep_engine(eng, occs, n_zones=2)
        rows += [{"geometry": geom.describe(flash), "element": spec.name,
                  "occupancy": occ,
                  "dummy_pages_per_zone": r["dummy_pages_per_zone"]}
                 for occ, r in zip(occs, sweep)]
    # headline: fixed vs vchunk2 at P8,S128 occ ~0
    sel = {(r["geometry"], r["element"]): r["dummy_pages_per_zone"]
           for r in rows if r["occupancy"] == 0.0001}
    key = ("P8, S128", "fixed"), ("P8, S128", "vchunk2")
    ratio = (sel[key[0]] / max(1, sel[key[1]])
             if all(k in sel for k in key) else float("nan"))
    return run.close({"rows": rows, "fixed_over_vchunk2_P8S128": ratio,
                      "paper_claim": 4.0})


def fig9_throughput(*, device="cuda") -> Dict:
    """Fig. 9: intra-zone bandwidth vs request size x concurrent
    zones; one engine a geometry, one dispatch a point, each point's
    whole result under ``_points``."""
    run = RunFacts(device)
    flash = custom16()
    rows, points = [], []
    for P, segs in ((16, 1), (16, 2), (8, 1), (8, 2), (4, 1), (4, 2)):
        geom = ZoneGeometry(parallelism=P, n_segments=segs)
        eng = run.watch(workloads.make_engine(flash, geom, FIXED,
                                              max_active=64, device=device))
        for req_kib in (4, 16, 64):
            for jobs in (1, 2, 4, 8, 16):
                if jobs > eng.cfg.n_zones:
                    continue
                r = dict(workloads.write_benchmark_engine(
                    eng, request_kib=req_kib, n_jobs=jobs, mib_per_job=4),
                    geometry=geom.describe(flash))
                points.append(r)
                rows.append({"geometry": r["geometry"],
                             "request_kib": req_kib, "jobs": jobs,
                             "mib_s": r["bandwidth_mib_s"]})
    peak16 = max(r["mib_s"] for r in rows
                 if r["geometry"] == "P16, S128" and r["jobs"] == 1)
    p8_1 = max(r["mib_s"] for r in rows
               if r["geometry"] == "P8, S64" and r["jobs"] == 1)
    p8_2 = max(r["mib_s"] for r in rows
               if r["geometry"] == "P8, S64" and r["jobs"] == 2)
    return run.close({"rows": rows, "peak_P16_1job": peak16,
                      "P8_1job": p8_1, "P8_2jobs": p8_2,
                      "_points": points})


def table3_interference(*, geometries=PAPER_GEOMETRIES,
                        elements=ELEMENTS, device="cuda") -> Dict:
    """Table 3: interference factor per geometry x element (conc 8 is
    the paper's setting; ZN540-style 40% fill), one interference program
    a dispatch.  The unrounded factors stand under ``_rows``.
    ``geometries`` / ``elements`` narrow the grid (the CPU tests run one
    element a case: the CPU's page-granular timing is a plain loop)."""
    run = RunFacts(device)
    flash = custom16()
    rows, unrounded = [], []
    for geom in geometries:
        row = {"geometry": geom.describe(flash)}
        raw = dict(row)
        for spec in elements:
            if not is_applicable(spec, geom, flash):
                row[spec.name] = raw[spec.name] = float("nan")
                continue
            eng = run.watch(workloads.make_engine(
                flash, geom, spec, max_active=64, device=device))
            conc = min(8, eng.cfg.n_zones // 2)
            r = workloads.interference_sweep_engine(eng, [conc])[0]
            raw[spec.name] = r["interference"]
            row[spec.name] = round(r["interference"], 2)
        rows.append(row)
        unrounded.append(raw)
    multi = [r for r in rows if r["geometry"] in ("P16, S256", "P8, S128")]
    gap = (np.nanmean([r["fixed"] - r["vchunk2"] for r in multi])
           if multi else float("nan"))
    return run.close({"rows": rows,
                      "fixed_minus_vchunk2_multiseg": float(gap),
                      "_rows": unrounded})


def table4_alloc_latency(*, geometries=PAPER_GEOMETRIES, device="cuda"
                         ) -> Dict:
    """Table 4: median zone-allocation latency per geometry x element,
    a shim command's wall time on ``device`` (no batching).

    The reference's ladder (fixed << superblock < vchunk < block) is its
    structure with a MOSEK-free allocator; here every allocation is one
    engine op step, launch-bound on a card (a FIXED engine's launches no
    selection kernel), so the ladder is reported, not asserted.
    ``_n_allocs`` holds each cell's sample count; ``geometries`` as in
    :func:`fig8_geometry_sweep`."""
    run = RunFacts(device)
    flash = custom16()
    rows, counts = [], []
    for geom in geometries:
        row = {"geometry": geom.describe(flash)}
        n = dict(row)
        for spec in ELEMENTS:
            if not is_applicable(spec, geom, flash):
                row[spec.name] = float("nan")
                n[spec.name] = None
                continue
            dev = ZNSDevice(flash, geom, spec, max_active=64,
                            device=device)
            run.watch(dev.engine)
            r = workloads.alloc_latency_benchmark(dev, n_allocs=16)
            row[spec.name] = round(r["median_us"], 1)
            n[spec.name] = r["n_allocs"]
        rows.append(row)
        counts.append(n)

    def med(k):
        return float(np.nanmedian([r.get(k, float("nan")) for r in rows]))
    return run.close({"rows": rows, "fixed_us": med("fixed"),
                      "block_us": med("block"),
                      "superblock_us": med("superblock"),
                      "_n_allocs": counts})
