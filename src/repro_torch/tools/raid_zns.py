"""ZNS-RAID fleet benchmark on the port: device count x chunk x parity x
allocator (the counterpart of the reference's ``benchmarks/raid_zns.py``).

Engine-native by default: the sweep and the rebuild mode compile their
array workloads into encoded op programs and execute each cell as one
batched ``run_programs`` dispatch (:class:`repro_torch.array.ArrayEngine`),
with op-granular fleet timing.  ``--legacy`` runs the object
:class:`repro_torch.array.ZNSArray` pipeline over per-op device shims
instead, the bit-exactness oracle.

Modes (``name,us_per_call,derived`` CSV rows, as ``tools/run_figures``):

* sweep (default)::

      PYTHONPATH=src python -m repro_torch.tools.raid_zns [--quick] [--legacy]

  crosses device count x stripe-chunk size x parity on/off x allocator
  spec, one row a cell;
* single end-to-end run (``--devices 8 --parity``): ZoneFS traffic over
  the array, FINISHed, the fleet timed; per-device DLWA / wear and the
  fleet makespan;
* rebuild after failure (``--rebuild --devices 4``): a member failed and
  rebuilt onto a replacement, the rebuild traffic's makespan and its
  interference with concurrent host writes (one
  :func:`repro_torch.array.rebuild_storm` scenario engine-native).

Every mode runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

from repro_torch.array import (ArrayEngine, StormScenario, ZNSArray,
                               rebuild_storm)
from repro_torch.core import BLOCK, FIXED, SUPERBLOCK, timing, vchunk, zn540
from repro_torch.core.elements import ElementSpec
from repro_torch.core.engine import ZoneEngine
from repro_torch.storage import ZoneFS
from repro_torch.tools.run_figures import Bench

SPECS: Dict[str, ElementSpec] = {
    "fixed": FIXED, "superblock": SUPERBLOCK, "block": BLOCK,
    "vchunk2": vchunk(2),
}
#: each sweep row's derived keys
SWEEP_KEYS = ("dlwa", "parity_overhead", "max_device_dlwa",
              "fleet_makespan_s", "total_block_erases")


def build_array(n_devices: int, chunk_pages: Optional[int], parity: bool,
                spec: ElementSpec, *, device="cuda") -> ZNSArray:
    flash, zone = zn540()
    return ZNSArray.build(flash, zone, spec, n_devices=n_devices,
                          chunk_pages=chunk_pages, parity=parity,
                          max_active=14, device=device)


def raid_benchmark(*, n_devices: int, chunk_pages: Optional[int] = None,
                   parity: bool = False, spec: ElementSpec = SUPERBLOCK,
                   occupancy: float = 0.5, n_zones: int = 4,
                   legacy: bool = False, device="cuda") -> Dict:
    """Fill ``n_zones`` superzones to ``occupancy``, FINISH each, and
    fleet-time the resulting traffic (data + parity + FINISH padding).

    Engine-native (default): the workload compiles to member op
    programs, one batched dispatch executes them, and op-granular
    ``simulate_fleet_ops`` times the fleet.  ``legacy``: the object
    array + page-granular ``run_fleet_trace``."""
    if legacy:
        arr = build_array(n_devices, chunk_pages, parity, spec,
                          device=device)
        pages = max(1, int(round(arr.zone_pages * occupancy)))
        tagged = []
        for z in range(min(n_zones, arr.max_active, arr.n_zones)):
            tagged += arr.zone_write(z, pages, trace=True) or []
            tagged += arr.zone_finish(z, trace=True) or []
        fleet = timing.run_fleet_trace(
            arr.flash, timing.group_tagged(tagged, n_devices),
            device=device)
        rep = arr.report()
        rep["fleet_makespan_s"] = fleet["fleet_makespan_s"]
        rep["fleet_pages"] = float(fleet["n"])
        for i in range(n_devices):
            rep[f"dev{i}_makespan_s"] = fleet[f"dev{i}_makespan_s"]
        per = arr.device_reports()
        rep["mean_device_dlwa"] = sum(r["dlwa"] for r in per) / len(per)
        return rep

    flash, zone = zn540()
    arr = ArrayEngine.build(flash, zone, spec, n_devices=n_devices,
                            chunk_pages=chunk_pages, parity=parity,
                            max_active=14, device=device)
    pages = max(1, int(round(arr.zone_pages * occupancy)))
    for z in range(min(n_zones, arr.max_active, arr.n_zones)):
        arr.zone_write(z, pages)
        arr.zone_finish(z)
    # unpadded: the reference pads every cell's programs to one quantum
    # of 256 op steps so that one compiled program serves the sweep; here
    # a padding step is a whole engine step on the card that changes
    # nothing, and the reports are the same without it
    arr.run()
    rep = arr.report()
    rep.update(arr.fleet_timing())
    per = arr.device_reports()
    rep["mean_device_dlwa"] = sum(r["dlwa"] for r in per) / len(per)
    return rep


class TracingArray(ZNSArray):
    """ZNSArray that records every member IOTrace it emits, so hosts
    that never ask for traces (ZoneFS) can still be fleet-timed."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.tagged: list = []

    def zone_write(self, zone_id, n_pages, *, host=True, trace=False):
        out = super().zone_write(zone_id, n_pages, host=host, trace=True)
        self.tagged += out
        return out if trace else None

    def zone_finish(self, zone_id, *, trace=False):
        out = super().zone_finish(zone_id, trace=True)
        self.tagged += out or []
        return out if trace else None


def fleet_run(args: argparse.Namespace) -> Dict:
    """End-to-end: KV-style ZoneFS traffic over the array, then fleet
    timing of that same traffic; prints per-device DLWA / wear and the
    fleet makespan.  ZoneFS mounts :class:`ArrayEngine` (commands
    validate against the superzone mirror and accumulate as member op
    programs; one dispatch executes the mount, one timing dispatch
    scores it), or with ``--legacy`` the object ``ZNSArray`` whose
    recorded IO traces are timed.  Returns the array's report with the
    file system's and the makespan."""
    spec = SPECS[args.spec]
    flash, zone = zn540()
    cls = TracingArray if args.legacy else ArrayEngine
    arr = cls.build(flash, zone, spec, n_devices=args.devices,
                    chunk_pages=args.chunk_pages,
                    parity=args.parity, max_active=14, device=args.device)
    fs = ZoneFS(arr, finish_threshold=args.finish_threshold)
    # rotating create/delete traffic: files of ~1/3 superzone, lifetimes
    # cycling so zones mix and FINISH/RESET both fire
    file_pages = max(1, arr.zone_pages // 3)
    live = []
    for fid in range(args.files):
        if not fs.create(fid, file_pages, lifetime=fid % 3):
            break
        live.append(fid)
        if len(live) > 6:
            fs.delete(live.pop(0))
    for z, info in arr.zones.items():
        if info.state.name == "OPEN":
            fs.dev.zone_finish(z)

    if args.legacy:
        fleet = timing.run_fleet_trace(
            arr.flash, timing.group_tagged(arr.tagged, args.devices),
            device=args.device)
        makespan = fleet["fleet_makespan_s"]
    else:
        arr.run()                   # unpadded, as in raid_benchmark
        makespan = arr.fleet_timing()["fleet_makespan_s"]

    rep = arr.report()
    rep.update(fs.report())
    rep["fleet_makespan_s"] = makespan
    print(f"# array {arr.geom.describe()} spec={args.spec} "
          f"finish_threshold={args.finish_threshold} "
          f"({'legacy object array' if args.legacy else 'engine'})")
    print("device,dlwa,host_pages,dummy_pages,total_block_erases,"
          "max_wear,cv_wear,failed")
    for r in arr.device_reports():
        print(f"{int(r['device'])},{r['dlwa']:.4f},{int(r['host_pages'])},"
              f"{int(r['dummy_pages'])},{int(r['total_block_erases'])},"
              f"{int(r['max_wear'])},{r['cv_wear']:.4f},"
              f"{int(r['failed'])}")
    print(f"array_dlwa,{rep['dlwa']:.4f}")
    print(f"parity_overhead,{rep['parity_overhead']:.4f}")
    print(f"sa,{rep['sa']:.4f}")
    print(f"fleet_makespan_s,{rep['fleet_makespan_s']:.6f}")
    return rep


def rebuild_run_legacy(args: argparse.Namespace) -> Dict:
    """The object-pipeline rebuild mode: fill, fail, rebuild via tagged
    traces, three per-scenario ``run_fleet_trace`` calls."""
    spec = SPECS[args.spec]
    flash, zone = zn540()
    n_dev = max(2, args.devices or 4)
    arr = ZNSArray.build(flash, zone, spec, n_devices=n_dev,
                         chunk_pages=args.chunk_pages, parity=True,
                         max_active=14, device=args.device)
    fill = max(1, int(round(arr.zone_pages * 0.6)))
    n_filled = min(4, arr.n_zones // 2, arr.max_active)
    for z in range(n_filled):
        arr.zone_write(z, fill)
        arr.zone_finish(z)

    failed = n_dev - 1
    arr.fail_device(failed)
    rebuild_tagged = arr.rebuild_device(failed)

    # concurrent host I/O: fresh superzones written while the rebuild runs
    host_tagged = []
    for z in range(n_filled, min(2 * n_filled, arr.n_zones)):
        host_tagged += arr.zone_write(z, fill, trace=True) or []

    def fleet_of(tagged):
        return timing.run_fleet_trace(
            arr.flash, timing.group_tagged(tagged, n_dev),
            device=args.device)
    base = fleet_of(host_tagged)
    reb = fleet_of(rebuild_tagged)
    cont = fleet_of(host_tagged + rebuild_tagged)
    interference = (cont["fleet_makespan_s"] / base["fleet_makespan_s"]
                    if base["fleet_makespan_s"] else float("inf"))
    rebuilt = sum(len(t.luns) for i, t in rebuild_tagged
                  if i == failed and t.op == "write")
    rep = {
        "n_devices": float(n_dev),
        "failed_device": float(failed),
        # pages re-appended to the replacement (incl. its FINISH padding)
        "rebuild_pages": float(rebuilt),
        # every page the rebuild moves, survivor degraded reads included
        "rebuild_traffic_pages": float(
            sum(len(t.luns) for _, t in rebuild_tagged)),
        "rebuild_makespan_s": reb["fleet_makespan_s"],
        "host_makespan_s": base["fleet_makespan_s"],
        "contended_makespan_s": cont["fleet_makespan_s"],
        "rebuild_interference": interference,
        "replacement_host_pages": float(arr.devices[failed].host_pages),
        "replacement_dummy_pages": float(arr.devices[failed].dummy_pages),
    }
    print(f"# rebuild {arr.geom.describe()} spec={args.spec} "
          f"failed={failed} (legacy)")
    for k, v in rep.items():
        print(f"{k},{v:.6g}")
    return rep


def rebuild_run(args: argparse.Namespace) -> Dict:
    """Engine-native rebuild after failure: one
    :func:`repro_torch.array.rebuild_storm` scenario -- the host /
    rebuild / contended variants compile onto a shared engine and execute
    in one batched dispatch, then one op-granular timing dispatch reports
    the interference ratio."""
    if args.legacy:
        return rebuild_run_legacy(args)
    spec = SPECS[args.spec]
    flash, zone = zn540()
    n_dev = max(2, args.devices or 4)
    eng = ZoneEngine(flash, zone, spec, max_active=14, device=args.device)
    sc = StormScenario(n_devices=n_dev, chunk_pages=args.chunk_pages,
                       n_zones_filled=4, occupancy=0.6)
    out = rebuild_storm(eng, [sc])
    rep = dict(out["scenarios"][0])
    label = rep.pop("scenario")
    print(f"# rebuild {label} spec={args.spec} "
          f"failed={int(rep['failed_device'])} (engine)")
    for k, v in rep.items():
        print(f"{k},{v:.6g}")
    return rep


def sweep_cells(quick: bool) -> list:
    """The sweep's cells, in order: (row name, devices, chunk pages,
    parity, spec name)."""
    flash, zone = zn540()
    seg = zone.segment_pages(flash)
    devices = (1, 2, 4) if quick else (1, 2, 4, 8)
    chunks = (seg,) if quick else (seg, 2 * seg)
    specs = ("fixed", "superblock") if quick else (
        "fixed", "superblock", "vchunk2")
    return [(f"raid_d{n_dev}_c{chunk}_{'p1' if parity else 'p0'}_"
             f"{spec_name}", n_dev, chunk, parity, spec_name)
            for n_dev in devices for chunk in chunks
            for parity in (False, True) if not (parity and n_dev < 2)
            for spec_name in specs]


def sweep(quick: bool, legacy: bool = False, device="cuda") -> Dict:
    """One CSV row a cell; returns each cell's report by row name."""
    b = Bench()
    reps = {}
    for name, n, c, p, s in sweep_cells(quick):
        reps[name] = b.timeit(name, lambda n=n, c=c, p=p, s=s:
                              raid_benchmark(n_devices=n, chunk_pages=c,
                                             parity=p, spec=SPECS[s],
                                             legacy=legacy, device=device),
                              SWEEP_KEYS)
    b.emit()
    return reps


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", type=int, default=0,
                    help="single-run mode with this many member devices")
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--chunk-pages", type=int, default=None)
    ap.add_argument("--spec", choices=sorted(SPECS), default="superblock")
    ap.add_argument("--finish-threshold", type=float, default=0.1)
    ap.add_argument("--files", type=int, default=24)
    ap.add_argument("--rebuild", action="store_true",
                    help="rebuild-after-failure mode: reconstruct a "
                         "replaced member and report interference with "
                         "host I/O")
    ap.add_argument("--legacy", action="store_true",
                    help="run the object ZNSArray pipeline instead of "
                         "the engine-native path (cross-check oracle)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None) -> Dict:
    """Run the mode the command line asks for; returns its report (the
    sweep's: each cell's by row name)."""
    args = parser().parse_args(argv)
    if args.rebuild:
        return rebuild_run(args)
    if args.devices:
        return fleet_run(args)
    return sweep(args.quick, legacy=args.legacy, device=args.device)


if __name__ == "__main__":
    main()
