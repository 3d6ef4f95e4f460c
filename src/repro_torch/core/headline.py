"""The paper's headline figures as batched engine dispatches, PyTorch port.

The paper's summary numbers -- ~92% lower DLWA at 10% occupancy, less
wear, faster workload execution -- compare SilentZNS (a zone = an
arbitrary block collection committed on the fly) against the
traditional static logical-to-physical mapping (a zone's whole block set
committed at allocation).  As in ``repro.core.headline``, each figure is
ONE batched :func:`repro_torch.core.engine.run_programs` dispatch over
paired lanes of a *union* engine:

* the **traditional** lane runs ``alloc_policy="traditional"`` on the
  whole-zone-commitment element spec (``hchunk(n_segments)``);
* the **silent** lane runs ``alloc_policy="silent"`` on ``BLOCK``
  granularity, committing only the erase blocks the write at hand needs
  and growing the zone on demand.

Figures: :func:`dlwa_figure` (DLWA vs occupancy), :func:`wear_figure`
(block erases under RESET churn), :func:`exec_figure` (execution time
through :func:`repro_torch.core.timing.simulate_fleet_ops`).
:func:`paper_report` assembles all three; at the zn540 geometry it
reproduces the reference's ``BENCH_paper.json`` figures.

Run ``python -m repro_torch.core.headline [--device cpu]`` to print the
report as JSON.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import engine as zengine
from repro_torch.core import timing, workloads
from repro_torch.core.elements import BLOCK, ElementSpec, hchunk
from repro_torch.core.engine import ZoneEngine, stack_dyn
from repro_torch.core.geometry import FlashGeometry, ZoneGeometry, zn540
from repro_torch.kernels.zns_alloc import ops as zns_ops

#: occupancy sweep of the DLWA figure (10% first: the gated point)
DEFAULT_OCCUPANCIES: Tuple[float, ...] = (0.1, 0.2, 0.3, 0.5, 0.7, 0.9)


def traditional_spec(zone_geom: ZoneGeometry) -> ElementSpec:
    """The traditional mapping's element spec: one element = one LUN's
    whole zone span (``hchunk(n_segments)``), so allocation commits --
    and FINISH pads -- the full zone, exactly like a static
    logical-to-physical zone table.  (FIXED models the same commitment
    but cannot join a spec union; hchunk at the full segment count is
    its gridded equivalent.)"""
    return hchunk(zone_geom.n_segments)


def build_headline_engine(flash: Optional[FlashGeometry] = None,
                          zone_geom: Optional[ZoneGeometry] = None, *,
                          max_active: int = 14,
                          device="cuda") -> ZoneEngine:
    """The union engine both policies share (defaults to the zn540
    model): one dispatch can then pair traditional whole-zone lanes
    with silent BLOCK lanes."""
    if (flash is None) != (zone_geom is None):
        raise ValueError("flash and zone_geom must be given together")
    if flash is None:
        flash, zone_geom = zn540()
    return ZoneEngine(flash, zone_geom,
                      (traditional_spec(zone_geom), BLOCK),
                      max_active=max_active, device=device)


def _policy_dyns(eng: ZoneEngine, n_pairs: int,
                 wear_bound: Optional[int] = None):
    """Stacked per-lane DynConfigs for ``n_pairs`` (traditional,
    silent) lane pairs -- lane ``2k`` traditional, lane ``2k + 1``
    silent."""
    trad = eng.dyn(spec=traditional_spec(eng.zone_geom))
    silent = eng.dyn(spec=BLOCK, alloc_policy="silent",
                     wear_bound=wear_bound)
    return stack_dyn([trad, silent] * n_pairs)


def _assert_all_ok(trace, what: str) -> None:
    ok = trace.ok.cpu().numpy()
    if not ok.all():
        lanes, ops = np.nonzero(~ok)
        raise RuntimeError(
            f"{what}: {int((~ok).sum())} op(s) reported ok=0 "
            f"(first at lane {int(lanes[0])}, op {int(ops[0])})")


def _lane_metric(states, field: str) -> np.ndarray:
    return getattr(states, field).cpu().numpy().astype(np.int64)


def dlwa_figure(eng: ZoneEngine,
                occupancies: Sequence[float] = DEFAULT_OCCUPANCIES, *,
                n_zones: int = 4,
                wear_bound: Optional[int] = None) -> Dict:
    """DLWA vs occupancy, both policies, ONE dispatch.

    Each occupancy point is a fill-to-occupancy + FINISH program
    (:func:`repro.core.workloads.dlwa_program`) executed by a
    traditional lane and a silent lane; the reduction at each point is
    ``1 - silent / traditional``.  The paper's headline gate reads the
    10%-occupancy point."""
    occupancies = [float(o) for o in occupancies]
    programs = np.stack([
        p for o in occupancies
        for p in (workloads.dlwa_program(eng, occupancy=o,
                                         n_zones=n_zones),) * 2])
    dyn = _policy_dyns(eng, len(occupancies), wear_bound)
    states, trace = eng.run_batch(eng.init_state(), programs, dyn)
    _assert_all_ok(trace, "dlwa_figure")
    host = _lane_metric(states, "host_pages")
    dummy = _lane_metric(states, "dummy_pages")
    dlwa = (host + dummy) / np.maximum(host, 1)
    trad, silent = dlwa[0::2], dlwa[1::2]
    return {
        "occupancies": occupancies,
        "n_zones": float(n_zones),
        "traditional_dlwa": [float(x) for x in trad],
        "silent_dlwa": [float(x) for x in silent],
        "dlwa_reduction": [float(1.0 - s / t)
                           for s, t in zip(silent, trad)],
    }


def dlwa_reduction_at(figure: Dict, occupancy: float = 0.1) -> float:
    """The DLWA reduction at the sweep point nearest ``occupancy``
    (the 10% point is the gated headline number)."""
    occs = figure["occupancies"]
    i = int(np.argmin(np.abs(np.asarray(occs) - occupancy)))
    return float(figure["dlwa_reduction"][i])


def _churn_program(eng: ZoneEngine, *, occupancy: float, n_zones: int,
                   cycles: int) -> np.ndarray:
    """``cycles`` rounds of fill-to-occupancy + FINISH + RESET over
    ``n_zones`` zones: re-allocation after RESET is what converts
    pinned-but-dirty blocks into deferred erases (paper §5), so this is
    the traffic where the policies' wear diverges."""
    zp = int(eng.cfg.zone_pages)
    host = min(zp, max(1, int(round(zp * occupancy))))
    rows = []
    for _ in range(cycles):
        for z in range(n_zones):
            rows += [(zengine.OP_WRITE, z, host, zengine.F_HOST),
                     (zengine.OP_FINISH, z, 0, 0),
                     (zengine.OP_RESET, z, 0, 0)]
    return zengine.encode_program(rows)


def wear_figure(eng: ZoneEngine, *, occupancy: float = 0.3,
                n_zones: int = 8, cycles: int = 8,
                wear_bound: Optional[int] = None) -> Dict:
    """Total block erases under RESET churn, both policies, ONE
    dispatch.  The traditional lane re-commits (and therefore
    re-erases) every block of the zone each cycle; the silent lane only
    ever touches the blocks the occupancy needs."""
    program = _churn_program(eng, occupancy=occupancy, n_zones=n_zones,
                             cycles=cycles)
    programs = np.stack([program, program])
    dyn = _policy_dyns(eng, 1, wear_bound)
    states, trace = eng.run_batch(eng.init_state(), programs, dyn)
    _assert_all_ok(trace, "wear_figure")
    erases = _lane_metric(states, "block_erases")
    trad, silent = int(erases[0]), int(erases[1])
    return {
        "occupancy": float(occupancy),
        "n_zones": float(n_zones),
        "cycles": float(cycles),
        "traditional_erases": float(trad),
        "silent_erases": float(silent),
        "wear_reduction": float(1.0 - silent / trad) if trad else 0.0,
    }


def exec_figure(eng: ZoneEngine, *, occupancy: float = 0.3,
                n_zones: int = 8, cycles: int = 4,
                wear_bound: Optional[int] = None) -> Dict:
    """Workload execution time, both policies, ONE engine dispatch +
    ONE batched timing dispatch.

    Both lanes execute identical host traffic; the traditional lane's
    FINISH ops must additionally program the whole-zone dummy padding,
    which the op-granular fleet timing model
    (:func:`repro.core.timing.simulate_fleet_ops`) prices like any
    other page traffic.  Speedup = traditional makespan / silent
    makespan."""
    program = _churn_program(eng, occupancy=occupancy, n_zones=n_zones,
                             cycles=cycles)
    programs = np.stack([program, program])
    dyn = _policy_dyns(eng, 1, wear_bound)
    states, trace = eng.run_batch(eng.init_state(), programs, dyn)
    _assert_all_ok(trace, "exec_figure")
    # pages an op physically programmed: host writes plus FINISH padding
    pages = trace.host_delta + trace.dummy_delta
    tenants = torch.zeros_like(pages)
    t_page = float(eng.flash.t_prog + eng.flash.t_xfer)
    _, _, makespans = timing.simulate_fleet_ops(
        trace.cols, pages, tenants, t_page, eng.flash.n_luns, 1)
    makespans = makespans.cpu().numpy().astype(np.float64)
    trad, silent = float(makespans[0]), float(makespans[1])
    return {
        "occupancy": float(occupancy),
        "n_zones": float(n_zones),
        "cycles": float(cycles),
        "host_pages": float(int(states.host_pages[0])),
        "traditional_s": trad,
        "silent_s": silent,
        "speedup": trad / silent if silent else 0.0,
    }


def paper_report(flash: Optional[FlashGeometry] = None,
                 zone_geom: Optional[ZoneGeometry] = None, *,
                 occupancies: Sequence[float] = DEFAULT_OCCUPANCIES,
                 dlwa_zones: int = 4, wear_zones: int = 8,
                 wear_cycles: int = 8, exec_cycles: int = 4,
                 wear_bound: Optional[int] = None,
                 max_active: int = 14, device="cuda") -> Dict:
    """All three headline figures, each dispatched twice on ``device``.

    The two passes must agree exactly (a determinism check).  In place
    of the reference's jit recompile probe -- a JAX compile-cache
    concept with no counterpart here -- ``"launches"`` records how many
    times each pass launched the ``zns_alloc`` selection kernel (0 on
    the CPU, where the kernel's plain version runs instead)."""
    eng = build_headline_engine(flash, zone_geom, max_active=max_active,
                                device=device)

    def figures():
        return {
            "dlwa": dlwa_figure(eng, occupancies, n_zones=dlwa_zones,
                                wear_bound=wear_bound),
            "wear": wear_figure(eng, n_zones=wear_zones,
                                cycles=wear_cycles,
                                wear_bound=wear_bound),
            "exec": exec_figure(eng, n_zones=wear_zones,
                                cycles=exec_cycles,
                                wear_bound=wear_bound),
        }

    passes = []
    for _ in range(2):
        before = sum(zns_ops.counts.values())
        passes.append((figures(), sum(zns_ops.counts.values()) - before))
    (first, n_first), (out, n_second) = passes
    for name in first:
        assert first[name] == out[name], (
            f"paper figure {name!r} is not deterministic across "
            f"repeated dispatches")
    out["dlwa"]["reduction_at_10pct"] = dlwa_reduction_at(out["dlwa"])
    out["launches"] = {"zns_alloc_per_pass": [float(n_first),
                                              float(n_second)]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Print the paper headline report as JSON.")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(paper_report(device=args.device), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
