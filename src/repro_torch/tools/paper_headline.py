"""The paper's headline numbers on the port, one batched dispatch per
figure (the counterpart of the reference's
``benchmarks/paper_headline.py``).

Reproduces the three summary claims -- ~92% lower DLWA at 10%
occupancy, up to 12% less wear, up to 3.7x faster workload execution --
as SilentZNS-policy vs traditional-mapping lane pairs over ONE shared
union engine (see :mod:`repro_torch.core.headline`):

* DLWA vs occupancy (fill + FINISH at each occupancy point);
* total block erases under RESET churn;
* workload execution time via the op-granular fleet timing model.

Usage::

    PYTHONPATH=src python -m repro_torch.tools.paper_headline \
        [--occupancies 0.1,0.3,0.5] [--zones 4] [--wear-zones 8] \
        [--wear-cycles 8] [--exec-cycles 4] [--wear-bound N] \
        [--quick] [--device cuda|cpu] [--out paper_headline.json]

Where the reference prints its jit recompiles on repeat, the port prints
the ``zns_alloc`` launches of each of ``paper_report``'s two passes (0
on the CPU, where the selections' plain versions run).
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core import headline


def _occ_list(text: str):
    try:
        occs = [float(t) for t in text.split(",") if t.strip()]
    except ValueError as exc:
        raise argparse.ArgumentTypeError(
            f"--occupancies expects comma-separated floats, got "
            f"{text!r}") from exc
    if not occs or not all(0.0 < o <= 1.0 for o in occs):
        raise argparse.ArgumentTypeError(
            f"--occupancies values must be in (0, 1], got {text!r}")
    return occs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    ap.add_argument("--occupancies", type=_occ_list,
                    default=list(headline.DEFAULT_OCCUPANCIES),
                    help="DLWA sweep points (comma-separated, in (0,1])")
    ap.add_argument("--zones", type=int, default=4,
                    help="zones per DLWA lane")
    ap.add_argument("--wear-zones", type=int, default=8,
                    help="zones churned by the wear/exec figures")
    ap.add_argument("--wear-cycles", type=int, default=8,
                    help="RESET churn cycles of the wear figure")
    ap.add_argument("--exec-cycles", type=int, default=4,
                    help="churn cycles of the execution-time figure")
    ap.add_argument("--wear-bound", type=int, default=None,
                    help="silent-policy wear-leveling bound in erases "
                         "(default: unbounded)")
    ap.add_argument("--quick", action="store_true",
                    help="small sweep (3 occupancies, 4 zones, "
                         "2 cycles)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engine runs (default: cuda)")
    ap.add_argument("--out", type=str, default="paper_headline.json",
                    help="JSON output path ('' = stdout only)")
    args = ap.parse_args(argv)
    if args.quick:
        args.occupancies = [0.1, 0.3, 0.7]
        args.wear_zones = min(args.wear_zones, 4)
        args.wear_cycles = min(args.wear_cycles, 4)
        args.exec_cycles = min(args.exec_cycles, 2)

    report = headline.paper_report(
        occupancies=args.occupancies, dlwa_zones=args.zones,
        wear_zones=args.wear_zones, wear_cycles=args.wear_cycles,
        exec_cycles=args.exec_cycles, wear_bound=args.wear_bound,
        device=args.device)

    d, w, x = report["dlwa"], report["wear"], report["exec"]
    print("DLWA vs occupancy (traditional -> silent):")
    for o, t, s, r in zip(d["occupancies"], d["traditional_dlwa"],
                          d["silent_dlwa"], d["dlwa_reduction"]):
        print(f"  occ {o:4.0%}: {t:7.3f} -> {s:6.3f}  (-{r:.1%})")
    print(f"DLWA reduction at 10% occupancy: "
          f"{d['reduction_at_10pct']:.1%} (paper: 92%)")
    print(f"wear: {w['traditional_erases']:.0f} -> "
          f"{w['silent_erases']:.0f} block erases "
          f"(-{w['wear_reduction']:.1%}; paper: up to 12%)")
    print(f"execution: {x['traditional_s']:.3f}s -> "
          f"{x['silent_s']:.3f}s  ({x['speedup']:.2f}x; "
          f"paper: up to 3.7x)")
    print(f"zns_alloc launches a pass: "
          f"{report['launches']['zns_alloc_per_pass']}")

    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
