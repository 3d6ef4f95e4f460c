"""Every paper table and figure on the port, timed: the counterpart of the
reference's ``benchmarks/run.py``.

    PYTHONPATH=src python -m repro_torch.tools.run_figures [--device cuda|cpu]

Prints one ``name,us_per_call,derived`` CSV row a figure, with the
reference's row names and derived keys in its order, then the roofline
summary of the dry-run JSONs under ``results/dryrun`` (``skipped=`` with
the reason where they cannot be read).  Runs on the card unless
``--device cpu`` is given; on the CPU the page-granular timing of Fig.
4b, Fig. 9 and Table 3 steps the plain loop, minutes a figure.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core import SUPERBLOCK, workloads, zn540
from repro_torch.tools import ckpt_zns, paper_figures, roofline_report


class Bench:
    """Collects (name, us_per_call, derived) rows (the reference's
    ``benchmarks/common.Bench``)."""

    def __init__(self):
        self.rows: List[Tuple[str, float, str]] = []

    def timeit(self, name: str, fn: Callable[[], Dict], derived_keys=()):
        t0 = time.perf_counter()
        out = fn() or {}
        us = (time.perf_counter() - t0) * 1e6
        derived = ";".join(f"{k}={out[k]:.4g}" if isinstance(out[k], float)
                           else f"{k}={out[k]}"
                           for k in derived_keys if k in out)
        self.rows.append((name, us, derived))
        return out

    def add(self, name: str, us: float, derived: str = ""):
        self.rows.append((name, us, derived))

    def emit(self) -> None:
        for name, us, derived in self.rows:
            print(f"{name},{us:.1f},{derived}")


def engine_batched_drivers(*, device="cuda") -> dict:
    """The fig4a/fig4b workloads through the batched engine: the dlwa
    occupancy sweep as one dispatch and interference as fused
    finish+host-write programs, with the measured speedup over the
    legacy per-op loop."""
    rep = workloads.engine_vs_legacy_speedup(
        occupancies=tuple(float(o) for o in np.linspace(0.05, 0.95, 16)),
        n_zones=8, concurrencies=(1, 2, 4, 7), repeats=2, device=device)
    flash, zone = zn540()
    eng = workloads.make_engine(flash, zone, SUPERBLOCK, max_active=28,
                                device=device)
    sweep = workloads.dlwa_sweep_engine(
        eng, (0.1, 0.3, 0.5, 0.7, 0.9), n_zones=4)
    rep["dlwa_at_10pct"] = sweep[0]["dlwa"]
    return rep


#: each row's derived keys, rows in the reference's order
DERIVED = {
    "fig4a_7a_dlwa_vs_occupancy": ("reduction_at_10pct", "paper_claim"),
    "fig4b_7d_interference": ("worst_baseline", "worst_silentzns"),
    "fig7b_sa_dlwa_tradeoff": ("dlwa_reduction_at_low_thr",
                               "sa_increase_delaying_finish",
                               "paper_sa_increase"),
    "fig7c_wear": ("baseline_erases", "silentzns_erases",
                   "erase_reduction"),
    "fig7c_wear_leveling": ("baseline_max_wear", "silentzns_max_wear",
                            "baseline_std", "silentzns_std"),
    "fig8_geometry_sweep": ("fixed_over_vchunk2_P8S128", "paper_claim"),
    "fig9_throughput": ("peak_P16_1job", "P8_1job", "P8_2jobs"),
    "table3_interference": ("fixed_minus_vchunk2_multiseg",),
    "table4_alloc_latency": ("fixed_us", "superblock_us", "block_us"),
    "ckpt_zns_all_archs": ("mean_dlwa_reduction", "worst_baseline_dlwa"),
    "engine_batched_drivers": ("dlwa_speedup", "interference_speedup",
                               "dlwa_engine_ops_s", "dlwa_legacy_ops_s",
                               "dlwa_at_10pct"),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = {"device": args.device}
    # every figure at its defaults: the paper's sizes (1M ops for fig7b /
    # 7c, the floor that pressures the active-zone budget)
    calls = {
        "ckpt_zns_all_archs": lambda: ckpt_zns.run_all(**dev),
        "engine_batched_drivers": lambda: engine_batched_drivers(**dev),
    }
    b = Bench()
    for name, keys in DERIVED.items():
        b.timeit(name, calls.get(name) or (
            lambda name=name: getattr(paper_figures, name)(**dev)), keys)

    try:
        s = roofline_report.summary()
        b.add("roofline_dryrun_summary", 0.0,
              ";".join(f"{k}={v}" for k, v in s.items()))
    except Exception as e:  # noqa: BLE001 -- dry-run results may be absent
        b.add("roofline_dryrun_summary", 0.0, f"skipped={e}")

    b.emit()


if __name__ == "__main__":
    main()
