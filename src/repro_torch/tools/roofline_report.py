"""Aggregate the port's dry-run JSONs into the dry-run / roofline tables
(the counterpart of the reference's ``benchmarks/roofline_report.py``).

Reads what ``python -m repro_torch.launch.dryrun --out DIR`` writes, one
JSON a (arch, shape, mesh) cell.  The port's dry run places its leaves on
``meta`` and has no compiler: a cell's memory is its placed arguments'
bytes a rank (``memory.argument_bytes``, where the reference reads XLA's
peak), and ``step_s`` (the meta step's seconds) stands where the
reference has ``compile_s``.  The roofline terms are analytic on the
H100's peaks (``repro_torch.analysis.roofline``).
"""

from __future__ import annotations

import glob
import json
from pathlib import Path
from typing import Dict, List


def load(outdir: str = "results/dryrun") -> List[Dict]:
    return [json.loads(Path(f).read_text())
            for f in sorted(glob.glob(f"{outdir}/*.json"))]


def table(outdir: str = "results/dryrun", mesh: str = "single"
          ) -> List[Dict]:
    rows = []
    for d in load(outdir):
        if d.get("mesh") != mesh:
            continue
        if not d.get("ok"):
            rows.append({"arch": d["arch"], "shape": d["shape"],
                         "ok": False, "error": d.get("error", "")[:80]})
            continue
        r = d["roofline"]
        rows.append({
            "arch": d["arch"], "shape": d["shape"], "ok": True,
            "argument_gb": d["memory"]["argument_bytes"] / 1e9,
            "residency_gb": r.get("residency_gb"),
            "t_compute": r["t_compute_s"], "t_memory": r["t_memory_s"],
            "t_collective": r["t_collective_s"],
            "bottleneck": r["bottleneck"],
            "useful": r["useful_flop_fraction"],
            "roofline_fraction": r["roofline_fraction"],
            "step_s": d.get("step_s"),
        })
    return rows


def markdown(outdir: str = "results/dryrun", mesh: str = "single") -> str:
    out = ["| arch | shape | argument GB a rank | est GB (H100) | t_comp s "
           "| t_mem s | t_coll s | bottleneck | useful | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in table(outdir, mesh):
        if not r["ok"]:
            out.append(f"| {r['arch']} | {r['shape']} | FAIL: "
                       f"{r['error']} | | | | | | |")
            continue
        res = r.get("residency_gb")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['argument_gb']:.1f} "
            f"| {res if res is not None else '-'} "
            f"| {r['t_compute']:.4f} | {r['t_memory']:.4f} "
            f"| {r['t_collective']:.4f} | {r['bottleneck']} "
            f"| {r['useful']:.2f} | {r['roofline_fraction']:.3f} |")
    return "\n".join(out)


def summary(outdir: str = "results/dryrun") -> Dict:
    singles = [r for r in table(outdir, "single") if r.get("ok")]
    multis = [r for r in table(outdir, "multi") if r.get("ok")]
    fails = [r for r in table(outdir, "single") + table(outdir, "multi")
             if not r.get("ok")]
    return {
        "cells_single_ok": len(singles),
        "cells_multi_ok": len(multis),
        "fails": len(fails),
        "worst_roofline": (min(singles, key=lambda r: r["roofline_fraction"])
                           ["arch"] if singles else ""),
        "mean_roofline_fraction": (
            sum(r["roofline_fraction"] for r in singles) / len(singles)
            if singles else 0.0),
    }
