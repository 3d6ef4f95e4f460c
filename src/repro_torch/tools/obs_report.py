"""Render a flight-recorder sidecar as a markdown report (a copy of the
reference's stdlib-only ``tools/obs_report.py``, so that the port's
sidecars render without the reference's tree).

Input is the ``<prefix>_obs.json`` sidecar that
``repro_torch.obs.export.emit_fleet_obs`` writes
(``python -m repro_torch.tools.fleet_search --obs``).  The report shows
the temporal shape of the run the end-of-run scalars hide: DLWA vs
program progress, wear-frontier spread vs progress, per-tenant-class p99
latency, and the dispatch profile and the ``jit_cache`` table (on the
port's sidecar, the selection kernels' launches during the dispatch).
Timelines render as unicode sparklines::

    PYTHONPATH=src python -m repro_torch.tools.obs_report fleet_obs.json
        [--out obs_report.md] [--max-lanes 8]

With ``--out`` the report is written to a file; otherwise it prints to
stdout.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Sequence

_BARS = " ▁▂▃▄▅▆▇█"


def spark(values: Sequence[float]) -> str:
    """Unicode sparkline of a series (flat series render as floors)."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _BARS[1] * len(vals)
    return "".join(_BARS[1 + int((v - lo) / span * 7)] for v in vals)


def _table(rows: List[Sequence], header: Sequence[str]) -> List[str]:
    out = ["| " + " | ".join(header) + " |",
           "| " + " | ".join("---" for _ in header) + " |"]
    out += ["| " + " | ".join(str(c) for c in r) + " |" for r in rows]
    return out


def render(obs: dict, max_lanes: int = 8) -> str:
    """The whole report as one markdown string."""
    lines: List[str] = ["# Flight-recorder report", ""]
    meta = obs.get("meta", {})
    if meta:
        lines += ["- " + " · ".join(f"{k}: {v}" for k, v in
                                    sorted(meta.items())), ""]
    tls = obs["timelines"]
    fleet = tls.get("fleet", {})
    n_lanes = len(tls.get("lanes", []))
    labels = obs.get("lane_labels") or [f"lane {i}"
                                        for i in range(n_lanes)]

    # ---- DLWA vs time ------------------------------------------------- #
    lines += ["## DLWA vs time", "",
              "Cumulative (host + superfluous) / host pages per time "
              "bucket (program progress).", ""]
    rows = []
    if fleet:
        rows.append(("**fleet**", spark(fleet["dlwa"]),
                     f"{fleet['dlwa'][-1]:.3f}"))
    shown = tls.get("lanes", [])[:max_lanes]
    for label, tl in zip(labels, shown):
        rows.append((label, spark(tl["dlwa"]), f"{tl['dlwa'][-1]:.3f}"))
    lines += _table(rows, ("lane", "dlwa timeline", "final"))
    if n_lanes > max_lanes:
        lines += ["", f"({n_lanes - max_lanes} more lanes omitted; "
                      f"--max-lanes to widen)"]
    lines += [""]

    # ---- wear spread vs time ------------------------------------------ #
    lines += ["## Wear frontier vs time", "",
              "Max element wear among op-touched elements (gauge per "
              "bucket) and superfluous pages per bucket.", ""]
    rows = []
    if fleet:
        rows.append(("**fleet** wear_max", spark(fleet["wear_max"]),
                     max(fleet["wear_max"])))
        rows.append(("**fleet** superfluous", spark(fleet["dummy"]),
                     sum(fleet["dummy"])))
        rows.append(("**fleet** erases", spark(fleet["erases"]),
                     sum(fleet["erases"])))
    for label, tl in zip(labels, shown):
        rows.append((label + " wear_max", spark(tl["wear_max"]),
                     max(tl["wear_max"])))
    lines += _table(rows, ("series", "timeline", "peak/total")) + [""]

    # ---- per-tenant p99 ----------------------------------------------- #
    gauges = obs.get("metrics", {}).get("gauges", {})
    parity = obs.get("parity_tenant")
    p99 = {k: v for k, v in gauges.items()
           if k.startswith("tenant") and k.endswith("_p99_latency_s")}
    if p99:
        lines += ["## p99 latency per tenant class", ""]
        rows = []
        for k in sorted(p99):
            t = int(k[len("tenant"): -len("_p99_latency_s")])
            name = "parity" if t == parity else f"tenant {t}"
            rows.append((name, f"{p99[k] * 1e6:.1f} us"))
        lines += _table(rows, ("tenant class", "p99 latency")) + [""]

    # ---- host/superfluous per tenant ---------------------------------- #
    tenants = tls.get("tenants", {})
    if tenants:
        lines += ["## Pages per tenant class", ""]
        rows = []
        for t in sorted(tenants, key=lambda s: int(s)):
            tt = tenants[t]
            name = ("parity" if parity is not None and int(t) == parity
                    else f"tenant {t}")
            rows.append((name, spark(tt["host"]), sum(tt["host"]),
                         sum(tt["dummy"])))
        lines += _table(rows, ("tenant class", "host-page timeline",
                               "host pages", "superfluous")) + [""]

    # ---- recompile / dispatch profile --------------------------------- #
    cache = obs.get("jit_cache", {})
    if cache:
        lines += ["## Recompile table", "",
                  "Jit-cache entries per dispatch surface (one per "
                  "abstract input signature; flat across repeats = "
                  "shape-stable).", ""]
        lines += _table(sorted(cache.items()),
                        ("function", "cache entries")) + [""]
    prof = obs.get("profile", {})
    if prof:
        lines += ["## Dispatch profile", ""]
        rows = []
        for name in sorted(prof):
            d = prof[name]
            compile_s = d["trace_s"] + d["lower_s"] + d["compile_s"]
            rows.append((name, int(d["calls"]), f"{d['wall_s']:.3f}",
                         f"{compile_s:.3f}", f"{d['execute_s']:.3f}",
                         int(d["n_compiles"])))
        lines += _table(rows, ("section", "calls", "wall s",
                               "trace+compile s", "execute s",
                               "compiles")) + [""]

    counters = obs.get("metrics", {}).get("counters", {})
    if counters:
        lines += ["## Counters", ""]
        lines += _table([(k, f"{v:.0f}")
                         for k, v in sorted(counters.items())],
                        ("counter", "value")) + [""]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 allow_abbrev=False)
    ap.add_argument("obs_json", type=pathlib.Path,
                    help="the <prefix>_obs.json sidecar")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--max-lanes", type=int, default=8)
    args = ap.parse_args(argv)
    obs = json.loads(args.obs_json.read_text())
    report = render(obs, max_lanes=args.max_lanes)
    if args.out:
        args.out.write_text(report + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
