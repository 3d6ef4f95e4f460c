#!/usr/bin/env python3
"""Time the port's engine on one GPU, for one checkout.

    python3 src/repro_torch/tools/engine_timing.py [--root PATH]
        [--label NAME]

Imports ``repro_torch`` from ``PATH/src`` (default: this checkout; PATH
must lie inside it), so that two trees -- a change and its parent
unpacked into a git-ignored directory of it, ``build/parent`` say -- can
be timed in turns on one card, each in its own process.  Prints one JSON
line: the second of two ``paper_report(device="cuda")`` calls in
seconds, the 128-lane zn540 fleet dispatch of ``chip_smoke.py`` in
lane-ops/s, and one profiled headline wear dispatch (``torch.profiler``):
device events per op step, the card's busy share of the wall, and the
device time per launch of every kernel whose name holds ``zns_alloc``,
``select_kernel`` or ``rows_kernel``.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    root = args.root.resolve()
    if not root.is_relative_to(HERE):
        print(f"engine_timing: {root} is not inside {HERE}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("engine_timing: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs
    from repro_torch.core import engine, headline, workloads
    from torch.profiler import ProfilerActivity, profile

    headline.paper_report(device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    headline.paper_report(device="cuda")
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0

    eng = headline.build_headline_engine(device="cuda")
    programs, dyn = cs.fleet_batch(headline, engine, eng)
    eng.run_batch(eng.init_state(), programs, dyn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_batch(eng.init_state(), programs, dyn)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0

    name, wear, wdyn = cs.headline_batches(headline, workloads, eng)[1]
    eng.run_batch(eng.init_state(), wear, wdyn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_batch(eng.init_state(), wear, wdyn)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels: dict = {}
    for e in device:
        m = re.search(r"\w*(?:zns_alloc|select_kernel|rows_kernel)\w*",
                      e.name)
        if m:
            kernels.setdefault(m.group(0), []).append(
                e.time_range.elapsed_us())
    print(json.dumps({
        "label": args.label or str(args.root),
        "paper_report_s": report_s,
        "fleet_lane_ops_per_s": programs.shape[0] * programs.shape[1]
        / fleet_s,
        "wear_dispatch": {
            "ops": int(wear.shape[1]), "wall_us": wall_us,
            "busy_us": sum(e.time_range.elapsed_us() for e in device),
            "device_events": len(device),
            "events_per_op_step": len(device) / wear.shape[1],
            "kernels": {k: {"launches": len(v), "us": sum(v) / len(v)}
                        for k, v in kernels.items()}},
        "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
