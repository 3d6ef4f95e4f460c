#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``);
run from a checkout, since it imports ``src/repro_torch``.  Phases, each
of which stops the run with a non-zero exit when it fails:

1. build the ``zns_alloc`` kernel from ``src/`` and print the build time;
2. hold the kernel to its plain PyTorch version, bit for bit, on CUDA
   tensors at the main path's zn540 shapes and at random ragged shapes;
3. the main path: ``paper_report(device="cuda")`` at the paper's zn540
   device, held to the reference's ``BENCH_paper.json`` (DLWA and erases
   exactly, execution seconds at rel 1e-5), with the kernel's launch
   count zeroed just before and read just after;
4. the headline's dispatches and a 128-lane zn540 fleet batch run on the
   card and on the CPU; every ``DeviceState`` / ``OpTrace`` field must be
   bit-identical;
5. the launch count of phase 3 must be positive;
6. timings with CUDA events: the kernel, its plain version and
   ``torch.topk`` at the main path's shapes, one ``paper_report`` and
   the fleet dispatch; and one headline dispatch under
   ``torch.profiler`` for the card's busy share.

The last three lines are the card's name and power limit (from
``nvidia-smi``), a JSON line with the kernel's numbers, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peak rates (NVIDIA data sheet) for the kernel's bound
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12            # non-tensor-core 32-bit rate
FLEET_LANES = 128


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------- #
# phase 2: kernel vs plain version
# --------------------------------------------------------------------- #
def random_rows(torch, rng, L, G, W, take, dev):
    """A selection batch: wear spread like a worn device, availability
    codes mixed, ragged eligibility, both ``by_wear`` values, a
    ``take_eff`` in [0, take] and a ``per_group_eff`` in [1, W]."""
    import numpy as np
    wear = rng.integers(0, 3000, (L, G, W)).astype(np.int32)
    wear[:, :, ::7] = 5                       # ties on wear
    avail = rng.choice([0, 1, 2, 3], (L, G, W),
                       p=[0.4, 0.2, 0.2, 0.2]).astype(np.int32)
    elig = (rng.random((L, G)) < 0.85).astype(np.int32)
    by_wear = (np.arange(L) % 2).astype(np.int32)
    take_eff = rng.integers(0, take + 1, L).astype(np.int32)
    pge = rng.integers(1, W + 1, L).astype(np.int32)
    pge[0] = W
    return [torch.from_numpy(a).to(dev) for a in
            (wear, avail, elig, by_wear, take_eff, pge)]


def compare_kernel(torch, ops, ref, args, take) -> float:
    got = ops.zns_alloc_rows(*args, take=take, with_sel=True)
    want = ref.zns_alloc_rows_ref(*args, take=take)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("cols", "ok", "cost", "sel"), got, want):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"kernel {name} dtype/shape {a.dtype}{tuple(a.shape)} vs "
              f"{b.dtype}{tuple(b.shape)}")
        check(torch.equal(a, b),
              f"kernel {name} differs from its plain version at shape "
              f"{tuple(args[0].shape)} take {take}")
        finite = torch.isfinite(b.float())
        check(torch.equal(finite, torch.isfinite(a.float())),
              f"kernel {name} inf pattern differs")
        err = max(err, float((a.float() - b.float())[finite].abs().max())
                  if finite.any() else 0.0)
    return err


def phase_kernel(torch, np, ops, ref) -> float:
    rng = np.random.default_rng(2025)
    dev = "cuda"
    err = 0.0
    shapes = [(2, 4, 1056, 22), (12, 4, 1056, 22),
              (FLEET_LANES, 4, 1056, 22), (2, 4, 48, 1),
              (FLEET_LANES, 4, 48, 1)]
    for _ in range(12):
        W = int(rng.integers(1, ops.MAX_WIDTH + 1))
        shapes.append((int(rng.integers(1, 10)), int(rng.integers(1, 8)),
                       W, int(rng.integers(1, min(W, ops.MAX_TAKE) + 1))))
    for L, G, W, take in shapes:
        err = max(err, compare_kernel(
            torch, ops, ref, random_rows(torch, rng, L, G, W, take, dev),
            take))
    # the Pallas contract on the card
    for G, W, take in [(4, 1056, 22), (3, 33, 5), (16, 256, 8)]:
        wear, avail, elig = random_rows(torch, rng, 1, G, W, take, dev)[:3]
        sel, feasible = ops.zns_alloc(wear[0], avail[0], elig[0],
                                      take=take)
        s_ref, ok = ref.zns_alloc_ref(wear[0], avail[0], elig[0],
                                      take=take)
        want = bool(((ok >= take) | (elig[0] == 0)).all())
        check(torch.equal(sel, s_ref.bool()) and bool(feasible) == want,
              f"zns_alloc contract differs at {(G, W, take)}")
    log(f"phase 2: kernel == plain version, bit for bit (tolerance 0), "
        f"on {len(shapes)} shapes (max_abs_err {err})")
    return err


# --------------------------------------------------------------------- #
# phases 3-4: the main path and the CPU twin
# --------------------------------------------------------------------- #
def check_report(rep: dict, bench: dict) -> None:
    for fig in ("dlwa", "wear"):
        for key, value in bench[fig].items():
            check(rep[fig][key] == value,
                  f"{fig}.{key}: {rep[fig][key]!r} != {value!r}")
    for key, value in bench["exec"].items():
        got = rep["exec"][key]
        if key in ("traditional_s", "silent_s", "speedup"):
            check(abs(got - value) <= 1e-5 * abs(value),
                  f"exec.{key}: {got!r} vs {value!r} (rel 1e-5)")
        else:
            check(got == value, f"exec.{key}: {got!r} != {value!r}")


def headline_batches(headline, workloads, eng):
    """The programs and lane configs of the headline's three figure
    dispatches, at ``paper_report``'s defaults."""
    import numpy as np
    occ = headline.DEFAULT_OCCUPANCIES
    dlwa = np.stack([p for o in occ for p in (workloads.dlwa_program(
        eng, occupancy=o, n_zones=4),) * 2])
    wear = headline._churn_program(eng, occupancy=0.3, n_zones=8, cycles=8)
    exe = headline._churn_program(eng, occupancy=0.3, n_zones=8, cycles=4)
    return [("dlwa", dlwa, headline._policy_dyns(eng, len(occ))),
            ("wear", np.stack([wear, wear]), headline._policy_dyns(eng, 1)),
            ("exec", np.stack([exe, exe]), headline._policy_dyns(eng, 1))]


def fleet_batch(headline, engine, eng):
    """64 traditional/silent lane pairs of the RESET-churn program at
    four occupancies, with mixed capacity shrinks and wear bounds."""
    import numpy as np
    zp = eng.cfg.zone_pages
    trad_spec = headline.traditional_spec(eng.zone_geom)
    programs, dyns = [], []
    for k in range(FLEET_LANES // 2):
        occ = (0.1, 0.2, 0.3, 0.4)[k % 4]
        prog = headline._churn_program(eng, occupancy=occ, n_zones=8,
                                       cycles=4)
        shrink = (None, zp * 3 // 4, zp // 2, None)[(k // 4) % 4]
        bound = (None, 0, 2, 8)[(k // 16) % 4]
        programs += [prog, prog]
        dyns += [eng.dyn(spec=trad_spec, zone_pages=shrink),
                 eng.dyn(spec=headline.BLOCK, alloc_policy="silent",
                         wear_bound=bound, zone_pages=shrink)]
    return np.stack(programs), engine.stack_dyn(dyns)


def assert_same_run(torch, name, gpu, cpu) -> None:
    for kind, a, b in (("state", gpu[0], cpu[0]), ("trace", gpu[1],
                                                    cpu[1])):
        for field in type(a)._fields:
            x, y = getattr(a, field).cpu(), getattr(b, field)
            check(x.dtype == y.dtype and torch.equal(x, y),
                  f"{name}: {kind}.{field} differs between cuda and cpu")


# --------------------------------------------------------------------- #
# phase 6: timing
# --------------------------------------------------------------------- #
def cuda_ms(torch, fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_timing(torch, np, ops, ref, L, G, W, take) -> dict:
    rng = np.random.default_rng(L * 7 + W)
    args = random_rows(torch, rng, L, G, W, take, "cuda")
    args[3].fill_(1)                           # the wear-aware key
    args[5].fill_(W)
    key = ((args[0].long() << 32) | torch.arange(W, device="cuda")).where(
        ((args[1] == 0) | (args[1] == 3)) & (args[2] != 0)[..., None],
        (1 << 62) | torch.arange(W, device="cuda")).reshape(L * G, W)
    before = ops.launches
    ms = cuda_ms(torch, lambda: ops.zns_alloc_rows(*args, take=take))
    ops.launches = before                      # timing launches not counted
    plain_ms = cuda_ms(torch, lambda: ref.zns_alloc_rows_ref(*args,
                                                             take=take))
    library_ms = cuda_ms(torch, lambda: torch.topk(key, take, dim=1,
                                                   largest=False,
                                                   sorted=True))
    rows = L * G
    # each input read once, each output written once
    bytes_moved = (2 * 4 * rows * W + 4 * rows + 3 * 4 * L
                   + 4 * rows * take + 4 * rows + 4 * rows)
    # take rounds of a 64-bit min over every column, counted as two
    # 32-bit operations per compare
    ops_done = 2 * take * rows * W
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_done / OPS_PER_S * 1e3
    return {"shape": [L, G, W], "take": take, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def profile_dispatch(torch, eng, programs, dyn) -> dict:
    """One dispatch under ``torch.profiler``: the card's busy time (the
    sum of its kernel and copy spans, which do not overlap on one
    stream) against the wall time, and the ``zns_alloc`` kernel's own
    device time.  The profiler's host cost inflates the wall time, so
    the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    eng.run_batch(eng.init_state(), programs, dyn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_batch(eng.init_state(), programs, dyn)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    kern = [e.time_range.elapsed_us() for e in device
            if "zns_alloc" in e.name]
    return {"wall_us": wall_us, "busy_us": busy_us,
            "device_events": len(device), "kernel_launches": len(kern),
            "kernel_us": sum(kern) / len(kern) if kern else None}


def gpu_name_and_limit() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import engine, headline, workloads
    from repro_torch.kernels import _build
    from repro_torch.kernels.zns_alloc import ops, ref

    t_start = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    log(f"device: {card} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    lib = _build.build(ops.SOURCE)
    log(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.2f} s")

    # 2. kernel vs plain version
    max_abs_err = phase_kernel(torch, np, ops, ref)

    # 3. the main path
    bench = json.loads((ROOT / "BENCH_paper.json").read_text())
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = headline.paper_report(device="cuda")
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0
    launches = ops.launches
    check_report(rep, bench)
    log(f"phase 3: paper_report on cuda == BENCH_paper.json "
        f"(DLWA {rep['dlwa']['traditional_dlwa'][0]} -> "
        f"{rep['dlwa']['silent_dlwa'][0]}, erases "
        f"{rep['wear']['traditional_erases']} -> "
        f"{rep['wear']['silent_erases']}, exec "
        f"{rep['exec']['traditional_s']} s -> {rep['exec']['silent_s']} s)")
    check(sum(rep["launches"]["zns_alloc_per_pass"]) == launches,
          "paper_report's per-pass launch counts disagree with the "
          "wrapper's counter")

    # 4. the same dispatches and the fleet batch, cuda vs cpu
    gpu_eng = headline.build_headline_engine(device="cuda")
    cpu_eng = headline.build_headline_engine(device="cpu")
    for name, programs, dyn in headline_batches(headline, workloads,
                                                gpu_eng):
        assert_same_run(torch, name, gpu_eng.run_batch(
            gpu_eng.init_state(), programs, dyn), cpu_eng.run_batch(
            cpu_eng.init_state(), programs, dyn))
    fleet_progs, fleet_dyn = fleet_batch(headline, engine, gpu_eng)
    gpu_eng.run_batch(gpu_eng.init_state(), fleet_progs, fleet_dyn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu_fleet = gpu_eng.run_batch(gpu_eng.init_state(), fleet_progs,
                                  fleet_dyn)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_fleet = cpu_eng.run_batch(cpu_eng.init_state(), fleet_progs,
                                  fleet_dyn)
    cpu_fleet_s = time.perf_counter() - t0
    assert_same_run(torch, "fleet", gpu_fleet, cpu_fleet)
    n_ok = int(gpu_fleet[1].ok.sum())
    n_ops = fleet_progs.shape[0] * fleet_progs.shape[1]
    log(f"phase 4: headline dispatches and the {FLEET_LANES}-lane fleet "
        f"({fleet_progs.shape[1]} ops/lane, {n_ok}/{n_ops} ok) "
        f"bit-identical on cuda and cpu")

    # 5. the main path went through the kernel
    check(launches > 0, "paper_report launched the zns_alloc kernel "
          "no time")
    log(f"phase 5: zns_alloc launches in paper_report: {launches} "
        f"({rep['launches']['zns_alloc_per_pass']} per pass)")

    # 6. timing
    timings = [kernel_timing(torch, np, ops, ref, *shape) for shape in (
        (2, 4, 1056, 22), (12, 4, 1056, 22), (FLEET_LANES, 4, 1056, 22))]
    for t in timings:
        log(f"phase 6: zns_alloc {t['shape']} take {t['take']}: kernel "
            f"{t['ms']:.6f} ms, plain {t['plain_ms']:.6f} ms, torch.topk "
            f"{t['library_ms']:.6f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    headline.paper_report(device="cuda")
    torch.cuda.synchronize()
    report2_s = time.perf_counter() - t0
    log(f"phase 6: paper_report (2 passes of 3 dispatches) on cuda: "
        f"{report_s:.3f} s first call, {report2_s:.3f} s second call")
    log(f"phase 6: {FLEET_LANES}-lane fleet dispatch: {fleet_s:.3f} s on "
        f"cuda = {n_ops / fleet_s:.1f} lane-ops/s "
        f"(cpu twin {cpu_fleet_s:.3f} s)")
    name, programs, dyn = headline_batches(headline, workloads,
                                           gpu_eng)[1]
    prof = profile_dispatch(torch, gpu_eng, programs, dyn)
    if prof["device_events"]:
        log(f"phase 6: profiled {name} dispatch ({programs.shape[0]} x "
            f"{programs.shape[1]} ops): wall {prof['wall_us']:.1f} us, "
            f"device busy {prof['busy_us']:.1f} us "
            f"({prof['busy_us'] / prof['wall_us']:.4f} of wall) over "
            f"{prof['device_events']} device events; zns_alloc "
            f"{prof['kernel_launches']} launches, {prof['kernel_us']} us "
            f"device time each")
    else:
        log("phase 6: profiler recorded no device events: device busy "
            "share not measured")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    main_t = timings[0]
    log(gpu_name_and_limit())
    log(json.dumps({"kernels": [{
        "name": "zns_alloc",
        "route": "cuda",
        "source": "src/repro_torch/kernels/zns_alloc/csrc/zns_alloc.cu",
        "replaces": "src/repro/kernels/zns_alloc/zns_alloc.py:41",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
