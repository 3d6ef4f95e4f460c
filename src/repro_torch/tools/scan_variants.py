#!/usr/bin/env python3
"""Build ``ssm_scan`` sources side by side, count their step loop's SASS
and time them on one GPU at the Jamba cut's prefill shape.

    python3 src/repro_torch/tools/scan_variants.py [--source NAME=PATH ...]
        [--variant NAME=C,THREADS,CHUNK,POLY,MIN_BLOCKS ...] [--rounds 2]

Every source must export ``ssm_scan_fwd`` with the signature of
``src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu``.  The repo's own
source is always built as it is (``main``).  Each ``--variant`` builds a
copy of it rewritten here: C channels a thread, THREADS threads a CTA,
CHUNK steps a chunk, at least MIN_BLOCKS CTAs an SM, and the last POLY of
each channel's 16 exponentials on the f32 pipes as the polynomial exp2
below instead of ``ex2.approx``.  The kernel itself has none of these
knobs; a rewrite that no longer matches the source fails loudly.  Each
``--source`` adds another file inside the checkout (an earlier version of
the kernel, for instance).  For each build it prints, as one JSON line:

* ``ptxas``: registers and spills of each kernel (``ptxas -v``);
* ``loop``: the opcodes of the bf16 kernel's step loop (the backward
  branch whose body holds the most ``MUFU.EX2``) from ``cuobjdump
  -sass``, per channel and step (``per_channel_step``), with ``steps``
  the loop body's unrolled steps;
* ``max_rel_err``: against the plain version, per dtype (ragged
  shapes, ``dt * a`` at 0 and below -126);
* ``ms``: CUDA-event mean of 20 calls at BH 8, T 2048, P 16384, N 16,
  bf16, b and c column views of a 544-wide projection, timed in turns
  (round robin over the builds, ``--rounds`` times).

Needs a CUDA device and ``nvcc``; writes its sources and libraries
under ``build/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "variants"
FIELDS = ("channels", "threads", "chunk", "poly", "min_blocks")
CONSTANTS = {"channels": "kC", "threads": "kThreads", "chunk": "kChunk",
             "min_blocks": "kMinBlocks"}

# 2^x on the f32 pipes: x = n + r with n = rint(x) (the 1.5 * 2^23 trick
# leaves n in t's low mantissa bits), 2^r by a degree-5 fit on [-0.5,
# 0.5] (1.7 ulp at most), times 2^n built as float bits (n + 127) << 23.
# x is clamped to [-127, 128]: n = -127 builds 0 (the flush to zero of
# ex2.approx.ftz below -126), n = 128 builds +inf.
EXP2_POLY = """
__device__ __forceinline__ float exp2_poly(float x) {
  x = fminf(fmaxf(x, -127.0f), 128.0f);
  const float t = x + 12582912.0f;
  const float r = x - (t - 12582912.0f);
  float p = 1.3271720381453633e-3f;
  p = fmaf(p, r, 9.67550091445446e-3f);
  p = fmaf(p, r, 5.550727993249893e-2f);
  p = fmaf(p, r, 2.4022120237350464e-1f);
  p = fmaf(p, r, 6.931469440460205e-1f);
  p = fmaf(p, r, 1.0000001192092896f);
  return p * __int_as_float(
             (int)(((unsigned)__float_as_int(t) + 127u) << 23));
}

"""
EX2_STEP = "const float da = ex2(dv[ch] * a2[ch][k]);"


def inside(path: Path) -> Path:
    """``path`` resolved, which must lie inside this checkout."""
    path = path.resolve()
    if not path.is_relative_to(ROOT):
        raise SystemExit(f"{path} is not inside {ROOT}")
    return path


def rewrite(text: str, values: dict) -> str:
    """The kernel source with ``values`` (FIELDS) in place of its own."""
    def once(text, pattern, repl):
        out, n = re.subn(pattern, lambda _: repl, text)
        if n != 1:
            raise SystemExit(f"scan_variants: {pattern!r} matches {n} "
                             f"times in the kernel source")
        return out
    for field, const in CONSTANTS.items():
        text = once(text, rf"constexpr int {const} = \d+;",
                    f"constexpr int {const} = {values[field]};")
    if values["poly"]:
        text = once(text, re.escape("__device__ __forceinline__ void cp16"),
                    EXP2_POLY + "__device__ __forceinline__ void cp16")
        text = once(text, re.escape(EX2_STEP),
                    "const float e = dv[ch] * a2[ch][k]; const float da = "
                    f"k >= kMaxN - {values['poly']} ? exp2_poly(e) : ex2(e);")
    return text


def build(name: str, source: Path, shape: dict) -> dict:
    """``shape``: the channels per thread and polynomial exponentials the
    build runs with, to count its loop per channel and step."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"{name}.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(source)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = [f for f in _build.NVCC_FLAGS if f not in (
            "-shared", "-Xcompiler", "-fPIC")]
        proc = subprocess.run([_build.nvcc(), *cubin, "-cubin",
                               "-Xptxas", "-v", "-o",
                               str(Path(tmp) / "k.cubin"), str(source)],
                              capture_output=True, text=True)
    sass = subprocess.run([str(Path(_build.nvcc()).parent / "cuobjdump"),
                           "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    return {"name": name, "lib": lib, "variant": shape,
            "ptxas": _build.parse_ptxas(proc.stdout + proc.stderr),
            "loop": step_loop(sass, shape)}


def functions(sass: str) -> dict:
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name:
            out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def opcode(text: str) -> str:
    text = re.sub(r"^@!?U?P\w+\s+", "", text)
    return text.split()[0] if text else ""


def step_loop(sass: str, shape: dict) -> dict:
    """The opcode histogram of the bf16 scan kernel's step loop."""
    fns = {n: ins for n, ins in functions(sass).items()
           if "ssm_scan" in n and "bfloat16" in n}
    if not fns:
        return {}
    ins = max(fns.values(), key=len)
    best = None
    branch = re.compile(r"(?:@!?U?P\w+\s+)?BRA\S*\s+(?:`\(\S+\)\s*)?"
                        r"0x([0-9a-f]+)")
    for addr, text in ins:
        m = branch.match(text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [opcode(t) for a, t in ins if int(m.group(1), 16) <= a <= addr]
        n_exp = sum(op.startswith("MUFU.EX2") for op in body)
        if best is None or n_exp > best[0]:
            best = (n_exp, body)
    if best is None:
        return {}
    hist: dict = {}
    for op in best[1]:
        hist[op] = hist.get(op, 0) + 1
    c = int(shape.get("channels", 1))
    poly = int(shape.get("poly", 0))
    steps = best[0] / (c * (16 - poly)) if 16 - poly else 0
    per = {op: n / (steps * c) for op, n in sorted(hist.items())} \
        if steps else {}
    return {"instructions": len(best[1]), "steps": steps,
            "per_channel_step": per,
            "issue_per_channel_step": sum(per.values())}


def load(lib: Path):
    fn = ctypes.CDLL(str(lib)).ssm_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def call(torch, fn, x, dt, b, c, a, d):
    bh, t, p = x.shape
    y = torch.empty_like(x)
    err = fn(x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
             a.data_ptr(), d.data_ptr(), y.data_ptr(),
             0 if x.dtype == torch.float32 else 1, bh, t, p, b.shape[-1],
             *x.stride()[:2], *dt.stride()[:2], *b.stride()[:2],
             *c.stride()[:2], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return y


def inputs(torch, gen, bh, t, p, n, dtype, rank, scale_a=1.0):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(bh, t, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(bh, t, p)).to(dtype)
    xdbc = randn(bh, t, rank + 2 * n).to(dtype)
    a = -(torch.rand((p, n), generator=gen, device="cuda") * 16 + 0.1)
    return x, dt, xdbc[..., rank:rank + n], xdbc[..., rank + n:], \
        a * scale_a, randn(p)


def check(torch, fn) -> dict:
    """The worst rel err against the plain version, per dtype."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for bh, t, p, n, rank, scale in [(2, 300, 333, 16, 0, 1.0),
                                         (1, 129, 256, 16, 7, 1.0),
                                         (2, 40, 200, 5, 512, 0.0),
                                         (2, 40, 130, 16, 0, 100.0)]:
            args = inputs(torch, gen, bh, t, p, n, dtype, rank, scale)
            got = call(torch, fn, *args)
            want = ssm_scan_ref(*args)
            diff = float((got.float() - want.float()).abs().max())
            worst = max(worst, diff / (float(want.float().abs().max())
                                       + 1e-9))
        out[str(dtype).split(".")[1]] = worst
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH[@C,POLY] of another ssm_scan source "
                         "inside the checkout (C channels per thread and "
                         "POLY polynomial exponentials, default 1,0)")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=C,THREADS,CHUNK,POLY,MIN_BLOCKS")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.ssm_scan import ops
    text = ops.SOURCE.read_text()
    own = {f: int(re.search(rf"constexpr int {c} = (\d+);", text).group(1))
           for f, c in CONSTANTS.items()}
    jobs = [("main", ops.SOURCE, dict(own, poly=0))]
    for spec in args.source:
        name, path = spec.split("=", 1)
        path, _, shape = path.partition("@")
        c, poly = (shape or "1,0").split(",")
        jobs.append((name, inside(Path(path)),
                     {"channels": int(c), "poly": int(poly)}))
    OUT.mkdir(parents=True, exist_ok=True)
    for spec in args.variant:
        name, vals = spec.split("=", 1)
        values = dict(zip(FIELDS, (int(v) for v in vals.split(","))))
        source = OUT / f"{name}.cu"
        source.write_text(rewrite(text, values))
        jobs.append((name, source, values))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))
    for b in built:
        b["fn"] = load(b["lib"])
        b["max_rel_err"] = check(torch, b["fn"])
    gen = torch.Generator(device="cuda").manual_seed(6)
    jamba = inputs(torch, gen, 8, 2048, 16384, 16, torch.bfloat16, 512)
    times = {b["name"]: [] for b in built}
    for _ in range(args.rounds):
        for b in built + built[::-1]:
            fn = b["fn"]
            for _ in range(3):
                call(torch, fn, *jamba)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call(torch, fn, *jamba)
            end.record()
            end.synchronize()
            times[b["name"]].append(start.elapsed_time(end) / 20)
    for b in built:
        print(json.dumps({
            "name": b["name"], "variant": b["variant"],
            "ptxas": b["ptxas"], "loop": b["loop"],
            "max_rel_err": b["max_rel_err"], "ms": times[b["name"]]}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
