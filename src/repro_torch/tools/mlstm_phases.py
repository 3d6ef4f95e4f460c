#!/usr/bin/env python3
"""Where a chunk's time goes inside the chunkwise mLSTM kernel, on one GPU.

    python3 src/repro_torch/tools/mlstm_phases.py [--rounds 3]

Builds ``mlstm_chunkwise.cu`` as it is and a copy rewritten here with a
``clock64()`` read by thread 0 of CTA (0, 0) just before the wait that
opens each chunk and just after each of the chunk's three barriers,
each gap summed over the sequence into a device array.  Runs both at
xlstm-125m's served shape (B 8, T 2048, H 4, P 384, bf16; the inputs of
``chip_smoke.py``'s ``mlstm_inputs`` from seed 19) and prints, as one
JSON line, the card, each build's CUDA-event ms a call (in turns,
``--rounds`` times; the copy's cost is the clocks'), and the copy's
cycles a chunk by phase:

* ``wait``: from the end of the previous chunk to the chunk's barrier
  (A): the data wait and the barrier's skew;
* ``scores_update``: (A) to (D): the chunk's scores, n . q and
  stabiliser, and the previous chunk's h and state update;
* ``rows``: (D) to (F): the next chunk's staging, the rows of D and
  S D, den and cw, n's update;
* ``sums``: (F) to the next wait: C q, the cw scaling, (S D) V and the
  sums' store.

Beside them, ``mma_cycles``: the cycles a scheduler spends on one
``mma.m16n8k16`` bf16 (f32 sums) when 132 CTAs of the kernel's 12 warps
issue nothing else, 8 independent sums a warp (a loop built here; clock
at 1.755 GHz), and the MMAs each phase issues a scheduler and chunk, so
that a phase's cycles can be held against its MMAs at that rate.

A rewrite that no longer matches the source fails loudly.  Needs a CUDA
device and ``nvcc``; writes its copy and libraries under
``build/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

ROOT = Path(__file__).resolve().parents[3]
PROMPT, P = 2048, 384
#: (phase that ends here, text the clock read goes beside, before/after)
MARKS = (("sums", "    cp_wait_all();\n    __syncthreads();     // (A)",
          "before"),
         ("wait", "    __syncthreads();     // (A) chunk ch is in, chunk ch - "
          "1's h sums out", "after"),
         ("scores_update", "    __syncthreads();     // (D)", "after"),
         ("rows", "    __syncthreads();     // (F)", "after"))


def instrument(text: str) -> str:
    """The source with the clock reads and an exported reader."""
    def once(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError(f"mlstm_phases: the source no longer has "
                               f"one {old.strip()!r}")
        return text.replace(old, new)
    text = once(text, "namespace {\n", "__device__ unsigned long long "
                "g_phase_clocks[8];\n\nnamespace {\n")
    text = once(text, "  float m = -1e30f;", "  long long clk_prev = "
                "clock64();\n  float m = -1e30f;")
    for i, (_, mark, where) in enumerate(MARKS):
        read = (f"\n    if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) "
                f"{{\n      const long long now = clock64();\n      "
                f"g_phase_clocks[{i}] += now - clk_prev;\n      clk_prev = "
                f"now;\n    }}\n")
        text = once(text, mark, read + mark if where == "before"
                    else mark + read)
    return text + '''
extern "C" int mlstm_phase_clocks(unsigned long long* out, int reset) {
  unsigned long long zero[8] = {0};
  return reset ? (int)cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero))
               : (int)cudaMemcpyFromSymbol(out, g_phase_clocks,
                                           sizeof(zero));
}
'''


#: a loop of independent ``mma.sync`` bf16 products, CH sums a warp
MMA_LOOP = r'''
#include <cuda_runtime.h>
#include <stdint.h>
constexpr int CH = 8;
__global__ void mma_loop(float* out, int iters) {
  float d[CH][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 11u};
  const uint32_t b0 = threadIdx.x * 5u, b1 = 13u;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < CH; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.f;
  for (int i = 0; i < CH; ++i) s += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_loop_run(float* out, int ctas, int threads, int iters) {
  mma_loop<<<ctas, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
'''
MMA_CHAINS, SM_CLOCK_HZ = 8, 1.755e9


def mma_cycles(torch, threads: int = 384, iters: int = 2000) -> float:
    """Cycles a scheduler spends on one ``mma.sync`` in :data:`MMA_LOOP`
    over 132 CTAs of ``threads`` (CUDA events, clock at
    :data:`SM_CLOCK_HZ`)."""
    from repro_torch.kernels import _build
    src = ROOT / "build" / "variants" / "mma_loop.cu"
    src.write_text(MMA_LOOP)
    lib = _build.load(src)
    lib.mma_loop_run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    out = torch.empty(132 * threads, device="cuda")
    lib.mma_loop_run(out.data_ptr(), 132, threads, 10)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if lib.mma_loop_run(out.data_ptr(), 132, threads, iters):
        raise RuntimeError("mlstm_phases: the mma loop did not launch")
    end.record()
    end.synchronize()
    per_scheduler = threads // 32 / 4 * iters * MMA_CHAINS
    return start.elapsed_time(end) * 1e-3 * SM_CLOCK_HZ / per_scheduler


def load(path: Path):
    from repro_torch.kernels import _build
    lib = _build.load(path)
    lib.mlstm_chunkwise_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
    lib.mlstm_chunkwise_fwd.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mlstm_phases: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.mlstm_scan import ops as mops
    from repro_torch.tools.mlstm_operands import scan_inputs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    copy = ROOT / "build" / "variants" / "mlstm_chunkwise_clocked.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(instrument(mops.CHUNKWISE_SOURCE.read_text()))
    libs = {"as_is": load(mops.CHUNKWISE_SOURCE), "clocked": load(copy)}
    inputs = scan_inputs(torch)
    plan = mops.launch_plan(P, torch.bfloat16)

    def run(name):
        mops._lib_cache["chunkwise"] = libs[name]
        return mops.launch(*inputs, plan)
    times = {name: [] for name in libs}
    try:
        for _ in range(args.rounds):
            for name in libs:
                for _ in range(3):
                    run(name)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    run(name)
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / 20)
        clocked = libs["clocked"]
        clocked.mlstm_phase_clocks.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
        clocked.mlstm_phase_clocks(None, 1)
        run("clocked")
        torch.cuda.synchronize()
        raw = (ctypes.c_ulonglong * 8)()
        clocked.mlstm_phase_clocks(raw, 0)
    finally:
        mops._lib_cache.pop("chunkwise", None)
    # each read closes the phase named beside it; "sums" holds the
    # prologue and every chunk's sums but the last one's
    chunks = -(-PROMPT // mops.CHUNK)
    phases = {name: raw[i] / chunks for i, (name, _, _) in enumerate(MARKS)}
    # a scheduler's MMAs a chunk, from the source's loops (3 warps of
    # rows a scheduler, S's six tiles over the CTA's 4 schedulers)
    kt = P // 32
    mmas = {"scores_update": 3 * 3 * 2 * kt * 2 + 6 * (P // 16) / 4,
            "sums": 3 * (kt * 12 + 12)}
    print(json.dumps({"device": card, "ms": times,
                      "cycles_a_chunk": phases,
                      "cycles_a_chunk_total": sum(phases.values()),
                      "mma_a_scheduler_a_chunk": mmas,
                      "mma_cycles": mma_cycles(torch)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
