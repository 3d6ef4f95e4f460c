#!/usr/bin/env python3
"""What the mLSTM scan's operand precision does end to end, on one GPU.

    python3 src/repro_torch/tools/mlstm_operands.py [--seeds 0,1,2,3]

At xlstm-125m's served mLSTM shape (B 8, T 2048, H 4, P 384, bf16; the
inputs of ``chip_smoke.py``'s ``mlstm_inputs`` from seed 19) it runs the
recurrent kernel, the chunkwise kernel and the plain chunkwise version
with its three f32 tensor-core operands handed over unrounded (``f32``),
rounded once to bf16 (``bf16``), as hi/lo pairs (``bf16x2``) and as the
kernel's hi/mid/lo triples (``bf16x3``), and prints for each the share
of h's bf16 values that differ from the stepped plain version's
("flips") and the rel err (max abs difference over max abs).  Then it
prefills xlstm-125m as published (seed-0 weights, 8 prompts of 2048
tokens) with the mLSTM scan on each of them and the sLSTM on its kernel,
as served, and prints the last-token logits' rel err against the plain
path (both scans stepped): ``chip_smoke.py`` phase 9g's measure, whose
bar is 5e-2; and, as a control, with the mLSTM on the stepped plain
version itself (only the sLSTM kernel differs from the plain path).
``--seeds`` repeats that prefill for each prompt seed listed (the first
one, 9g's 0 by default, on every scan; the others on the two kernels,
the plain chunkwise version in f32 and the control).

Each seed also prefills an f32 reference that no bf16 rounding moves:
the same weights upcast to f32 (exact) on the plain path, both scans
stepped in f32 (``ssm_impl="ref"``).  Against it the tool prints the
last-token logits' rel err of the served path (the chunkwise mLSTM
kernel), of the mLSTM on its recurrent kernel and of the bf16 plain
path, and each kernel design's error over the bf16 plain path's:
``chip_smoke.py`` phase 9g's check holds the served path's ratio to
:data:`F32_RATIO` on seed 0.  The last line is the whole result as JSON.
~1.5 minutes, and ~45 s a further seed; needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

BATCH, PROMPT, HEADS, P = 8, 2048, 4, 384
OPERANDS = ("f32", "bf16", "bf16x2", "bf16x3")
#: phase 9g's bar: the served path's error against the f32 reference over
#: the bf16 plain path's
F32_RATIO = 1.5
#: the prefills held to the f32 reference, by the name the tool gives
#: them: the served path, the mLSTM on its recurrent kernel, both scans
#: stepped in bf16
AGAINST_F32 = {"served": "chunkwise kernel",
               "recurrent": "recurrent kernel",
               "bf16_plain": "bf16 plain path"}


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def scan_inputs(torch):
    """``chip_smoke.mlstm_inputs`` at the served shape from seed 19: q,
    v ~ N(0, 1), k ~ N(0, 1/P) in bf16, li ~ N(0, 2^2), lf the
    log-sigmoid of N(3, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(19)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q = randn(BATCH, PROMPT, HEADS, P).to(torch.bfloat16)
    v = randn(BATCH, PROMPT, HEADS, P).to(torch.bfloat16)
    k = (randn(BATCH, PROMPT, HEADS, P) * P ** -0.5).to(torch.bfloat16)
    li = (randn(BATCH, PROMPT, 2 * HEADS) * 2)[..., :HEADS]
    lf = torch.nn.functional.logsigmoid(randn(BATCH, PROMPT, HEADS) + 3)
    return q, k, v, li, lf


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0",
                    help="prompt seeds of the prefill, comma-separated")
    seeds = [int(x) for x in ap.parse_args().seeds.split(",")]
    import torch
    if not torch.cuda.is_available():
        print("mlstm_operands: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.xlstm_125m import CONFIG as cfg
    from repro_torch.kernels.mlstm_scan import ops as mops
    from repro_torch.kernels.mlstm_scan import ref as mref
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TT

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    scans = {"recurrent kernel": lambda *a: mops.launch(
                 *a, mops.Plan("recurrent")),
             "chunkwise kernel": lambda *a: mops.launch(
                 *a, mops.launch_plan(P, torch.bfloat16))}
    for operands in OPERANDS:
        scans[f"plain chunkwise, {operands}"] = (
            lambda *a, o=operands: mref.mlstm_chunkwise_ref(*a, operands=o))
    out = {"device": card, "kernel_operands": mref.KERNEL_OPERANDS,
           "scan": {}, "prefill_logits_rel_err": {}, "f32_reference": {}}
    args = scan_inputs(torch)
    want = mops.mlstm_scan(*args, impl="ref")
    for name, fn in scans.items():
        got = fn(*args)
        torch.cuda.synchronize()
        res = {"flips": float((got != want).float().mean()),
               "rel_err": rel_err(got, want)}
        out["scan"][name] = res
        print(f"{name}: flips {res['flips']:.6f}, rel err "
              f"{res['rel_err']:.4e}", flush=True)
    del args, want, got

    model = serve.build(cfg, seed=0, device="cuda")
    model32 = copy.deepcopy(model).float()      # the same weights, exact

    def prefill(ssm_impl: str, m=model):
        caches = TT.init_caches(cfg, BATCH, PROMPT + 1, device="cuda")
        with torch.inference_mode():
            logits, _ = TT.forward_prefill(m, cfg, prompts, caches,
                                           ssm_impl=ssm_impl)
        torch.cuda.synchronize()
        return logits[:, :cfg.vocab]
    stepped = mops.mlstm_scan
    scans["stepped plain version"] = lambda *a: stepped(*a, impl="ref")
    for seed in seeds:
        prompts = torch.from_numpy(serve.make_prompts(
            cfg, BATCH, PROMPT, seed=seed)).to("cuda")
        plain = prefill("ref")
        logits = {"bf16 plain path": plain}
        errs = out["prefill_logits_rel_err"][seed] = {}
        names = list(scans) if seed == seeds[0] else [
            "recurrent kernel", "chunkwise kernel",
            "plain chunkwise, f32", "stepped plain version"]
        try:
            for name in names:
                def scan(q, k, v, li, lf, *, impl="kernel", fn=scans[name]):
                    return (stepped(q, k, v, li, lf, impl="ref")
                            if impl == "ref" else fn(q, k, v, li, lf))
                mops.mlstm_scan = scan
                logits[name] = prefill("kernel")
                errs[name] = err = rel_err(logits[name], plain)
                print(f"prompt seed {seed}: prefill logits, mLSTM on the "
                      f"{name}: rel err {err:.4e}", flush=True)
        finally:
            mops.mlstm_scan = stepped
        f32 = prefill("ref", model32)
        row = out["f32_reference"][seed] = {
            k: rel_err(logits[name], f32) for k, name in AGAINST_F32.items()}
        for k in ("served", "recurrent"):
            row[f"{k}_over_bf16_plain"] = row[k] / row["bf16_plain"]
            row[f"{k}_meets"] = row[f"{k}_over_bf16_plain"] <= F32_RATIO
        print(f"prompt seed {seed}: against the f32 reference: served "
              f"{row['served']:.4e}, recurrent {row['recurrent']:.4e}, "
              f"bf16 plain {row['bf16_plain']:.4e}; served / plain "
              f"{row['served_over_bf16_plain']:.4f}, recurrent / plain "
              f"{row['recurrent_over_bf16_plain']:.4f} (bar {F32_RATIO})",
              flush=True)
        del logits, f32
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
