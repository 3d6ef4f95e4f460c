#!/usr/bin/env python3
"""Where xlstm-125m's kernel path and its plain path part, on one GPU.

    python3 src/repro_torch/tools/xlstm_paths.py

Builds xlstm-125m as published from seed 0 (``serve.build``) and
prefills ``chip_smoke.py``'s 8 prompts of 2048 tokens, in bf16 and then
in f32.  For each dtype it prints the last-token logits' rel err (max
abs difference over max abs logit) of three mixed paths against the
kernel path -- the plain mLSTM scan with the sLSTM kernel, the mLSTM
kernel with the plain sLSTM scan, both plain -- and, layer by layer, the
rel err between each xLSTM mixer's kernel and plain outputs on the
kernel path's own input to that layer.  ~2 minutes with the plain scans.
Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

BATCH, PROMPT = 8, 2048


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("xlstm_paths: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.xlstm_125m import CONFIG as cfg
    from repro_torch.kernels.mlstm_scan import ops as mops
    from repro_torch.kernels.slstm_scan import ops as sops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TT
    from repro_torch.models import xlstm as X

    torch.backends.cuda.matmul.allow_tf32 = False
    prompts = torch.from_numpy(serve.make_prompts(
        cfg, BATCH, PROMPT, seed=0)).to("cuda")
    mlstm_scan, slstm_scan = mops.mlstm_scan, sops.slstm_scan
    mlstm_forward, slstm_forward = X.mlstm_forward, X.slstm_forward
    out = {"device": torch.cuda.get_device_name(0)}
    for dtype in (torch.bfloat16, torch.float32):
        model = serve.build(cfg, seed=0, device="cuda", dtype=dtype)

        def prefill():
            caches = TT.init_caches(cfg, BATCH, PROMPT + 1, device="cuda")
            with torch.inference_mode():
                logits, _ = TT.forward_prefill(model, cfg, prompts, caches)
            return logits[:, :cfg.vocab]

        def mixed(m_impl: str, s_impl: str):
            mops.mlstm_scan = (lambda *a, impl="kernel":
                               mlstm_scan(*a, impl=m_impl))
            sops.slstm_scan = (lambda *a, impl="kernel":
                               slstm_scan(*a, impl=s_impl))
            try:
                return prefill()
            finally:
                mops.mlstm_scan, sops.slstm_scan = mlstm_scan, slstm_scan

        kernel = prefill()
        row = {"max_abs_logit": float(kernel.abs().max())}
        for m_impl, s_impl in (("ref", "kernel"), ("kernel", "ref"),
                               ("ref", "ref")):
            row[f"mlstm_{m_impl}_slstm_{s_impl}"] = rel_err(
                mixed(m_impl, s_impl), kernel)

        layers = []

        def both(forward, kind):
            def run(p, h, n_heads, impl="kernel"):
                got = forward(p, h, n_heads, impl="kernel")
                layers.append((kind, rel_err(
                    got, forward(p, h, n_heads, impl="ref"))))
                return got
            return run
        X.mlstm_forward = both(mlstm_forward, "mlstm")
        X.slstm_forward = both(slstm_forward, "slstm")
        try:
            prefill()
        finally:
            X.mlstm_forward, X.slstm_forward = mlstm_forward, slstm_forward
        row["layers"] = layers
        out[str(dtype).split(".")[1]] = row
        print(json.dumps({str(dtype).split(".")[1]: row}), flush=True)
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
