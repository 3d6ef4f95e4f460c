"""Batched serving: prefill a prompt batch, then decode tokens greedily
(the port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-3-8b --reduced --device cpu

Parameters are drawn on ``--device`` from ``torch.Generator`` seeded with
``--seed``; prompts come from ``numpy.random.default_rng(seed)`` as in the
reference.  Prefill runs the flash-attention kernel in each attention
layer and the selective-scan kernel in each Mamba layer, and every decode
step the decode-attention kernel; :func:`generate` with
``attn_impl="ref"`` / ``ssm_impl="ref"`` runs their plain versions
instead.  :func:`main` returns the run (tokens, logits, caches, timings
and kernel launches per phase) so callers can check it.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import model as MDL
from repro_torch.models import transformer as T


def build(cfg: ArchConfig, *, seed: int, device,
          dtype: torch.dtype = torch.bfloat16) -> T.Transformer:
    """The model's parameters, drawn on ``device`` from a generator on
    that device seeded with ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return T.init_params(cfg, gen, device=device, dtype=dtype)


def make_prompts(cfg: ArchConfig, batch: int, prompt_len: int,
                 seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (batch, prompt_len))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    return {"flash_attention": flash_ops.launches,
            "decode_attention": decode_ops.launches,
            "ssm_scan": ssm_ops.launches}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


@torch.inference_mode()
def generate(model: T.Transformer, cfg: ArchConfig, prompts: torch.Tensor,
             decode_tokens: int, *, attn_impl: str = "kernel",
             ssm_impl: str = "kernel",
             forced: Optional[torch.Tensor] = None) -> dict:
    """Prefill ``prompts`` (B, P) then run ``decode_tokens - 1`` greedy
    decode steps.  With ``forced`` (B, decode_tokens) the decode inputs
    are teacher-forced: step ``i`` is fed ``forced[:, i]`` instead of the
    token it picked before.  Returns the tokens (B, decode_tokens), every
    step's logits (prefill first), the caches, wall times (synchronised)
    and the kernels' launches in each phase."""
    b, p = prompts.shape
    dev = prompts.device
    caches = T.init_caches(cfg, b, p + decode_tokens, device=dev)
    prefill = MDL.make_prefill_step(cfg, attn_impl, ssm_impl)
    decode = MDL.make_decode_step(cfg, attn_impl)

    n0 = _launches()
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(model, prompts, caches)
    tokens = [logits[:, :cfg.vocab].argmax(dim=-1)]
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    n1 = _launches()

    all_logits = [logits]
    t1 = time.perf_counter()
    for i in range(decode_tokens - 1):
        pos = torch.full((b,), p + i, dtype=torch.int32, device=dev)
        token = tokens[-1] if forced is None else forced[:, i]
        logits, caches = decode(model, token, caches, pos)
        tokens.append(logits[:, :cfg.vocab].argmax(dim=-1))
        all_logits.append(logits)
    _sync(dev)
    decode_s = time.perf_counter() - t1
    return {"tokens": torch.stack(tokens, dim=1), "logits": all_logits,
            "caches": caches, "prefill_s": prefill_s, "decode_s": decode_s,
            "launches": {"prefill": _delta(n1, n0),
                         "decode": _delta(_launches(), n1)}}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    print(f"[serve] {cfg.name}: batch={args.batch} "
          f"prompt={args.prompt_len} decode={args.decode_tokens} "
          f"device={device}", flush=True)
    model = build(cfg, seed=args.seed, device=device)
    n_params = sum(t.numel() for t in model.parameters())
    prompts = torch.from_numpy(make_prompts(
        cfg, args.batch, args.prompt_len, args.seed)).to(device)
    run = generate(model, cfg, prompts, args.decode_tokens)

    print(f"[serve] params: {n_params}")
    print(f"[serve] prefill: {run['prefill_s'] * 1e3:.1f} ms "
          f"({args.batch * args.prompt_len / run['prefill_s']:.0f} tok/s)")
    if args.decode_tokens > 1:
        per_tok = run["decode_s"] / (args.decode_tokens - 1)
        print(f"[serve] decode: {per_tok * 1e3:.2f} ms/token "
              f"({args.batch / per_tok:.0f} tok/s batch-aggregate)")
    print(f"[serve] kernel launches: {run['launches']}")
    print("[serve] sample continuations (first 3 rows):")
    for row in run["tokens"][:3].tolist():
        print("   ", row[:12])
    return dict(run, cfg=cfg, model=model, prompts=prompts,
                n_params=n_params)


if __name__ == "__main__":
    main()
