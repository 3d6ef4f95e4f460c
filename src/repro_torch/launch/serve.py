"""Batched serving: prefill a prompt batch, then decode tokens greedily
(the port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-3-8b --reduced --device cpu
    python -m repro_torch.launch.serve --arch xlstm-125m    # on the card

Parameters are drawn on ``--device`` from ``torch.Generator`` seeded with
``--seed``; prompts come from ``numpy.random.default_rng(seed)`` as in the
reference, and for a VLM or audio model (``family`` ``vlm`` / ``audio``)
so does the stub frontend's memory, 16 rows of ``N(0, 0.1^2)`` in bf16
drawn right after the prompts.  Prefill runs the flash-attention kernel
in each attention layer (self-attention, cross-attention over the memory,
the encoder's layers), the selective-scan kernel in each Mamba layer and
the mLSTM / sLSTM scan kernels in each xLSTM layer, and every decode step
the decode-attention kernel in each self- and cross-attention;
:func:`generate` with ``attn_impl="ref"`` /
``ssm_impl="ref"`` runs their plain versions instead (``ssm_impl``
covers all three recurrences).  Decode runs no scan.  :func:`main`
returns the run (tokens, logits, caches, timings and kernel launches per
phase) so callers can check it.
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
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import model as MDL
from repro_torch.models import transformer as T


def build(cfg: ArchConfig, *, seed: int, device,
          dtype: torch.dtype = torch.bfloat16, mesh=None) -> T.Transformer:
    """The model's parameters, drawn on ``device`` from a generator on
    that device seeded with ``seed``.  With ``mesh`` (every rank calls
    it), each layer is placed by the production rules
    (``launch.sharding``) as soon as it is drawn, so no card holds more
    of the model than its shards and one layer: the same values as the
    unplaced build's, placed."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if mesh is None:
        return T.init_params(cfg, gen, device=device, dtype=dtype)
    from repro_torch.launch import sharding as SH
    specs, stacked = SH.model_shardings(
        T.init_params(cfg, device="meta", dtype=dtype), mesh)
    if stacked:
        raise ValueError(f"{cfg.name}: leaves {sorted(stacked)} are placed "
                         f"stacked over their layers; build whole and "
                         f"call sharding.shard_model")
    model = T.init_params(
        cfg, gen, device=device, dtype=dtype,
        on_block=lambda i, blk: SH.place_module(blk, specs, mesh,
                                                f"blocks.{i}."))
    return SH.place_module(model, specs, mesh)


#: the reference CLI's memory rows for a VLM or audio model
CLI_MEMORY_LEN = 16


def make_prompts(cfg: ArchConfig, batch: int, prompt_len: int,
                 seed: int) -> np.ndarray:
    return make_inputs(cfg, batch, prompt_len, seed)[0]


def make_inputs(cfg: ArchConfig, batch: int, prompt_len: int, seed: int,
                mem_len: int = 0):
    """The prompts ``(batch, prompt_len)`` and, with ``mem_len``, the
    memory ``(batch, mem_len, d_model)`` bf16 (else None), drawn from
    ``numpy.random.default_rng(seed)`` in the reference CLI's order."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len))
    if not mem_len:
        return prompts, None
    memory = rng.standard_normal((batch, mem_len, cfg.d_model)) * 0.1
    return prompts, torch.from_numpy(memory).to(torch.bfloat16)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    return {"flash_attention": flash_ops.launches,
            "decode_attention": decode_ops.launches,
            "ssm_scan": ssm_ops.launches,
            "mlstm_scan": mlstm_ops.launches,
            "slstm_scan": slstm_ops.launches}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


@torch.inference_mode()
def generate(model: T.Transformer, cfg: ArchConfig, prompts: torch.Tensor,
             decode_tokens: int, *, memory: Optional[torch.Tensor] = None,
             attn_impl: str = "kernel", ssm_impl: str = "kernel",
             forced: Optional[torch.Tensor] = None) -> dict:
    """Prefill ``prompts`` (B, P) then run ``decode_tokens - 1`` greedy
    decode steps.  A model with cross layers takes ``memory`` (B, M, d):
    its frontend's embeddings, encoded first when it has an encoder.
    With ``forced`` (B, decode_tokens) the decode inputs are
    teacher-forced: step ``i`` is fed ``forced[:, i]`` instead of the
    token it picked before.  Returns the tokens (B, decode_tokens), every
    step's logits (prefill first), the caches, wall times (synchronised;
    ``prefill_s`` includes ``encode_s``, the encoder's span) and the
    kernels' launches in each phase."""
    b, p = prompts.shape
    dev = prompts.device
    mem_len, mem_dtype = 0, torch.bfloat16
    if memory is not None:
        # the memory K/V in the projection's dtype (an encoder's output
        # is already in it)
        mem_len = memory.shape[1]
        mem_dtype = torch.promote_types(memory.dtype, model.embed.dtype)
    caches = T.init_caches(cfg, b, p + decode_tokens, memory_len=mem_len,
                           memory_dtype=mem_dtype, device=dev)
    prefill = MDL.make_prefill_step(cfg, attn_impl, ssm_impl)
    decode = MDL.make_decode_step(cfg, attn_impl)

    n0 = _launches()
    _sync(dev)
    t0 = time.perf_counter()
    encoded = bool(cfg.encoder_layers) and memory is not None
    if encoded:                      # the encoder's span, timed apart
        memory = T.encode(model, cfg, memory, attn_impl)
        _sync(dev)
    encode_s = time.perf_counter() - t0 if encoded else 0.0
    logits, caches = prefill(model, prompts, caches, memory, encoded)
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
            "caches": caches, "prefill_s": prefill_s,
            "encode_s": encode_s, "decode_s": decode_s,
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
    mem_len = CLI_MEMORY_LEN if cfg.family in ("vlm", "audio") else 0
    prompts, memory = make_inputs(cfg, args.batch, args.prompt_len,
                                  args.seed, mem_len)
    prompts = torch.from_numpy(prompts).to(device)
    if memory is not None:
        memory = memory.to(device)
    run = generate(model, cfg, prompts, args.decode_tokens, memory=memory)

    print(f"[serve] params: {n_params}")
    if memory is not None:
        print(f"[serve] memory: {tuple(memory.shape)} {memory.dtype}")
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
    return dict(run, cfg=cfg, model=model, prompts=prompts, memory=memory,
                n_params=n_params)


if __name__ == "__main__":
    main()
