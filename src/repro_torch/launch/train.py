"""End-to-end training driver (the port of ``repro.launch.train``).

Trains any assigned architecture (full or ``--reduced``) on one device
with the whole substrate: AdamW, deterministic data, fault-tolerant
checkpointing on the ZNS-backed store, straggler tracking.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        --device cpu
    python -m repro_torch.launch.train --arch xlstm-125m --steps 6 \\
        --ckpt-dir ckpt --ckpt-every 3       # on the card

Parameters are drawn on ``--device`` (``cuda`` by default) from a
generator seeded with ``--seed`` (``serve.build``), in bf16 as in the
reference; the train step updates them in place (the reference donates
its buffers to ``jax.jit`` instead).  The checkpoint store's simulated
zn540 device runs on ``--device`` too.  Architectures with cross layers
need a memory the CLI does not make, as in the reference.  :func:`main`
returns the loop's result, the checkpoint manager and the telemetry
report so callers can check them.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core import FIXED, SUPERBLOCK
from repro_torch.launch import serve
from repro_torch.models import model as MDL
from repro_torch.train import optimizer as OPT
from repro_torch.train.checkpoint import CheckpointManager, ZNSTelemetry
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import LoopConfig, fit


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--zns-element", type=str, default="superblock",
                    choices=("superblock", "fixed"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    print(f"[train] {cfg.name} ({'reduced' if args.reduced else 'full'}): "
          f"{MDL.param_count(cfg)/1e6:.1f}M params, "
          f"batch={args.batch} seq={args.seq}", flush=True)

    params = serve.build(cfg, seed=args.seed, device=device)
    opt_cfg = OPT.AdamWConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(1, args.steps // 10))
    opt_state = OPT.init(params)
    train_step = MDL.make_train_step(cfg, opt_cfg)

    data = SyntheticLM(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                       seed=args.seed)

    ckpt = None
    zns = None
    if args.ckpt_dir:
        elem = SUPERBLOCK if args.zns_element == "superblock" else FIXED
        zns = ZNSTelemetry(element=elem, device=device)
        ckpt = CheckpointManager(args.ckpt_dir, keep=2, zns=zns)

    loop_cfg = LoopConfig(total_steps=args.steps,
                          ckpt_every=args.ckpt_every,
                          fail_at_step=args.fail_at)
    t0 = time.time()
    res = fit(train_step, params, opt_state, data, ckpt, loop_cfg)
    dt = time.time() - t0

    print(f"[train] done: {len(res.losses)} steps in {dt:.1f}s "
          f"({np.mean(res.step_times[1:] or [0])*1e3:.0f} ms/step)")
    if res.restored_from is not None:
        print(f"[train] restored from checkpoint step {res.restored_from}")
    if res.losses:
        print(f"[train] loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")
    if res.stragglers:
        print(f"[train] straggler steps: {res.stragglers}")
    rep = None
    if zns is not None:
        rep = zns.report()
        print(f"[train] ZNS ckpt-store telemetry: DLWA={rep['dlwa']:.3f} "
              f"SA={rep['sa']:.3f} finishes={rep['finishes']:.0f} "
              f"resets={rep['resets']:.0f}")
    return {"cfg": cfg, "result": res, "seconds": dt, "ckpt": ckpt,
            "zns": rep, "model": params}


if __name__ == "__main__":
    main()
