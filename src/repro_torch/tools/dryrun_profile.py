"""Where a dry-run cell's meta step spends its time: one cell of
``launch.dryrun`` with the architecture cut in depth, timed by DTensor's
sharding propagation (its cache misses, by op) and redistributions, and
optionally under ``cProfile``.

    PYTHONPATH=src python -m repro_torch.tools.dryrun_profile \\
        --arch llama-3.2-vision-11b --layers 5 --shape train_4k \\
        --mesh multi [--profile 25] [--stacks-every 90]

``--layers`` must be a multiple of the architecture's layer pattern.
``--stacks-every S`` writes every thread's stack to stderr each S
seconds (``faulthandler``), for a step that does not finish.  Reads
DTensor's private ``_sharding_prop`` / ``_redistribute`` modules: a
measuring tool, never imported by the package.
"""

from __future__ import annotations

import argparse
import collections
import cProfile
import dataclasses
import faulthandler
import pstats
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", choices=("single", "multi"), default="multi")
    ap.add_argument("--profile", type=int, default=0,
                    help="print cProfile's top N functions by own time")
    ap.add_argument("--stacks-every", type=float, default=0.0)
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from torch.distributed.tensor import _redistribute as RD
    from torch.distributed.tensor import _sharding_prop as SP
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.analysis import collectives as CO
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh

    stats = collections.defaultdict(lambda: [0, 0.0])

    def timed(name_of, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                s = stats[name_of(*a)]
                s[0] += 1
                s[1] += time.perf_counter() - t0
        return call
    prop = SP.ShardingPropagator.propagate_op_sharding_non_cached
    rd = RD.redistribute_local_tensor
    SP.ShardingPropagator.propagate_op_sharding_non_cached = timed(
        lambda self, schema: f"propagate {schema.op}", prop)
    RD.redistribute_local_tensor = timed(lambda *a: "redistribute", rd)
    if args.stacks_every:
        faulthandler.dump_traceback_later(args.stacks_every, repeat=True)

    cfg = dataclasses.replace(get_arch(args.arch), n_layers=args.layers)
    cell = get_shape(args.shape)
    multi = args.mesh == "multi"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        step, _ = D.build_lowerable(cfg, cell, mesh)
        prof = cProfile.Profile() if args.profile else None
        t0 = time.perf_counter()
        with CO.CollectiveRecord() as rec:
            if prof:
                prof.enable()
            step()
            if prof:
                prof.disable()
        step_s = time.perf_counter() - t0
    finally:
        faulthandler.cancel_dump_traceback_later()
        dist.destroy_process_group()

    misses = {k: v for k, v in stats.items() if k.startswith("propagate")}
    print(f"{args.arch} at {args.layers} layers, {args.shape} on "
          f"{args.mesh}: step {step_s:.2f} s; collectives "
          f"{CO.collective_count(rec)}")
    print(f"sharding propagation: {sum(v[0] for v in misses.values())} "
          f"cache misses, {sum(v[1] for v in misses.values()):.2f} s; "
          f"redistributions {stats['redistribute'][0]}, "
          f"{stats['redistribute'][1]:.2f} s")
    for k, (n, s) in sorted(misses.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {s:8.2f} s {n:6d} {k}")
    if prof:
        pstats.Stats(prof, stream=sys.stdout).sort_stats("tottime") \
            .print_stats(args.profile)


if __name__ == "__main__":
    main()
