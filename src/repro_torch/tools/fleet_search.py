"""Fleet allocator search on the port: tenant-mix x geometry x spec x
allocator (the counterpart of the reference's ``benchmarks/fleet_search.py``).

The same three strategies over one
:class:`~repro_torch.fleet.SearchSpace` (2 tenant mixes x 2 effective
zone geometries x 2 stripe-chunk sizes x parity on/off x wear-aware /
first-fit x ``--specs`` element specs x ``--policies`` allocation
policies, each config expanded to ``--devices`` member lanes), all
scored through the batched :class:`~repro_torch.fleet.Evaluator`.  With
more than one element spec the engine is built over the padded union
config, so a mixed fleet runs in one ``run_programs`` dispatch:

* ``--strategy grid``   -- the full cross product (96 configs on zn540
  with the default 3-spec axis) in one dispatch + one timing pass;
* ``--strategy random`` -- ``--random N`` seeded samples, one dispatch;
* ``--strategy evolve`` -- evolutionary proposals with a
  successive-halving rung schedule, one dispatch per rung, stopping at
  ``--target`` if given.

Grid / random print one ``name,us_per_call,derived`` row a config and
the Pareto front; evolve one row a generation and the archive.  The
front is written as JSON (``--out``, default ``fleet_pareto.json``);
``--workload`` writes ``fleet_workload_<name>.json``; ``--obs`` writes
``<prefix>_trace.json`` (Perfetto) and ``<prefix>_obs.json`` (render it
with ``python -m repro_torch.tools.obs_report``)::

    PYTHONPATH=src python -m repro_torch.tools.fleet_search [--quick]
        [--strategy {grid,random,evolve}] [--devices 4] [--seed S]
        [--random N] [--population K --generations G] [--target OBJ]
        [--specs superblock,block,vchunk2]
        [--policies traditional,silent] [--workload {lsm,ckpt,cache}]
        [--obs] [--out fleet_pareto.json] [--device {cuda,cpu}]

The engine runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from repro_torch.core import zn540
from repro_torch.core.elements import (BLOCK, SUPERBLOCK, ElementSpec,
                                       hchunk, vchunk)
from repro_torch.core.engine import ZoneEngine
from repro_torch.fleet import (Evaluator, EvolveParams, SearchSpace, evolve,
                               grid_space, pareto_front, random_space,
                               score_rows)
from repro_torch.kernels.zns_alloc import ops as zns_ops
from repro_torch.tools.run_figures import Bench

DERIVED_KEYS = ("dlwa", "wear_cv", "p99_latency_s", "makespan_s",
                "block_erases", "score", "pareto")


def parse_spec(name: str) -> ElementSpec:
    """``superblock`` / ``block`` / ``vchunkN`` / ``hchunkN`` -> spec
    (FIXED cannot join a per-lane union and is not accepted)."""
    name = name.strip().lower()
    if name == "superblock":
        return SUPERBLOCK
    if name == "block":
        return BLOCK
    for prefix, build in (("vchunk", vchunk), ("hchunk", hchunk)):
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            return build(int(name[len(prefix):]))
    raise argparse.ArgumentTypeError(
        f"unknown element spec {name!r} (want superblock, block, "
        f"vchunkN or hchunkN)")


class LaunchCounts:
    """``zns_alloc``'s launches since it was made, by kernel, read where
    the reference reads its recompile counter (``counts()``)."""

    def __init__(self):
        self.before = dict(zns_ops.counts)

    def counts(self) -> dict:
        return {k: v - self.before.get(k, 0)
                for k, v in zns_ops.counts.items()}


def emit_obs_artifacts(eng, configs, *, n_devices: int,
                       out_prefix: str = "fleet", n_buckets: int = 32,
                       meta: dict | None = None) -> dict:
    """Re-dispatch ``configs`` through the flight recorder and write the
    Perfetto trace + telemetry sidecar (``<out_prefix>_trace.json`` /
    ``<out_prefix>_obs.json``); lanes are labeled ``<config>/dev<d>``.

    The port's ``emit_fleet_obs`` takes a counter with ``counts()`` where
    the reference passes its recompile counter: this passes the
    selection kernels' launches during the dispatch (:class:`LaunchCounts`),
    so the sidecar's ``jit_cache`` holds launches, not compiled shapes."""
    from repro_torch.fleet import N_TENANTS, build_fleet_batch, run_fleet
    from repro_torch.fleet.runner import assert_all_ok
    from repro_torch.obs import ObsConfig, Profiler, emit_fleet_obs

    programs, dyn, _ = build_fleet_batch(eng, configs, n_devices=n_devices)
    obs = ObsConfig(n_buckets=n_buckets, n_tenants=N_TENANTS + 1)
    prof = Profiler()
    launches = LaunchCounts()
    res = run_fleet(eng, programs, dyn=dyn, n_tenants=N_TENANTS, obs=obs,
                    profiler=prof)
    assert_all_ok(res)
    labels = [f"{fc.describe()}/dev{d}"
              for fc in configs for d in range(n_devices)]
    return emit_fleet_obs(
        res, eng, obs=obs, out_prefix=out_prefix, lane_labels=labels,
        profiler=prof, recompiles=launches,
        meta={"n_configs": len(configs), "n_devices": n_devices,
              **(meta or {})})


def run_enumerative(args, eng, axes, n_devices, b: Bench) -> dict:
    """grid / random: one batched dispatch, Pareto front of the rows."""
    configs = (random_space(args.seed, args.random, **axes)
               if args.strategy == "random" else grid_space(**axes))
    t0 = time.perf_counter()
    ev = Evaluator(eng, n_devices=n_devices, weights=tuple(args.weights))
    rows = ev.evaluate(configs)
    total_us = (time.perf_counter() - t0) * 1e6
    rows = score_rows(rows, weights=tuple(args.weights))
    front = pareto_front(rows)

    per_config_us = total_us / len(rows)
    for r in rows:
        b.add(f"fleet_{r['config']}", per_config_us,
              ";".join(f"{k}={r[k]:.4g}" for k in DERIVED_KEYS))
    b.add("fleet_search_total", total_us,
          f"n_configs={len(rows)};n_devices={n_devices};"
          f"strategy={args.strategy};"
          f"dispatches={ev.n_dispatches:.0f}")
    b.add("pareto_front", 0.0, ";".join(r["config"] for r in front))
    return {
        "strategy": args.strategy,
        "weights": list(args.weights),
        "n_configs": len(rows),
        "n_devices": n_devices,
        "ledger": ev.ledger(),
        "front": front,
        "best_by_score": rows[0],
    }


def run_evolve(args, eng, axes, n_devices, b: Bench) -> dict:
    """Adaptive search: one row per generation + the Pareto archive."""
    space = SearchSpace(**{k: tuple(v) for k, v in axes.items()})
    params = EvolveParams(population=args.population,
                          generations=args.generations)
    t0 = time.perf_counter()
    res = evolve(eng, space=space, params=params, seed=args.seed,
                 n_devices=n_devices, weights=tuple(args.weights),
                 target=args.target)
    total_us = (time.perf_counter() - t0) * 1e6
    for h in res.history:
        b.add(f"evolve_gen{h['generation']}",
              total_us / len(res.history),
              f"best_so_far={h['best_so_far']:.4g};"
              f"best_of_gen={h['best_of_gen']:.4g};"
              f"dispatches={h['n_dispatches']:.0f};"
              f"evals={h['n_evals']:.3g};lane_ops={h['lane_ops']:.0f}")
    b.add("evolve_total", total_us,
          f"generations={len(res.history)};population={params.population};"
          f"best={res.best['config']};"
          f"best_objective={res.history[-1]['best_so_far']:.4g};"
          f"reached_target={res.reached_target}")
    b.add("pareto_front", 0.0,
          ";".join(r["config"] for r in res.archive))
    return {
        "strategy": "evolve",
        "weights": list(args.weights),
        "seed": args.seed,
        "n_devices": n_devices,
        "params": {"population": params.population,
                   "generations": params.generations,
                   "rung_fidelities": list(params.rung_fidelities),
                   "eta": params.eta},
        "ledger": res.ledger,
        "history": res.history,
        "front": res.archive,
        "best_by_score": res.best,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--strategy", choices=("grid", "random", "evolve"),
                    default="grid")
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--random", type=int, default=0,
                    help="sample N random configs (implies --strategy "
                         "random; `--strategy random` alone samples "
                         "as many configs as the grid holds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--population", type=int, default=8,
                    help="evolve: candidates per generation")
    ap.add_argument("--generations", type=int, default=4)
    ap.add_argument("--target", type=float, default=None,
                    help="evolve: stop once the objective reaches this")
    ap.add_argument("--weights", type=float, nargs=3,
                    default=(1.0, 1.0, 1.0),
                    metavar=("W_DLWA", "W_WEAR", "W_P99"))
    ap.add_argument("--specs", type=str,
                    default="superblock,block,vchunk2",
                    help="comma-separated element-spec axis; >1 spec "
                         "builds the padded union engine (mixed-spec "
                         "lanes, one dispatch)")
    ap.add_argument("--policies", type=str, default="traditional",
                    help="comma-separated alloc_policy axis "
                         "(traditional and/or silent); 'silent' lanes "
                         "commit zone blocks on the fly (SilentZNS)")
    ap.add_argument("--workload", choices=("lsm", "ckpt", "cache"),
                    default=None,
                    help="score configs against recorded application "
                         "traffic (trace compiler): restrict the "
                         "tenant-mix axis to this workload's compiled "
                         "programs and write the per-tenant-class p99 "
                         "predictability report "
                         "(fleet_workload_<name>.json)")
    ap.add_argument("--out", type=str, default="fleet_pareto.json",
                    help="Pareto front JSON ('' to skip)")
    ap.add_argument("--obs", action="store_true",
                    help="flight-record the Pareto front: write a "
                         "Perfetto trace + telemetry sidecar")
    ap.add_argument("--obs-prefix", type=str, default="fleet",
                    help="--obs artifact prefix (<prefix>_trace.json, "
                         "<prefix>_obs.json)")
    ap.add_argument("--obs-configs", type=int, default=8,
                    help="--obs: at most this many front configs")
    ap.add_argument("--quick", action="store_true",
                    help="smaller axes (CI smoke): 8 configs, 3 devices")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None) -> dict:
    """Run the search as the command line asks; print the CSV rows and
    write the files.  Returns the report that ``--out`` writes."""
    ap = parser()
    args = ap.parse_args(argv)
    try:
        specs = tuple(parse_spec(s) for s in args.specs.split(","))
    except argparse.ArgumentTypeError as exc:
        ap.error(str(exc))   # clean usage error, not a raw traceback
    policies = tuple(p.strip() for p in args.policies.split(",")
                     if p.strip())
    bad = [p for p in policies if p not in ("traditional", "silent")]
    if bad or not policies:
        ap.error(f"--policies must name traditional and/or silent, "
                 f"got {args.policies!r}")
    if "silent" in policies and any(s.name == "fixed" for s in specs):
        ap.error("--policies silent cannot combine with --specs fixed "
                 "(FIXED elements have no block collection to vary)")
    if args.random and args.strategy == "grid":
        args.strategy = "random"
    if args.strategy == "random" and args.random < 1:
        # the grid's size
        args.random = len(grid_space(specs=specs, policies=policies))

    flash, zone = zn540()
    if args.quick:
        specs = specs[:1]
        axes = dict(segments=(22, 11), chunks=(1536,), parities=(False,),
                    wear=(True, False), specs=specs, policies=policies)
        n_devices = 3
    else:
        axes = dict(specs=specs, policies=policies)
        n_devices = args.devices
    if args.workload:
        import repro_torch.storage  # noqa: F401  registers the mixes
        axes["mixes"] = (args.workload,)
    eng = ZoneEngine(flash, zone, specs if len(specs) > 1 else specs[0],
                     max_active=14, device=args.device)

    b = Bench()
    if args.strategy == "evolve":
        report = run_evolve(args, eng, axes, n_devices, b)
    else:
        report = run_enumerative(args, eng, axes, n_devices, b)
    b.emit()

    if args.out:
        pathlib.Path(args.out).write_text(
            json.dumps(report, indent=2) + "\n")
        print(f"# wrote {args.out} ({len(report['front'])} Pareto "
              f"configs)", file=sys.stderr)

    if args.workload:
        # the class-tagged dispatch: the same recorded traffic the
        # search scored, re-run with per-traffic-class tenant tags so
        # p99 predictability is attributable per stream
        from repro_torch.storage import run_workload
        _, wrep = run_workload(eng, args.workload, seed=args.seed)
        wrep.update(strategy=args.strategy, seed=args.seed,
                    best_by_score=report["best_by_score"]["config"])
        wpath = pathlib.Path(f"fleet_workload_{args.workload}.json")
        wpath.write_text(json.dumps(wrep, indent=2) + "\n")
        worst = max(v["p99_over_p50"]
                    for v in wrep["tenant_classes"].values())
        print(f"# wrote {wpath} (worst class p99/p50 = {worst:.2f})",
              file=sys.stderr)

    if args.obs:
        front_names = [r["config"] for r in report["front"]]
        all_axes = grid_space(**axes)
        by_name = {fc.describe(): fc for fc in all_axes}
        obs_configs = [by_name[n] for n in front_names
                       if n in by_name][: args.obs_configs]
        if not obs_configs:        # e.g. an empty front: record best
            obs_configs = all_axes[:1]
        paths = emit_obs_artifacts(
            eng, obs_configs, n_devices=n_devices,
            out_prefix=args.obs_prefix,
            meta={"strategy": args.strategy, "seed": args.seed,
                  "specs": ",".join(s.name for s in specs)})
        print(f"# wrote {paths['trace']} ({paths['n_events']} events) "
              f"and {paths['obs']}", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
