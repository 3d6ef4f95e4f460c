"""Fleet search on the port: find the Pareto-optimal zone allocation (the
counterpart of the reference's ``examples/fleet.py``).

Two tenant mixes x two effective zone geometries x two stripe chunks x
parity x allocator policy = 32 fleet configurations, every one expanded
to 4 member devices and all 128 lanes executed in one batched
``run_programs`` dispatch.  Configs are scored on the weighted (DLWA,
wear spread, p99 tenant latency) objective; the Pareto front is the
design-space answer the paper argues an allocator should search for.
The coda runs the adaptive searcher (:mod:`repro_torch.fleet.evolve`)
against the same space, stopping as soon as it matches the grid's best
objective::

    PYTHONPATH=src python -m repro_torch.tools.fleet_example [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.core import SUPERBLOCK, zn540
from repro_torch.core.engine import ZoneEngine
from repro_torch.fleet import (Evaluator, EvolveParams, SearchSpace,
                               evaluate_configs, evolve, grid_space,
                               pareto_front, score_rows)


def fleet_example(*, device="cuda") -> dict:
    """Print the example's report; return its scored rows, the front,
    the grid's best objective and the adaptive search's history, ledger,
    archive and whether it matched."""
    flash, zone = zn540()
    eng = ZoneEngine(flash, zone, SUPERBLOCK, max_active=14, device=device)
    configs = grid_space()

    t0 = time.perf_counter()
    rows = evaluate_configs(eng, configs, n_devices=4)
    dt = time.perf_counter() - t0
    rows = score_rows(rows)
    front = pareto_front(rows)
    print(f"evaluated {len(rows)} configs x 4 devices in {dt:.2f}s "
          f"(2 batched dispatches)\n")

    print("best 5 by weighted score (dlwa + wear_cv + p99, lower=better):")
    for r in rows[:5]:
        mark = "*" if r["pareto"] else " "
        print(f" {mark} {r['config']:<28} dlwa={r['dlwa']:.4f} "
              f"wear_cv={r['wear_cv']:.2f} "
              f"p99={r['p99_latency_s']:.2f}s score={r['score']:.3f}")

    print(f"\nPareto front ({len(front)} non-dominated configs):")
    for r in front:
        print(f"   {r['config']:<28} dlwa={r['dlwa']:.4f} "
              f"wear_cv={r['wear_cv']:.2f} p99={r['p99_latency_s']:.2f}s")

    best_dlwa = min(rows, key=lambda r: r["dlwa"])
    best_p99 = min(rows, key=lambda r: r["p99_latency_s"])
    best_wear = min(rows, key=lambda r: r["wear_cv"])
    print("\nthe trade-off the paper argues an allocator must search:")
    print(f"  lowest DLWA  : {best_dlwa['config']:<28} "
          f"dlwa={best_dlwa['dlwa']:.4f} "
          f"(p99={best_dlwa['p99_latency_s']:.2f}s)")
    print(f"  lowest p99   : {best_p99['config']:<28} "
          f"p99={best_p99['p99_latency_s']:.2f}s "
          f"(dlwa={best_p99['dlwa']:.4f})")
    print(f"  evenest wear : {best_wear['config']:<28} "
          f"wear_cv={best_wear['wear_cv']:.2f} "
          f"(dlwa={best_wear['dlwa']:.4f})")
    print(f"  equal-weight winner: {rows[0]['config']}")

    # adaptive search: match the grid's best with a fraction of the
    # budget (grid = 32 full-fidelity evals in 1 dispatch)
    ref = Evaluator(eng, n_devices=4)
    target = min(ref.objective(r) for r in rows)
    t0 = time.perf_counter()
    res = evolve(eng, space=SearchSpace(), seed=0, n_devices=4,
                 params=EvolveParams(population=8, generations=4),
                 target=target)
    dt = time.perf_counter() - t0
    led = res.ledger
    print(f"\nadaptive search (evolve, pop 8, halving rungs "
          f"{EvolveParams().rung_fidelities}):")
    for h in res.history:
        print(f"   gen {h['generation']}: best_so_far="
              f"{h['best_so_far']:.4f} after {h['n_evals']:.1f} "
              f"full-fidelity-equivalent evals "
              f"({h['n_dispatches']:.0f} dispatches)")
    print(f"   {'matched' if res.reached_target else 'missed'} the "
          f"grid-best objective {target:.4f} with "
          f"{led['n_evals']:.1f}/32 evals in {dt:.2f}s; "
          f"archive={len(res.archive)} Pareto configs")
    return {"rows": rows, "front": front, "target": target,
            "history": res.history, "ledger": led, "archive": res.archive,
            "reached_target": res.reached_target}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return fleet_example(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
