"""Evolutionary + successive-halving search over the batched evaluator
(the port of ``repro.fleet.evolve``).

Grid/random enumeration (:mod:`repro_torch.fleet.search`) *samples* the
allocator design space; this module *optimizes* over it, in the spirit
of SilentZNS's on-the-fly allocation search: a generation-based
evolutionary loop proposes :class:`~repro_torch.fleet.search.FleetConfig`
candidates by mutation/crossover on the :class:`SearchSpace` gene
vector (tenant mix, effective segments, stripe chunk, parity,
wear-awareness), and every generation is scored through the shared
:class:`~repro_torch.fleet.search.Evaluator` -- ONE batched
``run_programs`` dispatch per rung.

Cost control is a successive-halving (bandit) schedule inside each
generation: the population is first evaluated on *truncated* op
programs (``rung_fidelities[:-1]``, cheap low-fidelity rungs built by
cutting each merged tenant program to a prefix before striping), and
only the top ``1/eta`` survivors of each rung are promoted until the
final full-fidelity rung.  Only full-fidelity rows enter the
best-so-far curve and the persistent Pareto archive (merged across
generations via :func:`~repro_torch.fleet.search.pareto_front`), because
truncated metrics are comparable only within a rung.

Everything is deterministically seeded: candidate proposal threads one
``random.Random(seed)``, the evaluator is pure, and no wall-clock or
global RNG state is read -- same seed, same generation history, same
archive (``tests/test_torch_evolve.py`` holds both to the reference's).

Budget accounting rides the evaluator's ledger: ``n_dispatches``
(batched evaluator invocations), ``n_evals`` (full-fidelity-equivalent
config evaluations -- a config at fidelity *f* costs *f*), and
``lane_ops`` (scanned lane x op cells).  :func:`evolve_vs_random` is
the comparison the reference's ``tools/bench.py`` archives: random
search dispatched in population-sized batches vs evolve stopping at the
random-best target.
"""

from __future__ import annotations

import dataclasses
import math
import random as pyrandom
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine import ZoneEngine
from repro_torch.fleet.search import (Evaluator, FleetConfig, SearchSpace,
                                      pareto_front)


@dataclasses.dataclass(frozen=True)
class EvolveParams:
    """Knobs of the evolutionary + successive-halving loop.

    ``rung_fidelities`` must be ascending and end at 1.0 (the final,
    archive-feeding rung); each rung keeps the top ``ceil(n / eta)``
    candidates of the previous one.  ``elites`` is how many of the
    best-so-far configs are guaranteed a parent slot each generation
    (selection for the remaining slots is ``tournament``-way over all
    fully evaluated rows).
    """

    population: int = 8
    generations: int = 4
    elites: int = 2
    tournament: int = 2
    p_crossover: float = 0.6
    p_mutate: float = 0.35
    rung_fidelities: Tuple[float, ...] = (0.25, 1.0)
    eta: int = 2

    def __post_init__(self) -> None:
        if self.population < 1 or self.generations < 1:
            raise ValueError("population and generations must be >= 1")
        f = self.rung_fidelities
        if (not f or f[-1] != 1.0 or f[0] <= 0
                or any(b <= a for a, b in zip(f, f[1:]))):
            raise ValueError("rung_fidelities must strictly ascend and "
                             f"end at 1.0, got {f}")
        if self.eta < 2:
            raise ValueError("eta must be >= 2")


@dataclasses.dataclass
class EvolveResult:
    """Everything one :func:`evolve` run produced.

    ``history`` has one JSON-ready dict per generation::

        {"generation": g,
         "rungs": [{"fidelity": f, "candidates": [...],
                    "ranked": [...], "survivors": [...]}, ...],
         "best_of_gen": float, "best_so_far": float,
         "n_dispatches": float, "n_evals": float, "lane_ops": float}

    ``archive`` is the persistent Pareto set over every full-fidelity
    row of every generation; ``best`` the lowest-objective row found.
    ``reached_target`` is False when a ``target`` was given and the run
    exhausted its generations without matching it.
    """

    history: List[Dict]
    best: Dict
    archive: List[Dict]
    rows: Dict[str, Dict]          # config name -> full-fidelity row
    ledger: Dict[str, float]
    seed: int
    reached_target: bool


def mutate(genes: Sequence[int], space: SearchSpace,
           rng: pyrandom.Random, p: float) -> Tuple[int, ...]:
    """Per-gene: with probability ``p`` move to a *different* uniformly
    chosen index on that axis (single-value axes stay put)."""
    out = []
    for g, axis in zip(genes, space.axes):
        if len(axis) > 1 and rng.random() < p:
            g = (g + rng.randrange(1, len(axis))) % len(axis)
        out.append(g)
    return tuple(out)


def crossover(a: Sequence[int], b: Sequence[int],
              rng: pyrandom.Random) -> Tuple[int, ...]:
    """Uniform crossover: each gene from either parent, fair coin."""
    return tuple(x if rng.random() < 0.5 else y for x, y in zip(a, b))


def _halving_sizes(n: int, n_rungs: int, eta: int) -> List[int]:
    """Candidate count entering each rung: ``n``, then ceil(prev/eta)."""
    sizes = [n]
    for _ in range(n_rungs - 1):
        sizes.append(max(1, math.ceil(sizes[-1] / eta)))
    return sizes


def evolve(eng: ZoneEngine, *, space: Optional[SearchSpace] = None,
           params: Optional[EvolveParams] = None, seed: int = 0,
           n_devices: int = 4,
           weights: Tuple[float, float, float] = (1.0, 1.0, 1.0),
           target: Optional[float] = None,
           evaluator: Optional[Evaluator] = None) -> EvolveResult:
    """Run the seeded evolutionary + successive-halving search.

    Each generation proposes ``params.population`` *previously
    unproposed* configs (generation 0 uniformly at random; later ones
    by elite/tournament parent selection, uniform crossover, and
    per-gene mutation, falling back to fresh random samples when the
    operators keep landing on already-proposed configs), pushes them
    down the halving rungs, and merges the final rung's full-fidelity
    rows into the best-so-far curve and the Pareto archive.  A config
    eliminated at a low-fidelity rung is *not* retried later -- the
    halving gamble is that its truncated ranking was telling -- so no
    candidate is ever paid for twice.  Stops early when ``target`` (an
    :meth:`Evaluator.objective` value) is reached or the space is
    exhausted.
    """
    space = space or SearchSpace()
    params = params or EvolveParams()
    ev = evaluator or Evaluator(eng, n_devices=n_devices, weights=weights)
    rng = pyrandom.Random(seed)
    seen: Dict[str, Dict] = {}      # config name -> full-fidelity row
    proposed: set = set()           # every candidate ever dispatched
    genes_of: Dict[str, Tuple[int, ...]] = {}
    archive: List[Dict] = []
    best_row: Optional[Dict] = None
    history: List[Dict] = []
    reached = target is None

    def propose(generation: int) -> List[FleetConfig]:
        out: List[FleetConfig] = []
        parents = sorted(seen.values(), key=ev.objective)

        def admit(fc: FleetConfig) -> bool:
            name = fc.describe()
            if name in proposed:
                return False
            proposed.add(name)
            genes_of[name] = space.encode(fc)
            out.append(fc)
            return True

        def pick_parent(k: int) -> Tuple[int, ...]:
            if k < params.elites and k < len(parents):
                row = parents[k]              # elites seed the front slots
            else:
                row = min(rng.sample(parents,
                                     min(params.tournament, len(parents))),
                          key=ev.objective)
            return genes_of[row["config"]]

        tries = 0
        max_tries = 64 * params.population
        while len(out) < params.population and tries < max_tries:
            tries += 1
            if generation == 0 or not parents:
                admit(space.decode(space.sample_genes(rng)))
                continue
            g1 = pick_parent(len(out))
            if rng.random() < params.p_crossover and len(parents) > 1:
                # slot >= elites always tournament-selects the mate
                child = crossover(g1, pick_parent(params.elites), rng)
            else:
                child = g1
            child = mutate(child, space, rng, params.p_mutate)
            if not admit(space.decode(child)):
                # operators drifted onto a seen config: random restart
                admit(space.decode(space.sample_genes(rng)))
        return out

    for gen in range(params.generations):
        if len(proposed) >= len(space):
            break                              # space exhausted
        cands = propose(gen)
        if not cands:
            break
        by_name = {fc.describe(): fc for fc in cands}
        rungs: List[Dict] = []
        current = list(cands)
        rows: List[Dict] = []
        for i, f in enumerate(params.rung_fidelities):
            rows = ev.evaluate(current, fidelity=f)
            ranked = sorted(rows, key=ev.objective)
            if i == len(params.rung_fidelities) - 1:
                survivors = [r["config"] for r in ranked]
            else:
                keep = max(1, math.ceil(len(current) / params.eta))
                survivors = [r["config"] for r in ranked[:keep]]
            rungs.append({
                "fidelity": float(f),
                "candidates": [fc.describe() for fc in current],
                "ranked": [r["config"] for r in ranked],
                "survivors": list(survivors),
            })
            current = [by_name[name] for name in survivors]
        for r in rows:                         # final rung: full fidelity
            seen[r["config"]] = r
        archive = pareto_front(archive + rows)
        gen_best = min(rows, key=ev.objective)
        if best_row is None or ev.objective(gen_best) < ev.objective(best_row):
            best_row = gen_best
        row = {
            "generation": gen,
            "rungs": rungs,
            "best_of_gen": ev.objective(gen_best),
            "best_so_far": ev.objective(best_row),
            **ev.ledger(),
        }
        if ev.profiler is not None:
            # opt-in observability (repro_torch.obs): launch-plan
            # readings per generation -- flat after warmup proves the
            # dispatch kept its argument signatures.  Gated on the
            # profiler because plan counts are process-global (recording
            # them unconditionally would break same-process seeded
            # determinism of the history).
            row["jit_cache"] = ev.jit_cache()
            row["profile"] = ev.profiler.snapshot()
        history.append(row)
        if target is not None and ev.objective(best_row) <= target:
            reached = True
            break

    assert best_row is not None, "evolve ran zero generations"
    return EvolveResult(history=history, best=best_row, archive=archive,
                        rows=seen, ledger=ev.ledger(), seed=seed,
                        reached_target=reached)


def evolve_vs_random(eng: ZoneEngine, *,
                     space: Optional[SearchSpace] = None,
                     params: Optional[EvolveParams] = None,
                     random_n: int = 32, seed: int = 0,
                     n_devices: int = 4,
                     weights: Tuple[float, float, float] = (1.0, 1.0, 1.0)
                     ) -> Dict:
    """The dispatches-to-target comparison (the reference's
    ``BENCH_fleet.json`` ``evolve`` section).

    Baseline: ``random_n`` configs sampled without replacement,
    evaluated at full fidelity in population-sized batches (an adaptive
    proposer can only act on completed batches, so batch sizes -- and
    therefore dispatch counts -- are protocol-matched).  Its best
    objective becomes evolve's ``target``; evolve runs until it matches
    it (or exhausts ``generations``).  Returns both ledgers plus the
    savings ratios; ``evolve.reached_target`` says whether the target
    was met -- the seeded acceptance test asserts it is, with
    ``n_evals`` at most half the random baseline's.
    """
    space = space or SearchSpace()
    params = params or EvolveParams()
    grid = space.grid()
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(grid), size=min(random_n, len(grid)),
                     replace=False)
    configs = [grid[i] for i in idx]

    ev_r = Evaluator(eng, n_devices=n_devices, weights=weights)
    random_rows: List[Dict] = []
    for i in range(0, len(configs), params.population):
        random_rows += ev_r.evaluate(configs[i:i + params.population])
    random_best = min(random_rows, key=ev_r.objective)
    target = ev_r.objective(random_best)

    res = evolve(eng, space=space, params=params, seed=seed,
                 n_devices=n_devices, weights=weights, target=target)
    ev_e = res.ledger
    out = {
        "random": {"n_configs": float(len(configs)),
                   "best_objective": target,
                   "best_config": random_best["config"],
                   **{k: float(v) for k, v in ev_r.ledger().items()}},
        "evolve": {"best_objective": res.history[-1]["best_so_far"],
                   "best_config": res.best["config"],
                   "generations": float(len(res.history)),
                   "reached_target": bool(res.reached_target),
                   "archive_size": float(len(res.archive)),
                   **{k: float(v) for k, v in ev_e.items()}},
    }
    for k in ("n_dispatches", "n_evals", "lane_ops"):
        out[f"{k}_savings"] = (out["random"][k] / out["evolve"][k]
                               if out["evolve"][k] else float("inf"))
    return out
