"""The port's evolutionary + successive-halving search held to the JAX
package on the CPU, at ``tests/test_evolve.py``'s seeded 2-tenant x
4-device fleet.

Proposal threads one ``random.Random(seed)`` and ranks candidates on
``Evaluator.objective`` (DLWA + wear CV + p99 latency), so a last-bit
difference in one clock could reorder a rung and change the whole
trajectory: the generation history (every rung's candidates, ranking and
survivors), the Pareto archive, the best row, the full-fidelity rows and
the budget ledger must equal the reference's -- the objectives and
clocks at rel 1e-5, everything else exactly.  Also the operators
(``mutate`` / ``crossover`` draw the reference's genes from the same
generator), ``EvolveParams`` validation, seeded determinism, elitist
monotonicity, the halving schedule, and ``evolve_vs_random``.
"""

import importlib
import math
import random

import pytest

import repro.fleet as RFL
import repro_torch.fleet as TFL
from repro.core import engine as RE
from repro.core.elements import SUPERBLOCK as R_SUPERBLOCK
from repro.core.geometry import FlashGeometry as RFlash
from repro.core.geometry import ZoneGeometry as RZone
from repro_torch.core import engine as TE
from repro_torch.core.elements import SUPERBLOCK as T_SUPERBLOCK
from repro_torch.core.geometry import FlashGeometry as TFlash
from repro_torch.core.geometry import ZoneGeometry as TZone

#: the evolve modules (the packages export the function ``evolve`` under
#: the module's name)
r_evolve_mod = importlib.import_module("repro.fleet.evolve")
t_evolve_mod = importlib.import_module("repro_torch.fleet.evolve")
TINY = dict(n_channels=4, ways_per_channel=1, blocks_per_lun=16,
            pages_per_block=4, page_bytes=4096)
AXES = dict(segments=(4, 2), chunks=(8, 16))    # 32 configs
TIME_REL = 1e-5
TIME_KEYS = {"p99_latency_s", "makespan_s", "best_of_gen", "best_so_far",
             "best_objective"}


def assert_same(got, want, where="", key=""):
    """Nested equality: objectives and clocks at rel 1e-5, the rest
    (names, rankings, counts, DLWA, ledgers) exactly."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}", k)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]", key)
    elif key in TIME_KEYS:
        assert got == pytest.approx(want, rel=TIME_REL, abs=0), where
    else:
        assert got == want, where


@pytest.fixture(scope="module")
def engines():
    return (RE.ZoneEngine(RFlash(**TINY), RZone(4, 4), R_SUPERBLOCK,
                          max_active=6),
            TE.ZoneEngine(TFlash(**TINY), TZone(4, 4), T_SUPERBLOCK,
                          max_active=6, device="cpu"))


@pytest.fixture(scope="module")
def results(engines):
    """Both packages' runs at seeds 0 and 1."""
    out = {}
    for seed in (0, 1):
        out[seed] = (
            RFL.evolve(engines[0], space=RFL.SearchSpace(**AXES),
                       params=RFL.EvolveParams(population=8,
                                               generations=3),
                       seed=seed, n_devices=4),
            TFL.evolve(engines[1], space=TFL.SearchSpace(**AXES),
                       params=TFL.EvolveParams(population=8,
                                               generations=3),
                       seed=seed, n_devices=4))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_history_archive_and_ledger_are_the_references(results, seed):
    want, got = results[seed]
    assert_same(got.history, want.history, "history")
    assert_same(got.archive, want.archive, "archive")
    assert_same(got.best, want.best, "best")
    assert_same(got.rows, want.rows, "rows")
    assert got.ledger == want.ledger
    assert (got.seed, got.reached_target) == (want.seed,
                                              want.reached_target)


def test_seeded_determinism(engines, results):
    _, got = results[1]
    rerun = TFL.evolve(engines[1], space=TFL.SearchSpace(**AXES),
                       params=TFL.EvolveParams(population=8,
                                               generations=3),
                       seed=1, n_devices=4)
    assert rerun.history == got.history
    assert [r["config"] for r in rerun.archive] == \
        [r["config"] for r in got.archive]
    other = results[0][1]
    assert [h["rungs"][0]["candidates"] for h in other.history] != \
        [h["rungs"][0]["candidates"] for h in got.history]


def test_best_objective_monotone_nonincreasing(results):
    hist = results[1][1].history
    curve = [h["best_so_far"] for h in hist]
    assert all(b <= a for a, b in zip(curve, curve[1:]))
    for h in hist:
        assert h["best_so_far"] <= h["best_of_gen"] + 1e-12


def test_halving_promotes_only_rung_survivors(results):
    params = TFL.EvolveParams(population=8, generations=3)
    for h in results[1][1].history:
        rungs = h["rungs"]
        assert [r["fidelity"] for r in rungs] == \
            list(params.rung_fidelities)
        for prev, nxt in zip(rungs, rungs[1:]):
            keep = max(1, math.ceil(len(prev["candidates"]) / params.eta))
            assert prev["survivors"] == prev["ranked"][:keep]
            assert nxt["candidates"] == prev["survivors"]
        assert rungs[-1]["survivors"] == rungs[-1]["ranked"]


def test_archive_is_nondominated(results):
    archive = results[1][1].archive
    keys = TFL.OBJECTIVE_KEYS
    for a in archive:
        for b in archive:
            if a is not b:
                assert not (all(b[k] <= a[k] for k in keys)
                            and any(b[k] < a[k] for k in keys))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_operators_draw_the_references_genes(seed):
    r_space, t_space = RFL.SearchSpace(**AXES), TFL.SearchSpace(**AXES)
    r_rng, t_rng = random.Random(seed), random.Random(seed)
    for _ in range(20):
        ga, gb = (t_space.sample_genes(t_rng),
                  t_space.sample_genes(t_rng))
        assert (ga, gb) == (r_space.sample_genes(r_rng),
                            r_space.sample_genes(r_rng))
        assert t_evolve_mod.crossover(ga, gb, t_rng) == \
            r_evolve_mod.crossover(ga, gb, r_rng)
        assert t_evolve_mod.mutate(ga, t_space, t_rng, 0.35) == \
            r_evolve_mod.mutate(ga, r_space, r_rng, 0.35)
    assert t_evolve_mod._halving_sizes(8, 3, 2) == \
        r_evolve_mod._halving_sizes(8, 3, 2)


@pytest.mark.parametrize("kw", [
    {"population": 0}, {"generations": 0}, {"rung_fidelities": (0.5,)},
    {"rung_fidelities": (0.5, 0.25, 1.0)}, {"rung_fidelities": ()},
    {"eta": 1}])
def test_params_validation_is_the_references(kw):
    with pytest.raises(ValueError) as want:
        RFL.EvolveParams(**kw)
    with pytest.raises(ValueError) as got:
        TFL.EvolveParams(**kw)
    assert str(got.value) == str(want.value)


def test_empty_batch_does_not_skew_ledger(engines):
    ev = TFL.Evaluator(engines[1], n_devices=4)
    assert ev.evaluate([]) == [] and ev.evaluate([], fidelity=0.25) == []
    assert (ev.n_dispatches, ev.n_evals, ev.lane_ops) == (0, 0.0, 0)
    ev.evaluate(TFL.SearchSpace(**AXES).grid()[:2])
    assert (ev.n_dispatches, ev.n_evals) == (1, 2.0)


def test_evolve_vs_random_is_the_references(engines):
    """The dispatches-to-target comparison: the reference's numbers, and
    its acceptance bar (evolve reaches the random-32 best on at most
    half the dispatches and evals)."""
    params = dict(population=8, generations=3)
    want = RFL.evolve_vs_random(engines[0], space=RFL.SearchSpace(**AXES),
                                params=RFL.EvolveParams(**params),
                                random_n=32, seed=0, n_devices=4)
    got = TFL.evolve_vs_random(engines[1], space=TFL.SearchSpace(**AXES),
                               params=TFL.EvolveParams(**params),
                               random_n=32, seed=0, n_devices=4)
    assert_same(got, want)
    assert got["evolve"]["reached_target"]
    assert got["evolve"]["n_dispatches"] <= \
        got["random"]["n_dispatches"] / 2
    assert got["evolve"]["n_evals"] <= got["random"]["n_evals"] / 2
