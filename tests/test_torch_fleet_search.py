"""The port's allocator design-space search held to the JAX package on the
CPU, at the tiny geometries of ``tests/test_fleet.py`` and
``tests/test_union_spec.py``.

* the candidate codec: ``grid_space`` / ``random_space`` /
  ``SearchSpace`` encode, decode and name the reference's configs;
* ``build_fleet_batch``: programs, lane configs and merged logical
  programs exactly (fidelity cuts, pad quantum, parity, union specs,
  mixed member counts, silent policy), and the reference's errors;
* ``Evaluator`` / ``evaluate_configs`` rows exactly, with the clocks at
  rel 1e-5; its ledger, ``score_rows`` rankings and ``pareto_front``
  flags; the sanitizer and the empty batch;
* the recorded workload mixes the port registers equal the reference's.
"""

import numpy as np
import pytest

import repro.fleet as RFL
import repro.storage.compile  # noqa: F401  (registers the reference mixes)
import repro_torch.fleet as TFL
import repro_torch.storage.compile  # noqa: F401
from repro.core import engine as RE
from repro.core.elements import BLOCK as R_BLOCK
from repro.core.elements import FIXED as R_FIXED
from repro.core.elements import SUPERBLOCK as R_SUPERBLOCK
from repro.core.elements import hchunk as r_hchunk
from repro.core.elements import vchunk as r_vchunk
from repro.core.geometry import FlashGeometry as RFlash
from repro.core.geometry import ZoneGeometry as RZone
from repro_torch.core import engine as TE
from repro_torch.core.elements import BLOCK as T_BLOCK
from repro_torch.core.elements import FIXED as T_FIXED
from repro_torch.core.elements import SUPERBLOCK as T_SUPERBLOCK
from repro_torch.core.elements import hchunk as t_hchunk
from repro_torch.core.elements import vchunk as t_vchunk
from repro_torch.core.geometry import FlashGeometry as TFlash
from repro_torch.core.geometry import ZoneGeometry as TZone

#: ``tests/test_fleet.py``'s tiny device
TINY = dict(n_channels=4, ways_per_channel=1, blocks_per_lun=16,
            pages_per_block=4, page_bytes=4096)
AXES = dict(segments=(4, 2), chunks=(8, 16))
TIME_REL = 1e-5
TIME_KEYS = {"p99_latency_s", "makespan_s"}
#: spec name -> (reference spec, port spec)
SPECS = {"superblock": (R_SUPERBLOCK, T_SUPERBLOCK),
         "block": (R_BLOCK, T_BLOCK),
         "vchunk2": (r_vchunk(2), t_vchunk(2)),
         "hchunk2": (r_hchunk(2), t_hchunk(2)),
         "fixed": (R_FIXED, T_FIXED)}
UNION = ("superblock", "block", "vchunk2")


def engines(specs=("superblock",), n_segments=4, max_active=6):
    """(reference, port) engines on the tiny device over ``specs`` (a
    union config when there are several)."""
    pair = []
    for i, (E, flash, zone, kw) in enumerate((
            (RE, RFlash, RZone, {}), (TE, TFlash, TZone,
                                      {"device": "cpu"}))):
        sp = tuple(SPECS[s][i] for s in specs)
        pair.append(E.ZoneEngine(flash(**TINY), zone(4, n_segments),
                                 sp if len(sp) > 1 else sp[0],
                                 max_active=max_active, **kw))
    return pair


def configs_of(pkg, i, rows):
    """``FleetConfig``\\ s of package ``pkg`` (``i`` 0 reference, 1
    port) from ``(mix, n_segments, chunk, parity, wear, spec names,
    n_devices, policy)`` rows."""
    out = []
    for mix, seg, chunk, parity, wear, spec, nd, policy in rows:
        sp = tuple(SPECS[s][i] for s in spec)
        out.append(pkg.FleetConfig(mix, seg, chunk, parity, wear,
                                   sp if len(sp) > 1 else sp[0], nd,
                                   policy))
    return out


MIXED_ROWS = [
    ("dlwa_pair", 4, 8, True, True, ("block",), 3, "traditional"),
    ("dlwa_write", 2, 16, False, True, ("superblock",), 4, "traditional"),
    ("dlwa_pair", 2, 8, True, False, ("superblock", "block"), 3,
     "traditional"),
    ("dlwa_write", 4, 8, False, True, ("vchunk2",), 0, "silent"),
]


def assert_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), w["config"]
        for k, v in w.items():
            if k in TIME_KEYS:
                assert g[k] == pytest.approx(v, rel=TIME_REL, abs=0), k
            else:
                assert g[k] == v, (w["config"], k)


def assert_same_dyn(got, want):
    for f, g, w in zip(want._fields, got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), f


# --------------------------------------------------------------------- #
# the candidate codec
# --------------------------------------------------------------------- #
def test_grid_and_random_spaces_are_the_references():
    assert [c.describe() for c in TFL.grid_space(**AXES)] == \
        [c.describe() for c in RFL.grid_space(**AXES)]
    assert len(TFL.grid_space()) == 32
    for seed in (3, 7, 8):
        assert [c.describe() for c in TFL.random_space(seed, 8, **AXES)] \
            == [c.describe() for c in RFL.random_space(seed, 8, **AXES)]
    assert TFL.random_space(7, 8, **AXES) == TFL.random_space(7, 8, **AXES)
    assert TFL.random_space(7, 8, **AXES) != TFL.random_space(8, 8, **AXES)
    assert TFL.OBJECTIVE_KEYS == RFL.OBJECTIVE_KEYS
    assert TFL.N_TENANTS == RFL.N_TENANTS


@pytest.mark.parametrize("axes", ["default", "specs", "devices",
                                  "policies"])
def test_search_space_codec_is_the_references(axes):
    kw = {"default": ({}, {}),
          "specs": ({"specs": tuple(SPECS[s][0] for s in UNION)},
                    {"specs": tuple(SPECS[s][1] for s in UNION)}),
          "devices": ({"devices": (3, 4)}, {"devices": (3, 4)}),
          "policies": ({"policies": ("traditional", "silent")},
                       {"policies": ("traditional", "silent")})}[axes]
    r = RFL.SearchSpace(segments=(4, 2), chunks=(8, 16), **kw[0])
    t = TFL.SearchSpace(segments=(4, 2), chunks=(8, 16), **kw[1])
    assert len(t) == len(r)
    assert [len(a) for a in t.axes] == [len(a) for a in r.axes]
    for fr, ft in zip(r.grid(), t.grid()):
        assert ft.describe() == fr.describe()
        assert t.encode(ft) == r.encode(fr)
        assert t.decode(t.encode(ft)) == ft
    assert len({fc.describe() for fc in t.grid()}) == len(t)
    with pytest.raises(ValueError, match="no devices axis"):
        TFL.SearchSpace().encode(TFL.FleetConfig(
            "dlwa_pair", 4, 8, True, True, n_devices=3))
    with pytest.raises(ValueError, match="no policies axis"):
        TFL.SearchSpace().encode(TFL.FleetConfig(
            "dlwa_pair", 4, 8, True, True, alloc_policy="silent"))


# --------------------------------------------------------------------- #
# build_fleet_batch
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fidelity,pad_quantum", [(1.0, 1), (0.25, 1),
                                                  (1.0, 64), (0.5, 16)])
def test_build_fleet_batch_is_the_references(fidelity, pad_quantum):
    r_eng, t_eng = engines()
    want = RFL.build_fleet_batch(r_eng, RFL.random_space(3, 6, **AXES),
                                 n_devices=3, fidelity=fidelity,
                                 pad_quantum=pad_quantum)
    got = TFL.build_fleet_batch(t_eng, TFL.random_space(3, 6, **AXES),
                                n_devices=3, fidelity=fidelity,
                                pad_quantum=pad_quantum)
    assert np.array_equal(got[0], want[0])
    assert got[0].shape[1] % pad_quantum == 0
    assert_same_dyn(got[1], want[1])
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        assert np.array_equal(g, w)


def test_mixed_spec_member_count_batch_is_the_references():
    r_eng, t_eng = engines(("superblock", "block", "vchunk2"))
    want = RFL.build_fleet_batch(r_eng, configs_of(RFL, 0, MIXED_ROWS),
                                 n_devices=4)
    got = TFL.build_fleet_batch(t_eng, configs_of(TFL, 1, MIXED_ROWS),
                                n_devices=4)
    assert np.array_equal(got[0], want[0])
    assert_same_dyn(got[1], want[1])


def _error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


def test_build_fleet_batch_raises_the_reference_errors():
    r_eng, t_eng = engines(UNION)
    cases = [
        ([("dlwa_pair", 4, 8, False, True, ("hchunk2",), 0,
           "traditional")], {}),
        ([("dlwa_pair", 9, 8, False, True, ("block",), 0,
           "traditional")], {}),
        ([("dlwa_pair", 4, 8, False, True, ("block",), 0,
           "traditional")], {"fidelity": 0.0}),
    ]
    for rows, kw in cases:
        want = _error(RFL.build_fleet_batch, r_eng,
                      configs_of(RFL, 0, rows), n_devices=3, **kw)
        got = _error(TFL.build_fleet_batch, t_eng,
                     configs_of(TFL, 1, rows), n_devices=3, **kw)
        assert want is not None
        assert got.replace("repro_torch.", "repro.") == want
    r_fix, t_fix = engines(("fixed",))
    rows = [("dlwa_pair", 4, 8, False, True, ("fixed",), 0,
             "traditional")]
    assert _error(TFL.build_fleet_batch, t_fix, configs_of(TFL, 1, rows),
                  n_devices=2) == _error(RFL.build_fleet_batch, r_fix,
                                         configs_of(RFL, 0, rows),
                                         n_devices=2)


# --------------------------------------------------------------------- #
# Evaluator rows, ledger, rankings
# --------------------------------------------------------------------- #
def test_evaluator_rows_and_ledger_are_the_references():
    r_eng, t_eng = engines()
    r_ev = RFL.Evaluator(r_eng, n_devices=3)
    t_ev = TFL.Evaluator(t_eng, n_devices=3, sanitize=True)
    for fidelity in (1.0, 0.25):
        want = r_ev.evaluate(RFL.random_space(3, 6, **AXES),
                             fidelity=fidelity)
        got = t_ev.evaluate(TFL.random_space(3, 6, **AXES),
                            fidelity=fidelity)
        assert_rows(got, want)
        assert [t_ev.objective(r) for r in got] == pytest.approx(
            [r_ev.objective(r) for r in want], rel=TIME_REL, abs=0)
    assert t_ev.ledger() == r_ev.ledger()
    assert t_ev.evaluate([]) == [] and t_ev.ledger() == r_ev.ledger()


def test_mixed_spec_rows_are_the_references_and_homogeneous_engines():
    r_eng, t_eng = engines(UNION)
    want = RFL.evaluate_configs(r_eng, configs_of(RFL, 0, MIXED_ROWS),
                                n_devices=4)
    got = TFL.evaluate_configs(t_eng, configs_of(TFL, 1, MIXED_ROWS),
                               n_devices=4)
    assert_rows(got, want)
    rows = [r for r in MIXED_ROWS if len(r[5]) == 1 and r[6] == 0]
    for row, mine in zip(rows, [g for g, r in zip(got, MIXED_ROWS)
                                if r in rows]):
        _, single = engines(row[5])
        assert TFL.evaluate_configs(single, configs_of(TFL, 1, [row]),
                                    n_devices=4)[0] == mine


def test_score_rows_and_pareto_front_are_the_references():
    r_eng, t_eng = engines()
    want = RFL.evaluate_configs(r_eng, RFL.random_space(3, 8, **AXES),
                                n_devices=3)
    got = TFL.evaluate_configs(t_eng, TFL.random_space(3, 8, **AXES),
                               n_devices=3)
    for weights in ((1.0, 1.0, 1.0), (2.0, 0.5, 1.0)):
        w_ranked = RFL.score_rows(want, weights)
        g_ranked = TFL.score_rows(got, weights)
        assert [r["config"] for r in g_ranked] == \
            [r["config"] for r in w_ranked]
        assert [r["score"] for r in g_ranked] == pytest.approx(
            [r["score"] for r in w_ranked], rel=TIME_REL, abs=1e-12)
    w_front = RFL.pareto_front(w_ranked)
    g_front = TFL.pareto_front(g_ranked)
    assert [r["config"] for r in g_front] == [r["config"] for r in w_front]
    assert [r["pareto"] for r in g_ranked] == \
        [r["pareto"] for r in w_ranked]
    assert 1 <= len(g_front) <= len(g_ranked)


def test_search_objective_is_deterministic():
    _, t_eng = engines()
    configs = TFL.random_space(3, 6, **AXES)
    rows1 = TFL.score_rows(TFL.evaluate_configs(t_eng, configs,
                                                n_devices=3))
    rows2 = TFL.score_rows(TFL.evaluate_configs(t_eng, configs,
                                                n_devices=3))
    assert rows1 == rows2


# --------------------------------------------------------------------- #
# the recorded workload mixes
# --------------------------------------------------------------------- #
#: ``tests/test_trace_compile.py``'s device for the recorded mixes
BIG = dict(TINY, blocks_per_lun=32)


@pytest.mark.parametrize("name", ["lsm", "ckpt", "cache"])
def test_registered_mixes_are_the_references(name):
    """The recorded mixes the port's storage compiler registers record
    the reference's programs, and a fleet dispatch over them scores as
    the reference's does."""
    assert list(TFL.MIXES) == list(RFL.MIXES)
    r_eng = RE.ZoneEngine(RFlash(**BIG), RZone(4, 2), R_SUPERBLOCK,
                          max_active=8)
    t_eng = TE.ZoneEngine(TFlash(**BIG), TZone(4, 2), T_SUPERBLOCK,
                          max_active=8, device="cpu")
    cap = t_eng.cfg.zone_pages
    got = TFL.MIXES[name](t_eng, cap)
    want = RFL.MIXES[name](r_eng, cap)
    assert len(got) == len(want) == TFL.N_TENANTS
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    rows = [(name, 2, 16, parity, True, ("superblock",), 0, "traditional")
            for parity in (False, True)]
    assert_rows(TFL.evaluate_configs(t_eng, configs_of(TFL, 1, rows),
                                     n_devices=2),
                RFL.evaluate_configs(r_eng, configs_of(RFL, 0, rows),
                                     n_devices=2))
