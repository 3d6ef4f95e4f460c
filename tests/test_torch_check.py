"""The port's check layer held to ``repro.check`` on the CPU.

On ``tests/test_check.py``'s fuzzed programs and dyn overrides (every
element spec, both allocation policies, stacked lanes), the port's
verifier gives the reference's verdicts -- ok bits, error classes, the
shim's messages, advisories, dummy sites, peak pressure, wear-bound
blocks and conflicts -- and its ok-mask equals the port engine's
``trace.ok``.  The sanitizer returns the reference's violation lists on
engine states and on the reference tests' corrupted states, reading the
port's tensors the way it reads numpy.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro import check as RC
from repro.core import engine as RE
from repro.core.elements import BLOCK as R_BLOCK
from repro.core.elements import FIXED as R_FIXED
from repro.core.elements import SUPERBLOCK as R_SUPERBLOCK
from repro.core.elements import hchunk as r_hchunk
from repro.core.elements import vchunk as r_vchunk
from repro_torch import check as TC
from repro_torch.core import engine as TE
from repro_torch.core.elements import BLOCK as T_BLOCK
from repro_torch.core.elements import FIXED as T_FIXED
from repro_torch.core.elements import SUPERBLOCK as T_SUPERBLOCK
from repro_torch.core.elements import hchunk as t_hchunk
from repro_torch.core.elements import vchunk as t_vchunk
from repro_torch.core.geometry import FlashGeometry as TFlash
from repro_torch.core.geometry import ZoneGeometry as TZone
from test_check import (fuzz_dyn, open_zone_state, random_program,
                        tiny_engine)

SPECS = [(R_BLOCK, T_BLOCK), (r_vchunk(2), t_vchunk(2)),
         (r_hchunk(2), t_hchunk(2)), (R_SUPERBLOCK, T_SUPERBLOCK),
         (R_FIXED, T_FIXED)]
_ENGINES = {}


def engines(spec_i):
    """``tests/test_check.py``'s tiny engine and the port's twin."""
    r_spec, t_spec = SPECS[spec_i]
    if t_spec.name not in _ENGINES:
        _ENGINES[t_spec.name] = TE.ZoneEngine(
            TFlash(n_channels=4, ways_per_channel=1, blocks_per_lun=8,
                   pages_per_block=4, page_bytes=4096),
            TZone(parallelism=4, n_segments=2), t_spec, max_active=3,
            device="cpu")
    return tiny_engine(r_spec), _ENGINES[t_spec.name]


def port_dyn(dyn):
    """The reference DynConfig as the port's (host tensors)."""
    return None if dyn is None else TE.dyn_from_numpy(
        [np.asarray(x) for x in dyn])


def port_state(cfg, state):
    return TE.state_from_numpy(cfg, [np.asarray(x) for x in state],
                               device="cpu")


def report_tuple(rep) -> tuple:
    """Every field of a ``ProgramReport``, verdicts as plain tuples."""
    return (rep.ok.tolist(),
            [dataclasses.astuple(v) for v in rep.verdicts],
            [dataclasses.astuple(v) for v in rep.advisories],
            rep.dummy_sites, rep.host_pages, rep.dummy_pages,
            rep.peak_active, rep.wear_bound_blocked, rep.conflicts,
            rep.dlwa_lower_bound, rep.all_ok)


def assert_same_verdicts(r_eng, t_eng, prog, dyn, ctx=""):
    want = RC.verify_program(r_eng.cfg, prog, dyn)
    got = TC.verify_program(t_eng.cfg, prog, port_dyn(dyn))
    assert report_tuple(got) == report_tuple(want), ctx
    _, trace = t_eng.run(t_eng.init_state(), prog, port_dyn(dyn))
    assert np.array_equal(got.ok, trace.ok.numpy()), ctx
    for i in range(0, len(prog), 5):
        assert dataclasses.astuple(TC.explain_op(
            t_eng.cfg, prog, i, port_dyn(dyn))) == dataclasses.astuple(
            RC.explain_op(r_eng.cfg, prog, i, dyn)), f"{ctx} op {i}"
    return want


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, len(SPECS) - 1),
       st.booleans())
def test_verifier_matches_the_reference_on_fuzzed_programs(seed, spec_i,
                                                           silent):
    if silent and SPECS[spec_i][0].name == "fixed":
        spec_i = 0            # make_dyn rejects silent-on-FIXED
    r_eng, t_eng = engines(spec_i)
    rng = np.random.default_rng(seed)
    dyn = fuzz_dyn(rng, r_eng, "silent" if silent else "traditional")
    assert_same_verdicts(r_eng, t_eng, random_program(rng, r_eng), dyn,
                         f"seed={seed} spec={spec_i} silent={silent}")


def test_verifier_and_sanitizer_match_the_reference_on_stacked_lanes():
    r_eng, t_eng = engines(0)
    rng = np.random.default_rng(7)
    programs = np.stack([random_program(rng, r_eng) for _ in range(4)])
    dyns = [r_eng.dyn(alloc_policy="traditional"),
            r_eng.dyn(alloc_policy="silent", wear_bound=1),
            r_eng.dyn(zone_pages=r_eng.cfg.zone_pages // 2, max_active=2),
            r_eng.dyn(alloc_policy="silent")]
    dyn = RE.stack_dyn(dyns)
    want = RC.verify_programs(r_eng.cfg, programs, dyn)
    got = TC.verify_programs(t_eng.cfg, programs, port_dyn(dyn))
    assert [report_tuple(x) for x in got] == [report_tuple(x) for x in want]
    states, _ = t_eng.run_batch(t_eng.init_state(), programs, port_dyn(dyn))
    r_states, _ = r_eng.run_batch(r_eng.init_state(), programs, dyn)
    assert TC.check_states(t_eng.cfg, states, port_dyn(dyn)) == \
        RC.check_states(r_eng.cfg, r_states, dyn) == [[], [], [], []]
    TC.assert_states(t_eng.cfg, states, port_dyn(dyn))
    TC.assert_states(t_eng.cfg, TE.state_to_numpy(states),
                     TE.dyn_to_numpy(port_dyn(dyn)))


@pytest.mark.parametrize("ops", [
    [(RE.OP_WRITE, 0, 32, 1), (RE.OP_WRITE, 0, 1, 1)],          # FULL
    [(RE.OP_WRITE, 1, 33, 1)],                                   # overflow
    [(RE.OP_WRITE, z, 1, 1) for z in range(4)],                  # limit
    [(RE.OP_READ, 2, 4, 0)],                                     # unmapped
    [(RE.OP_WRITE, 0, 6, 1), (RE.OP_FINISH, 0, 0, 0),
     (RE.OP_WRITE, 1, 3, 0), (RE.OP_FINISH, 1, 0, 0)],           # dummies
    [(RE.OP_WRITE, z, 1, 1) for z in range(3)]
    + [(RE.OP_FINISH, z, 0, 0) for z in range(3)],               # pressure
], ids=["full", "overflow", "limit", "unmapped", "dummy", "peak"])
def test_verdicts_and_messages_match_the_reference(ops):
    r_eng, t_eng = engines(0)
    prog = np.asarray(ops, np.int32)
    assert_same_verdicts(r_eng, t_eng, prog, None)
    assert_same_verdicts(r_eng, t_eng, prog,
                         r_eng.dyn(alloc_policy="silent", wear_bound=0))


def test_wear_bound_block_and_conflicts_match_the_reference():
    from repro.check import verifier as RV
    from repro_torch.check import verifier as TV
    r_eng, t_eng = engines(0)
    out = []
    for V, E, eng in ((RV, RE, r_eng), (TV, TE, t_eng)):
        dv = V._Dv(E.dyn_values(eng.cfg, eng.dyn(alloc_policy="silent",
                                                 wear_bound=0)))
        m = V._Model(eng.cfg, dv)
        m.wear[:] = 5
        m.wear[0] = 0
        out.append((m._alloc(0, 0), m.wear_bound_blocked))
    assert out[1] == out[0]
    assert out[0][0][1] == RC.ERR_ALLOC_INFEASIBLE == TC.ERR_ALLOC_INFEASIBLE
    r_fixed, t_fixed = engines(4)
    for r_dyn in (r_fixed.dyn()._replace(alloc_policy=RE.POLICY_SILENT),):
        assert TC.verify_program(t_fixed.cfg, np.zeros((1, 4), np.int32),
                                 port_dyn(r_dyn)).conflicts == \
            RC.verify_program(r_fixed.cfg, np.zeros((1, 4), np.int32),
                              r_dyn).conflicts
    r_dyn = r_eng.dyn()._replace(wear_bound=np.int32(-2))
    assert TC.verify_program(t_eng.cfg, np.zeros((1, 4), np.int32),
                             port_dyn(r_dyn)).conflicts == \
        RC.verify_program(r_eng.cfg, np.zeros((1, 4), np.int32),
                          r_dyn).conflicts


@pytest.mark.parametrize("spec_i", range(len(SPECS)))
def test_sanitizer_accepts_what_the_reference_accepts(spec_i):
    r_eng, t_eng = engines(spec_i)
    prog = random_program(np.random.default_rng(11 + spec_i), r_eng)
    state, _ = t_eng.run(t_eng.init_state(), prog)
    r_state, _ = r_eng.run(r_eng.init_state(), prog)
    assert TC.check_state(t_eng.cfg, state,
                          metrics=t_eng.metrics(state)) == \
        RC.check_state(r_eng.cfg, r_state,
                       metrics=r_eng.metrics(r_state)) == []


def _corruptions(eng, state):
    """``tests/test_check.py``'s corrupted states, as numpy leaves."""
    s = type(state)(*[np.asarray(x).copy() for x in state])
    wp = s.zone_wp.copy()
    wp[0] = eng.cfg.zone_pages + 7
    ze = s.zone_elems.copy()
    ze[2] = ze[0]
    av = s.elem_avail.copy()
    av[0] = 9
    w = s.elem_wear.copy()
    w[-1] = 3
    return [(s._replace(zone_wp=wp), {}),
            (s._replace(zone_elems=ze), {}),
            (s._replace(n_active=s.n_active + 1), {}),
            (s._replace(elem_avail=av), {}),
            (s, {"metrics": {"dlwa": 123.0}}),
            (s._replace(elem_wear=w), {}),
            (s._replace(host_pages=s.host_pages * 0 - 4),
             {"check_wear": False})]


def test_sanitizer_rejects_corruptions_as_the_reference_does():
    r_eng, t_eng = engines(0)
    r_state = open_zone_state(r_eng)
    for k, (bad, kw) in enumerate(_corruptions(r_eng, r_state)):
        want = RC.check_state(r_eng.cfg, bad, **kw)
        got = TC.check_state(t_eng.cfg, port_state(t_eng.cfg, bad), **kw)
        assert want and got == want, k
        errs = []
        for C, cfg, st_ in ((RC, r_eng.cfg, bad),
                            (TC, t_eng.cfg, port_state(t_eng.cfg, bad))):
            with pytest.raises(AssertionError) as exc:
                C.assert_state(cfg, st_, where="corrupt demo", **kw)
            errs.append((str(exc.value), exc.value.violations))
        assert errs[1] == errs[0]
