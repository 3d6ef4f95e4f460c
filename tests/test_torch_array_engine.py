"""The port's engine-native ZNS-RAID and rebuild storms held to the JAX
package on the CPU.

Every test drives the port's :class:`ArrayEngine`, the reference's, and
(where its oracle is the object array) the port's object ``ZNSArray``
over per-op ``ZNSDevice`` shims through one logical command list, and
demands equal ``report()`` / ``device_reports()``, read plans and error
strings; the batched dispatch, the per-op array timing (clocks at rel
1e-5) and the rebuild storm (reports, telemetry, a second call that adds
no launch plan) agree with the reference's; :func:`array_batch` builds
the reference comparator's engine leg.
"""

import random

import numpy as np
import pytest

import repro.array as RA
import repro_torch.array as TA
from repro.core import engine as RE
from repro.core.elements import BLOCK as R_BLOCK
from repro.core.elements import SUPERBLOCK as R_SUPERBLOCK
from repro.core.elements import vchunk as r_vchunk
from repro.core.geometry import FlashGeometry as RFlash
from repro.core.geometry import ZoneGeometry as RZone
from repro.obs import ObsConfig as RObs
from repro_torch.array.engine import _legacy_array
from repro_torch.core import engine as TE
from repro_torch.core import timing as TT
from repro_torch.core.elements import BLOCK as T_BLOCK
from repro_torch.core.elements import SUPERBLOCK as T_SUPERBLOCK
from repro_torch.core.elements import vchunk as t_vchunk
from repro_torch.core.geometry import FlashGeometry as TFlash
from repro_torch.core.geometry import ZoneGeometry as TZone
from repro_torch.obs import ObsConfig as TObs
from repro_torch.obs import RecompileCounter

#: ``tests/test_array_engine.py``'s tiny device
TINY = dict(n_channels=4, ways_per_channel=1, blocks_per_lun=16,
            pages_per_block=4, page_bytes=4096)
TIME_REL = 1e-5
SPEC_MIXES = {"sb_b_sb": ((R_SUPERBLOCK, R_BLOCK, R_SUPERBLOCK),
                          (T_SUPERBLOCK, T_BLOCK, T_SUPERBLOCK)),
              "b_v2_sb": ((R_BLOCK, r_vchunk(2), R_SUPERBLOCK),
                          (T_BLOCK, t_vchunk(2), T_SUPERBLOCK))}


def build_trio(n_devices, *, chunk_pages=None, parity=False,
               specs=(R_SUPERBLOCK, T_SUPERBLOCK), max_active=6):
    """(reference ArrayEngine, port ArrayEngine, the port's object
    ZNSArray over CPU shims) on the tiny geometry."""
    ref = RA.ArrayEngine.build(RFlash(**TINY), RZone(4, n_segments=4),
                               specs[0], n_devices=n_devices,
                               chunk_pages=chunk_pages, parity=parity,
                               max_active=max_active)
    port = TA.ArrayEngine.build(TFlash(**TINY), TZone(4, n_segments=4),
                                specs[1], n_devices=n_devices,
                                chunk_pages=chunk_pages, parity=parity,
                                max_active=max_active, device="cpu")
    obj = _legacy_array(TFlash(**TINY), TZone(4, n_segments=4),
                        port.geom, port.member_specs,
                        max_active=max_active, device="cpu")
    return ref, port, obj


def assert_same_reports(*arrays):
    want = arrays[0]
    for got in arrays[1:]:
        assert got.report() == want.report()
        assert got.device_reports() == want.device_reports()


def fuzz_commands(zp: int, seed: int) -> list:
    """``tests/test_array_engine.py``'s fuzzed command list."""
    rng = random.Random(seed)
    wp = {z: 0 for z in range(3)}
    cmds = []
    for _ in range(60):
        z = rng.randrange(3)
        verb = rng.choice(["write", "write", "write", "finish",
                           "reset", "read"])
        if verb == "write" and wp[z] is not None:
            n = min(rng.randrange(1, max(2, zp - wp[z] + 1)), zp - wp[z])
            if n <= 0:
                continue
            cmds.append(("write", z, n, rng.random() < 0.9))
            wp[z] += n
            if wp[z] == zp:
                wp[z] = None
        elif verb == "finish":
            cmds.append(("finish", z))
            wp[z] = None
        elif verb == "reset":
            cmds.append(("reset", z))
            wp[z] = 0
        elif verb == "read" and wp[z] and wp[z] > 0:
            cmds.append(("read", z, sorted(rng.sample(range(wp[z]),
                                                      min(4, wp[z])))))
    return cmds


@pytest.mark.parametrize("n_devices,chunk,parity", [
    (2, None, False), (2, 8, False),
    (3, None, True), (3, 4, True),
    (4, 16, True), (4, 8, False),
])
def test_fuzzed_arrays_report_like_the_reference(n_devices, chunk,
                                                 parity):
    arrays = build_trio(n_devices, chunk_pages=chunk, parity=parity)
    cmds = fuzz_commands(arrays[0].zone_pages,
                         1000 * n_devices + (chunk or 0) + int(parity))
    for a in arrays:
        TA.apply_commands(a, cmds)
    assert [m.tolist() for m in arrays[1].member_programs()] == \
        [m.tolist() for m in arrays[0].member_programs()]
    assert_same_reports(*arrays)


@pytest.mark.parametrize("mix", sorted(SPEC_MIXES))
def test_mixed_member_specs_report_like_the_reference(mix):
    arrays = build_trio(3, parity=True, specs=SPEC_MIXES[mix])
    assert arrays[1].member_specs == SPEC_MIXES[mix][1]
    cmds = TA.fill_commands(arrays[1].zone_pages, n_zones=2,
                            occupancy=0.7, churn=2)
    assert cmds == RA.fill_commands(arrays[0].zone_pages, n_zones=2,
                                    occupancy=0.7, churn=2)
    for a in arrays:
        TA.apply_commands(a, cmds)
    assert_same_reports(*arrays)


def _error(a, cmds):
    try:
        TA.apply_commands(a, cmds)
    except RuntimeError as e:
        return str(e)
    return None


def test_errors_are_the_reference_strings():
    for cmds in ([("write", 0, 10_000, True)],
                 [("finish", 0), ("write", 0, 1, True)],
                 [("read", 1, [0])]):
        ref, port, obj = build_trio(2)
        want = _error(ref, cmds)
        assert want is not None
        assert _error(port, cmds) == want == _error(obj, cmds)
    ref, port, _ = build_trio(3)
    for a in (ref, port):
        TA.apply_commands(a, [("write", 0, 40, True), ("fail", 1)])
    msgs = []
    for a in (ref, port):
        with pytest.raises(RuntimeError, match="parity is off") as e:
            a.zone_read(0, np.arange(40))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    ref, port, _ = build_trio(3, parity=False)
    port.fail_device(0)
    with pytest.raises(RuntimeError, match="requires parity"):
        port.rebuild_device(0)
    ref, port, _ = build_trio(3, parity=True)
    port.fail_device(0)
    with pytest.raises(RuntimeError, match="second device failure"):
        port.fail_device(1)


def test_degraded_read_plan_is_the_reference_plan():
    arrays = build_trio(3, parity=True)
    cmds = [("write", 0, 40, True), ("fail", 2),
            ("read", 0, list(range(40)))]
    for a in arrays:
        TA.apply_commands(a, cmds)
    ref, port, _ = arrays
    want = ref.zone_read(0, np.arange(40))
    got = port.zone_read(0, np.arange(40))
    assert 2 not in got
    assert {k: v.tolist() for k, v in got.items()} == \
        {k: v.tolist() for k, v in want.items()}
    assert_same_reports(*arrays)


@pytest.mark.parametrize("n_devices,chunk", [(3, None), (4, 8)])
def test_rebuild_round_trip_reports_like_the_reference(n_devices, chunk):
    arrays = build_trio(n_devices, chunk_pages=chunk, parity=True)
    zp = arrays[0].zone_pages
    written = max(1, int(zp * 0.8))
    cmds = (TA.fill_commands(zp, n_zones=2, occupancy=0.8)
            + [("write", 2, zp // 3, True), ("fail", 0),
               ("read", 0, list(range(0, written, 7)))])
    for a in arrays:
        TA.apply_commands(a, cmds)
    plans = [a.rebuild_device(0) for a in arrays[:2]]
    arrays[2].rebuild_device(0)
    assert plans[1] == plans[0]
    post = [("write", 2, zp // 4, True), ("read", 2, list(range(zp // 4)))]
    for a in arrays:
        TA.apply_commands(a, post)
        assert not a.failed
    assert_same_reports(*arrays)


def shared_engines():
    return (RE.ZoneEngine(RFlash(**TINY), RZone(4, 4), R_SUPERBLOCK,
                          max_active=6),
            TE.ZoneEngine(TFlash(**TINY), TZone(4, 4), T_SUPERBLOCK,
                          max_active=6, device="cpu"))


def test_batched_arrays_match_the_reference_and_solo_runs():
    r_eng, t_eng = shared_engines()

    def make(pkg, eng, i):
        a = pkg.ArrayEngine(eng, pkg.ArrayGeometry(2 + i % 2, 8,
                                                   bool(i % 2)))
        pkg.apply_commands(a, pkg.fill_commands(
            a.zone_pages, n_zones=2, occupancy=0.4 + 0.1 * i))
        return a

    ref = [make(RA, r_eng, i) for i in range(4)]
    batch = [make(TA, t_eng, i) for i in range(4)]
    solo = [make(TA, t_eng, i) for i in range(4)]
    RA.run_array_batch(ref, pad_quantum=16)
    results = TA.run_array_batch(batch, pad_quantum=16, sanitize=True)
    for r, b, s, res in zip(ref, batch, solo, results):
        assert b.report() == s.report() == r.report()
        assert b.device_reports() == s.device_reports() \
            == r.device_reports()
        want = r.result()
        for f in ("programs", "ok", "host_delta", "dummy_delta",
                  "erase_delta", "pages", "cols"):
            assert np.array_equal(getattr(res, f),
                                  np.asarray(getattr(want, f))), f


def test_fleet_timing_matches_the_reference():
    ref, port, _ = build_trio(2)
    for a in (ref, port):
        TA.apply_commands(a, [("write", 0, 16, True),
                              ("read", 0, list(range(16)))])
    want, got = ref.fleet_timing(), port.fleet_timing()
    assert sorted(got) == sorted(want) and got["fleet_pages"] > 0
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=TIME_REL, abs=0), k
    skip = [1, 0]
    want, got = ref.fleet_timing(skip_rows=skip), \
        port.fleet_timing(skip_rows=skip)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=TIME_REL, abs=0), k


def test_array_batch_is_the_reference_comparators_engine_leg():
    """``array_batch`` builds the arrays and commands the reference's
    ``array_vs_legacy_speedup`` builds (its loop, written out in
    ``tests/test_torch_fleet_zn540.py``), and they report alike."""
    from test_torch_fleet_zn540 import reference_array_batch
    r_eng, t_eng = shared_engines()
    ref, r_cmds = reference_array_batch(r_eng, n_arrays=8, n_zones=2,
                                        max_active=6)
    port, t_cmds = TA.array_batch(t_eng, n_arrays=8, n_zones=2,
                                  max_active=6)
    assert t_cmds == r_cmds
    assert [a.geom for a in port] == [TA.ArrayGeometry(
        a.geom.n_devices, a.geom.chunk_pages, a.geom.parity) for a in ref]
    RA.run_array_batch(ref, pad_quantum=64)
    TA.run_array_batch(port, pad_quantum=64)
    for r, t in zip(ref, port):
        assert t.report() == r.report()


def _storm_scenarios(pkg):
    return [pkg.StormScenario(n_devices=3, n_zones_filled=1,
                              occupancy=0.5),
            pkg.StormScenario(n_devices=4, n_zones_filled=1,
                              occupancy=0.6, chunk_pages=8)]


def test_rebuild_storm_matches_the_reference_and_keeps_its_plans():
    r_eng, t_eng = shared_engines()
    want = RA.rebuild_storm(r_eng, _storm_scenarios(RA),
                            obs=RObs(8, 3), pad_quantum=16)
    counter = RecompileCounter(run_programs=TE.run_programs,
                               simulate_fleet_ops=TT.simulate_fleet_ops)
    got = TA.rebuild_storm(t_eng, _storm_scenarios(TA), obs=TObs(8, 3),
                           pad_quantum=16)
    assert len(got["scenarios"]) == len(want["scenarios"]) == 2
    for g, w in zip(got["scenarios"], want["scenarios"]):
        assert sorted(g) == sorted(w)
        for k in w:
            if k.endswith("_s") or k == "rebuild_interference":
                assert g[k] == pytest.approx(w[k], rel=TIME_REL, abs=0), k
            else:
                assert g[k] == w[k], k
        assert g["rebuild_interference"] >= 1.0
    for g, w in zip(got["telemetry"], want["telemetry"]):
        for f in type(w)._fields:
            assert np.array_equal(getattr(g, f).numpy(),
                                  np.asarray(getattr(w, f))), f
    before = counter.counts()
    again = TA.rebuild_storm(t_eng, _storm_scenarios(TA), obs=TObs(8, 3),
                             pad_quantum=16)
    assert sum(counter.delta(before).values()) == 0
    assert again["scenarios"] == got["scenarios"]


def test_rebuild_storm_empty():
    _, t_eng = shared_engines()
    assert TA.rebuild_storm(t_eng, []) == {"scenarios": [],
                                           "telemetry": None}
