"""The port's per-op legacy comparators held to the JAX package's on the
CPU.

``fleet.run_configs_legacy`` replays each config's merged logical program
through an object array over ``LegacyZNSDevice`` members (with the
page-granular fleet timing), ``fleet_vs_legacy_speedup`` times that
against the batched sweep after asserting every config's DLWA equal, and
``array_vs_legacy_speedup`` holds every engine-native array's report to
an object array over legacy members (``_legacy_array(oracle=True)``)
before timing.  On the reference tests' tiny device the port's legacy
rows equal the reference's exactly -- reports, wear CV and the
page-granular makespans, whose model equals the reference's scan bit for
bit -- and their DLWA equals the port's own engine rows.
"""

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
from repro.fleet import search as RS
from repro_torch.array.engine import _legacy_array
from repro_torch.core import engine as TE
from repro_torch.core.elements import BLOCK as T_BLOCK
from repro_torch.core.elements import SUPERBLOCK as T_SUPERBLOCK
from repro_torch.core.elements import vchunk as t_vchunk
from repro_torch.core.geometry import FlashGeometry as TFlash
from repro_torch.core.geometry import ZoneGeometry as TZone
from repro_torch.fleet import search as TS

#: ``tests/test_fleet.py``'s tiny device: 4 LUNs x 16 blocks of 4 pages
TINY = dict(n_channels=4, ways_per_channel=1, blocks_per_lun=16,
            pages_per_block=4, page_bytes=4096)
CONFIGS = [("dlwa_pair", 4, 8, True, True),
           ("dlwa_write", 2, 16, False, True),
           ("dlwa_pair", 2, 8, True, False)]
SPEC_SETS = {"superblock": ((R_SUPERBLOCK,), (T_SUPERBLOCK,)),
             "mixed": ((R_SUPERBLOCK, R_BLOCK, r_vchunk(2)),
                       (T_SUPERBLOCK, T_BLOCK, t_vchunk(2)))}


def fleet_pair(specs_name):
    r_specs, t_specs = SPEC_SETS[specs_name]
    reng = RE.ZoneEngine(RFlash(**TINY), RZone(4, 4),
                         r_specs if len(r_specs) > 1 else r_specs[0],
                         max_active=6)
    teng = TE.ZoneEngine(TFlash(**TINY), TZone(4, 4),
                         t_specs if len(t_specs) > 1 else t_specs[0],
                         max_active=6, device="cpu")
    if len(r_specs) == 1:
        rc = [RS.FleetConfig(*c) for c in CONFIGS]
        tc = [TS.FleetConfig(*c) for c in CONFIGS]
    else:
        rc = RS.grid_space(segments=(4,), chunks=(8,), parities=(False,),
                           wear=(True,), specs=r_specs)[:3]
        tc = TS.grid_space(segments=(4,), chunks=(8,), parities=(False,),
                           wear=(True,), specs=t_specs)[:3]
    return reng, teng, rc, tc


@pytest.mark.parametrize("fleet_timing", [False, True])
@pytest.mark.parametrize("specs_name", sorted(SPEC_SETS))
def test_run_configs_legacy_equals_the_reference(specs_name, fleet_timing):
    reng, teng, rc, tc = fleet_pair(specs_name)
    _, _, r_merged = RS.build_fleet_batch(reng, rc, n_devices=3)
    _, _, t_merged = TS.build_fleet_batch(teng, tc, n_devices=3)
    for a, b in zip(r_merged, t_merged):
        assert np.array_equal(a, b)
    want = RS.run_configs_legacy(RFlash(**TINY), reng.spec, rc, r_merged,
                                 parallelism=4, n_devices=3, max_active=6,
                                 fleet_timing=fleet_timing)
    got = TS.run_configs_legacy(TFlash(**TINY), teng.spec, tc, t_merged,
                                parallelism=4, n_devices=3, max_active=6,
                                fleet_timing=fleet_timing, device="cpu")
    assert got == want
    # the port's own batched rows: the same DLWA config for config
    rows = TS.evaluate_configs(teng, tc, n_devices=3)
    assert [r["dlwa"] for r in rows] == [r["dlwa"] for r in got]


@pytest.mark.parametrize("specs_name", sorted(SPEC_SETS))
def test_fleet_vs_legacy_speedup_matches_the_reference(specs_name):
    """End to end on the tiny device (the DLWA assert over every config
    runs inside): the reference's counts and keys; the legacy prefix
    timing scaled as recorded."""
    _, _, rc, tc = fleet_pair(specs_name)
    r_specs, t_specs = SPEC_SETS[specs_name]
    common = dict(repeats=1, n_devices=3, max_active=6, legacy_configs=2)
    want = RS.fleet_vs_legacy_speedup(
        configs=rc, flash=RFlash(**TINY), zone_geom=RZone(4, 4),
        specs=r_specs, **common)
    got = TS.fleet_vs_legacy_speedup(
        configs=tc, flash=TFlash(**TINY), zone_geom=TZone(4, 4),
        specs=t_specs, device="cpu", **common)
    assert sorted(got) == sorted(want)
    for k in ("n_configs", "n_devices", "fleet_ops", "legacy_timed_configs",
              "legacy_scale"):
        assert got[k] == want[k], k
    assert got["legacy_scale"] == 1.5
    assert all(got[k] > 0 for k in ("legacy_s", "legacy_replay_s",
                                     "engine_s", "speedup",
                                     "replay_speedup"))


def test_fleet_vs_legacy_speedup_needs_flash_and_zone_together():
    with pytest.raises(ValueError, match="together"):
        TS.fleet_vs_legacy_speedup(flash=TFlash(**TINY), device="cpu")


@pytest.mark.parametrize("specs_name", sorted(SPEC_SETS))
def test_array_vs_legacy_speedup_matches_the_reference(specs_name):
    """The array comparator on the tiny device: every array's report
    asserted against the legacy-member oracle inside, the reference's
    counts and keys outside."""
    r_specs, t_specs = SPEC_SETS[specs_name]
    common = dict(n_arrays=3, repeats=1, max_active=6, n_zones=2,
                  legacy_arrays=1)
    want = RA.array_vs_legacy_speedup(flash=RFlash(**TINY),
                                      zone_geom=RZone(4, 4),
                                      specs=r_specs, **common)
    got = TA.array_vs_legacy_speedup(flash=TFlash(**TINY),
                                     zone_geom=TZone(4, 4), specs=t_specs,
                                     device="cpu", **common)
    assert sorted(got) == sorted(want)
    for k in ("n_arrays", "lane_ops", "legacy_timed_arrays",
              "legacy_scale"):
        assert got[k] == want[k], k
    assert got["legacy_scale"] == 3.0


def test_legacy_array_oracle_equals_the_reference_and_the_engine():
    """``_legacy_array(oracle=True)``: the port's legacy-member object
    array, the reference's, and the port's engine-native array report
    the same (device reports too)."""
    from repro.array.engine import _legacy_array as r_legacy_array
    teng = TE.ZoneEngine(TFlash(**TINY), TZone(4, 4), T_SUPERBLOCK,
                         max_active=6, device="cpu")
    arrays, commands = TA.array_batch(teng, n_arrays=4, n_zones=2,
                                      max_active=6)
    TA.run_array_batch(arrays, pad_quantum=64)
    for a, cmds in zip(arrays, commands):
        mine = _legacy_array(TFlash(**TINY), TZone(4, 4), a.geom,
                             a.member_specs, max_active=6, oracle=True,
                             device="cpu")
        ref = r_legacy_array(RFlash(**TINY), RZone(4, 4), a.geom,
                             (R_SUPERBLOCK,) * len(a.member_specs),
                             max_active=6, oracle=True)
        TA.apply_commands(mine, cmds)
        RA.apply_commands(ref, cmds)
        assert mine.report() == ref.report() == a.report()
        assert mine.device_reports() == ref.device_reports()
        assert type(mine.devices[0]).__name__ == "LegacyZNSDevice"
