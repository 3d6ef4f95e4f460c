"""The reference's summary of ``chip_smoke.py``'s phase 13, and its golden
file.

Phase 13 drives the port's allocator design-space search on the card at
the reference's ``tools/bench.py`` full-mode sizes on zn540 (the
128-lane fleet sweep, the mixed-spec union, evolve against random-32,
the telemetry batch, the plan-stability probe, 8 engine-native arrays
and two rebuild storms) and holds every section to
``tests/data/torch_fleet_zn540.json``.  The card has no JAX, so this file
runs the same section code (``chip_smoke.fleet_section``) through the
reference on the CPU: ``python tests/test_torch_fleet_zn540.py`` writes
the file, and the tests below regenerate sections and compare them with
it -- hashes, counts, DLWA and rankings exactly, clocks at rel 1e-5 (the
file may come from another CPU), and the float64 wear statistics at rel
1e-12 (the card's host runs another numpy release than this file's
writer, and the two gave some of these 2-3 ulp apart from the same
integer wear; a different summation order is the assumed cause).
"""

import json
import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import repro.array as RA
import repro.fleet as RFL
import repro.obs as RO
from repro.core import elements as R_EL
from repro.core import engine as RE
from repro.core import timing as RT
from repro.core.geometry import zn540 as r_zn540
from repro.obs import export as R_EXPORT

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402

GOLDEN = pathlib.Path(__file__).with_name("data") / "torch_fleet_zn540.json"


def reference_array_batch(eng, *, n_arrays: int, n_zones: int,
                          max_active: int = 14):
    """The engine leg of the reference's ``array_vs_legacy_speedup``
    (its arrays and command lists, built as it builds them)."""
    seg = eng.zone_geom.segment_pages(eng.flash)
    axis = [(n_dev, chunk, parity)
            for n_dev in (4, 3)
            for chunk in (seg, seg // 2)
            for parity in (True, False)]
    arrays, commands = [], []
    for i in range(n_arrays):
        n_dev, chunk, parity = axis[i % len(axis)]
        a = RA.ArrayEngine(eng, RA.ArrayGeometry(n_dev, chunk, parity),
                           member_specs=(eng.spec,) * n_dev,
                           max_active=max_active)
        cmds = RA.fill_commands(a.zone_pages, n_zones=n_zones,
                                occupancy=0.4 + 0.2 * (i % 3), churn=2)
        RA.apply_commands(a, cmds)
        arrays.append(a)
        commands.append(cmds)
    return arrays, commands


def reference_package(make_engine=None):
    """Phase 13's view of the reference package (a zn540 engine builder
    by default)."""
    if make_engine is None:
        def make_engine(spec):
            return RE.ZoneEngine(*r_zn540(), spec,
                                 max_active=CS.FLEET_PARAMS["max_active"])
    return SimpleNamespace(
        fleet=RFL, evolve=sys.modules["repro.fleet.evolve"], obs=RO,
        obs_export=R_EXPORT, array=RA, array_batch=reference_array_batch,
        elements=R_EL, engine=RE, timing=RT, make_engine=make_engine,
        host=np.asarray, sync=None)


def fleet_zn540_golden(sections=CS.FLEET_SECTIONS) -> dict:
    """Phase 13's sections through the reference at zn540, as the golden
    file holds them."""
    P = reference_package()
    out = {"params": json.loads(json.dumps(CS.FLEET_PARAMS))}
    for name in sections:
        out[name] = CS.golden_part(CS.fleet_section(P, np, name))
    return out


def assert_same(got, want, where: str) -> None:
    """Nested dicts/lists equal by the rule phase 13 holds the card to
    (``chip_smoke.fleet_mismatches``): clocks at rel 1e-5, wear
    statistics (float64 reductions that two numpy releases gave 2-3 ulp
    apart) at rel 1e-12, everything else exactly."""
    assert CS.fleet_mismatches(got, want, where) == []


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_file_holds_every_section_with_this_scripts_params(golden):
    assert sorted(golden) == sorted(("params",) + CS.FLEET_SECTIONS)
    assert golden["params"] == json.loads(json.dumps(CS.FLEET_PARAMS))


@pytest.mark.parametrize("section", CS.FLEET_SECTIONS)
def test_golden_section_is_current(golden, section):
    """Regenerating one section through the reference on the CPU gives
    the committed file's."""
    got = fleet_zn540_golden((section,))[section]
    assert_same(got, golden[section], section)


if __name__ == "__main__":
    GOLDEN.parent.mkdir(exist_ok=True)
    GOLDEN.write_text(json.dumps(fleet_zn540_golden(), indent=1,
                                 sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
