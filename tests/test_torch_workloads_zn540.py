"""The reference's summary of ``chip_smoke.py``'s phase 14, and its golden
file.

Phase 14 drives the port's per-op paper benchmarks and legacy oracles on
the card at the paper's sizes -- Fig. 4b / 7d's interference sweep at
zn540 through the device shim, ``LegacyZNSDevice`` and the batched engine
sweep; Fig. 9's FIO grid on custom16; Table 4's allocation latency; the
three engine-vs-legacy comparators; the KV lanes replayed through the
legacy device -- and holds every section to
``tests/data/torch_workloads_zn540.json``.  The card has no JAX, so this
file runs the same section code (``chip_smoke.workloads_section``)
through the reference on the CPU: ``python
tests/test_torch_workloads_zn540.py`` writes the file (~1.5 min),
and the tests below regenerate the sections that are cheap on the CPU and
compare them with it -- counts, DLWA and page totals exactly, clocks and
the interference factor at rel 1e-5 (the file may come from another
CPU), the float64 wear statistics at rel 1e-12 (as phase 13 holds them).
"""

import json
import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import repro.array as RA
import repro.fleet as RFL
import repro.storage as RS
from repro.core import device as R_DEV
from repro.core import elements as R_EL
from repro.core import engine as RE
from repro.core import geometry as R_GEO
from repro.core import headline as RH
from repro.core import timing as RT
from repro.core import workloads as RW
from repro.core.device_legacy import LegacyZNSDevice as RLegacy

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402

GOLDEN = (pathlib.Path(__file__).with_name("data")
          / "torch_workloads_zn540.json")
#: the sections a tier-1 run regenerates, 2-25 s each through the
#: reference on the CPU; the fleet comparator (~40 s: 44 configs replayed
#: per-op with page-granular timing, then timed again) is held to the
#: file by the card's run only
CHEAP_SECTIONS = ("interference", "fio", "alloc_latency", "engine_vs_legacy",
                  "array_vs_legacy", "kv_legacy")


def reference_package():
    """Phase 14's view of the reference package."""
    return SimpleNamespace(
        workloads=RW, elements=R_EL, geometry=R_GEO, engine=RE, timing=RT,
        headline=RH, fleet=RFL, fleet_search=sys.modules[
            "repro.fleet.search"], array=RA, storage=RS, kw={},
        shim=R_DEV.ZNSDevice, legacy=RLegacy, make_engine=RW.make_engine,
        headline_engine=RH.build_headline_engine)


def workloads_zn540_golden(sections=CS.WORKLOAD_SECTIONS) -> dict:
    """Phase 14's sections through the reference, as the golden file
    holds them."""
    P = reference_package()
    out = {"params": json.loads(json.dumps(CS.WORKLOAD_PARAMS))}
    for name in sections:
        out[name] = CS.golden_part(CS.workloads_section(P, np, name))
    return out


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_file_holds_every_section_with_this_scripts_params(golden):
    assert sorted(golden) == sorted(("params",) + CS.WORKLOAD_SECTIONS)
    assert golden["params"] == json.loads(json.dumps(CS.WORKLOAD_PARAMS))


def test_golden_paths_agree_in_the_reference(golden):
    """The file was written with every path of (a) and (b) equal to the
    others, as the card's run must find them."""
    for spec in CS.WORKLOAD_PARAMS["interference"]["specs"]:
        assert golden["interference"][spec]["legacy_equal"]
        assert golden["interference"][spec]["sweep_equal"]
    assert golden["fio"]["engine_equal"] and golden["fio"]["shim_equal"]
    assert golden["engine_vs_legacy"]["interference_recompiles"] == 0.0


@pytest.mark.parametrize("section", CHEAP_SECTIONS)
def test_golden_section_is_current(golden, section):
    """Regenerating one section through the reference on the CPU gives
    the committed file's (clocks at rel 1e-5, wear statistics at rel
    1e-12, everything else exactly)."""
    got = workloads_zn540_golden((section,))[section]
    assert CS.fleet_mismatches(got, golden[section], section,
                               time_keys=CS.WORKLOAD_TIME_KEYS) == []


if __name__ == "__main__":
    GOLDEN.parent.mkdir(exist_ok=True)
    GOLDEN.write_text(json.dumps(workloads_zn540_golden(), indent=1,
                                 sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
