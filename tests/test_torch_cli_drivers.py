"""The reference's CLIs and examples as port-side drivers
(``src/repro_torch/tools/``: ``fleet_search``, ``obs_report``,
``raid_zns``, ``quickstart``, ``zns_design_space``, ``raid_array``,
``fleet_example``), held to the reference's scripts on the CPU, and the
golden file of ``chip_smoke.py``'s phase 18.

Phase 18 runs every driver of ``chip_smoke.CLI_RUNS`` on the card and
holds it to ``tests/data/torch_clis_zn540.json``.  The card has no JAX,
so ``python tests/test_torch_cli_drivers.py`` writes that file through
the reference's own ``benchmarks/`` and ``examples/`` scripts on the CPU
(~70 s): each run's printed lines with the clocks masked, the outputs of
the functions ``chip_smoke.CLI_SPIES`` names (read off the calls by
wrapping them) and the files it writes.  The file states each run's
command line; ``zns_design_space`` runs over the paper geometries P4, S32
and P16, S256 (the reference's example takes no flag: its geometry
constant is swapped for the call).

The tests below regenerate the cheap sections and compare them with the
file, and hold each port driver on the CPU to it at its size or smaller:
two of the RAID sweep's cells, and the design space's P4, S32 row one
element a case (the port's page-granular timing steps its plain loop on
the CPU; P16, S256 takes minutes).
"""

import ast
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.core import ZoneGeometry as RGeometry

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402
from benchmarks import fleet_search as RFS  # noqa: E402
from benchmarks import raid_zns as RRZ  # noqa: E402
from examples import fleet as RFLEET  # noqa: E402
from examples import quickstart as RQS  # noqa: E402
from examples import raid_array as RRA  # noqa: E402
from examples import zns_design_space as RDS  # noqa: E402

from repro_torch.core import ZoneGeometry  # noqa: E402
from repro_torch.tools import obs_report as TOBS  # noqa: E402
from repro_torch.tools import raid_zns as TRZ  # noqa: E402
from repro_torch.tools import zns_design_space as TDS  # noqa: E402

GOLDEN = (pathlib.Path(__file__).with_name("data")
          / "torch_clis_zn540.json")
TOOLS = ROOT / "src" / "repro_torch" / "tools"
#: the reference's script module, by port driver
REFERENCE = {"fleet_search": RFS, "raid_zns": RRZ, "quickstart": RQS,
             "zns_design_space": RDS, "raid_array": RRA,
             "fleet_example": RFLEET}
#: the sections a tier-1 run regenerates through the reference (3-8 s
#: each on the CPU)
CHEAP = ("fleet_search_workload", "raid_zns_parity", "raid_zns_rebuild",
         "quickstart")


def design_geometries(argv):
    """The reference geometries a ``zns_design_space`` command line names
    (all six without ``--geometries``)."""
    if "--geometries" not in argv:
        return None
    port = TDS.named_geometries(argv[argv.index("--geometries") + 1])
    return tuple(RGeometry(parallelism=g.parallelism,
                           n_segments=g.n_segments) for g in port)


def reference_run(name, cwd, runs=CS.CLI_RUNS) -> dict:
    """Run ``name`` through the reference's script on the CPU in ``cwd``,
    summarised as phase 18 summarises the port's runs."""
    driver, argv = runs[name]
    module = REFERENCE[driver]
    saved = RDS.PAPER_GEOMETRIES
    args = argv
    if driver == "zns_design_space":
        RDS.PAPER_GEOMETRIES = design_geometries(argv) or saved
        args = []
    try:
        run = CS.run_cli(module, args, driver, cwd,
                         script=CS.CLI_SCRIPTS[driver])
    finally:
        RDS.PAPER_GEOMETRIES = saved
    return CS.cli_summary(name, argv, run)


@contextlib.contextmanager
def one_thread():
    """Torch on one CPU thread while open: the engine's small tensors
    gain little from more (11.7 s on 8 threads, 14.4 s on one for
    ``fleet_example``), and a test's intra-op threads beside the other
    workers' slowed it 50x in a full ``-n 6`` run."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def port_run(name, cwd, runs=CS.CLI_RUNS) -> dict:
    """Run ``name`` through the port's driver on the CPU in ``cwd``."""
    driver, argv = runs[name]
    mods = CS.cli_modules()
    with one_thread():
        run = CS.run_cli(mods[driver], argv + ["--device", "cpu"], driver,
                         cwd)
    return CS.cli_summary(name, argv, run)


def clis_golden(cwd) -> dict:
    return {name: reference_run(name, cwd) for name in CS.CLI_RUNS}


def assert_same(name, got, want):
    bad = CS.cli_mismatches(name, got, want)
    assert bad == [], bad[:20]


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


# --------------------------------------------------------------------- #
# the golden file
# --------------------------------------------------------------------- #
def test_golden_file_holds_every_run(golden):
    assert sorted(golden) == sorted(CS.CLI_RUNS)
    for name, (driver, argv) in CS.CLI_RUNS.items():
        assert golden[name]["argv"] == argv, name
        assert golden[name]["lines"], name
    assert len(golden["raid_zns_sweep"]["spied"]["raid_benchmark"]) == 10
    rows = [line for line in golden["zns_design_space"]["lines"]
            if line.lstrip().startswith("P")]
    assert len(rows) == 4 + 6 and rows[0].split()[:2] == ["P16,", "S256"]
    assert golden["quickstart"]["lines"][3].split()[-1] == "86.4%"
    obs = golden["fleet_search_grid_obs"]["files"]
    assert obs["fleet_trace.json"]["n_events"] > 0
    assert sorted(obs) == sorted(CS.CLI_FILES[:1] + CS.CLI_FILES[2:])


@pytest.mark.parametrize("name", CHEAP)
def test_golden_section_is_current(golden, name, tmp_path):
    assert_same(name, reference_run(name, tmp_path), golden[name])


# --------------------------------------------------------------------- #
# the port's drivers against the golden file
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", (
    "fleet_search_random", "fleet_search_evolve",
    "fleet_search_workload", "raid_zns_parity", "raid_zns_rebuild",
    "quickstart", "raid_array", "fleet_example"))
def test_port_driver_equals_golden(golden, name, tmp_path):
    assert_same(name, port_run(name, tmp_path), golden[name])


@pytest.mark.parametrize("cell", (3, 8))
def test_raid_sweep_cell_equals_golden(golden, cell):
    """Two cells of ``raid_zns --quick``'s sweep (d2 with parity FIXED,
    d4 with parity SUPERBLOCK) through the port's ``raid_benchmark``."""
    name, n, c, p, s = TRZ.sweep_cells(True)[cell]
    want = golden["raid_zns_sweep"]
    assert want["lines"][cell].startswith(name + ",")
    with one_thread():
        got = TRZ.raid_benchmark(n_devices=n, chunk_pages=c, parity=p,
                                 spec=TRZ.SPECS[s], device="cpu")
    bad = CS.fleet_mismatches(
        CS.cli_jsonable(got), want["spied"]["raid_benchmark"][cell], name,
        time_keys=CS.CLI_TIME_KEYS)
    assert bad == [], bad


def test_raid_sweep_prints_the_references_rows(golden, monkeypatch):
    """The port's sweep prints the reference's row names and derived keys,
    in order (its cells stubbed with the golden file's reports)."""
    reps = iter(golden["raid_zns_sweep"]["spied"]["raid_benchmark"])
    monkeypatch.setattr(TRZ, "raid_benchmark", lambda **kw: next(reps))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TRZ.main(["--quick", "--device", "cpu"])
    got = CS.cli_summary("raid_zns_sweep", ["--quick"], {
        "lines": buf.getvalue().splitlines(), "spied": {}, "files": {}})
    assert got["lines"] == golden["raid_zns_sweep"]["lines"]


@pytest.mark.parametrize("element", ("fixed", "vchunk2"))
def test_design_space_row_equals_golden(golden, element):
    """The design space at P4, S32, one element a case, through the port:
    its printed row (clocks masked) and its three benchmarks' outputs."""
    geom = (ZoneGeometry(parallelism=4, n_segments=1),)
    spec = [e for e in TDS.ELEMENTS if e.name == element]
    buf = io.StringIO()
    spied = {k: [] for k in CS.CLI_SPIES["zns_design_space"]}
    with pytest.MonkeyPatch.context() as mp:
        for k in spied:
            inner = getattr(TDS, k)
            mp.setattr(TDS, k, lambda *a, _i=inner, _s=spied[k], **kw:
                       _s.append(_i(*a, **kw)) or _s[-1])
        with contextlib.redirect_stdout(buf), one_thread():
            TDS.design_space(device="cpu", geometries=geom, elements=spec)
    want = golden["zns_design_space"]
    rows = [i for i, line in enumerate(want["lines"])
            if line.split()[:3] == ["P4,", "S32", element]]
    assert len(rows) == 1
    got = CS.cli_summary("zns_design_space", [], {
        "lines": buf.getvalue().splitlines(), "spied": spied,
        "files": {}})
    assert got["lines"][1] == want["lines"][rows[0]]
    k = rows[0] - 1                     # the row's place among the calls
    for name, outs in got["spied"].items():
        bad = CS.fleet_mismatches(outs[0], want["spied"][name][k], name,
                                  time_keys=CS.CLI_TIME_KEYS)
        assert bad == [], bad


# --------------------------------------------------------------------- #
# the drivers' command lines
# --------------------------------------------------------------------- #
def test_fleet_search_refuses_what_the_reference_refuses(capsys):
    from repro_torch.tools import fleet_search as TFS
    for argv, msg in ((["--specs", "bogus"], "unknown element spec"),
                      (["--policies", "noisy"], "--policies must name"),
                      (["--specs", "fixed"], "unknown element spec")):
        for main in (TFS.main, lambda a: (setattr(
                sys, "argv", ["fleet_search.py"] + a), RFS.main())):
            saved = sys.argv
            try:
                with pytest.raises(SystemExit) as exc:
                    main(argv + ["--device", "cpu"] if main is TFS.main
                         else argv)
            finally:
                sys.argv = saved
            assert exc.value.code == 2
            assert msg in capsys.readouterr().err


def test_raid_zns_refuses_what_the_reference_refuses():
    for argv, exc, msg in (
            (["--devices", "1", "--parity"], ValueError,
             "parity needs >= 2 devices"),
            (["--devices", "2", "--chunk-pages", "7"], ValueError,
             "must divide"),
            (["--spec", "bogus"], SystemExit, None)):
        with pytest.raises(exc, match=msg):
            TRZ.main(argv + ["--device", "cpu"])


def test_fleet_search_obs_equals_golden_and_renders(golden, tmp_path):
    """``fleet_search --quick --obs`` through the port: its rows, front,
    trace and sidecar equal the reference's (golden file); the sidecar
    has the reference's keys and differs only in those whose values are
    each run's own: the compile profile and the ``jit_cache`` table,
    which on the port names the selection kernels and counts their
    launches.  The port's copy of ``tools/obs_report.py`` renders the
    sidecar as the reference's does."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import obs_report as ROBS
    finally:
        sys.path.remove(str(ROOT / "tools"))
    name = "fleet_search_grid_obs"
    driver, argv = CS.CLI_RUNS[name]
    with one_thread():
        run = CS.run_cli(CS.cli_modules()[driver],
                         argv + ["--device", "cpu"], driver, tmp_path)
    got = CS.cli_summary(name, argv, run)
    assert_same(name, got, golden[name])
    obs, want = (x["files"]["fleet_obs.json"] for x in (got, golden[name]))
    assert obs["_keys"] == want["_keys"]
    assert sorted(set(want["_keys"]) - set(want)) == sorted(CS.CLI_OBS_OWN)
    assert want["_jit_cache"] == ["apply_op", "run_program",
                                  "run_programs", "simulate_fleet_ops"]
    assert obs["_jit_cache"] == ["alloc_select", "grow_select", "rows"]
    sidecar = json.loads(run["files"]["fleet_obs.json"])
    # the CPU run launches no kernel (the card's phase 18 counts them)
    assert sidecar["jit_cache"] == {"alloc_select": 0, "grow_select": 0,
                                    "rows": 0}
    for lanes in (8, 2):
        assert TOBS.render(sidecar, max_lanes=lanes) == ROBS.render(
            sidecar, max_lanes=lanes)
    path, out = tmp_path / "fleet_obs.json", tmp_path / "report.md"
    assert TOBS.main([str(path), "--out", str(out)]) == 0
    assert out.read_text() == ROBS.render(sidecar) + "\n"


def test_drivers_import_neither_jax_nor_the_reference():
    drivers = ("fleet_search", "obs_report", "raid_zns", "quickstart",
               "zns_design_space", "raid_array", "fleet_example")
    for d in drivers:
        tree = ast.parse((TOOLS / f"{d}.py").read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "repro", "benchmarks",
                                               "examples"), (d, n)
    code = ("import sys\n"
            + "".join(f"import repro_torch.tools.{m}\n" for m in drivers)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'repro', 'benchmarks', 'examples')]\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                   cwd=str(ROOT), timeout=120)


if __name__ == "__main__":
    import tempfile
    GOLDEN.parent.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = clis_golden(tmp)
    GOLDEN.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
