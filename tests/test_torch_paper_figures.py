"""The paper's figures on the port (``src/repro_torch/tools/``), held to
the reference's ``benchmarks/`` scripts on the CPU, and the golden file
of ``chip_smoke.py``'s phase 17.

Phase 17 runs every function of ``tools/paper_figures.py`` at the
paper's sizes and ``tools/ckpt_zns.run_all`` on the card, and holds each
to ``tests/data/torch_figures_paper.json``.  The card has no JAX, so
``python tests/test_torch_paper_figures.py`` writes that file through the
reference's own ``benchmarks/paper_figures.py`` and
``benchmarks/ckpt_zns.py`` functions on the CPU (~4 min); Table 3's
unrounded factors and Table 4's sample counts are read off the
reference's own benchmark calls, by wrapping them for the call.

The tests below regenerate the sections whose reference is cheap and
compare them with the file, and hold the port's CPU route to the
reference at reduced sizes: 200k KVBench ops, one repeat and 40 churn
rounds in Fig. 7b / 7c, the geometry P8, S128 in Fig. 8 and Table 4, and
P4, S32 one element a case in Table 3 (the port's page-granular timing
steps its plain loop on the CPU, ~90 us a page: P8, S128 takes ~28 s an
element).  Fig. 4b, Fig. 9 and the full sweeps run through the port on
the card only.
"""

import ast
import contextlib
import io
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro.core as RC
from repro.configs import list_archs
from repro.core import metrics as R_METRICS
from repro.storage import KVBenchConfig as RKV
from repro.storage import LSMSimulator as RLSM
from repro.storage import ZoneFS as RZoneFS

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402
from benchmarks import ckpt_zns as RCK  # noqa: E402
from benchmarks import common as RCOMMON  # noqa: E402
from benchmarks import paper_figures as RPF  # noqa: E402
from benchmarks import run as RRUN  # noqa: E402

from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import metrics as T_METRICS  # noqa: E402
from repro_torch.core.device import ZNSDevice as TDevice  # noqa: E402
from repro_torch.core.geometry import ZoneGeometry  # noqa: E402
from repro_torch.storage import (KVBenchConfig, LSMSimulator,  # noqa: E402
                                 ZoneFS, replay_recorders)
from repro_torch.tools import ckpt_zns as TCK  # noqa: E402
from repro_torch.tools import paper_figures as TPF  # noqa: E402
from repro_torch.tools import paper_headline as THEAD  # noqa: E402
from repro_torch.tools import roofline_report as TROOF  # noqa: E402
from repro_torch.tools import run_figures as TRUN  # noqa: E402

GOLDEN = (pathlib.Path(__file__).with_name("data")
          / "torch_figures_paper.json")
#: the whole script's cut figures (``chip_smoke.FIGURE_CUTS``) through
#: the reference
CUT_GOLDEN = GOLDEN.with_name("torch_figures_cut.json")
TOOLS = ROOT / "src" / "repro_torch" / "tools"
#: the port's new drivers (the other ``tools/`` scripts are measurement
#: helpers of earlier slices)
DRIVERS = ("paper_figures", "ckpt_zns", "roofline_report", "run_figures",
           "paper_headline")
#: the sections a tier-1 run regenerates through the reference (1-12 s
#: each on the CPU); Fig. 8 (~75 s), Fig. 9, Table 3 (~60 s) and Table 4
#: (~60 s) are held to the file by the card's run, and Table 4's row at
#: P8, S128 below
CHEAP = ("fig4a_7a_dlwa_vs_occupancy", "fig4b_7d_interference",
         "fig7b_sa_dlwa_tradeoff", "fig7c_wear", "fig7c_wear_leveling",
         "ckpt_zns_all_archs")
P8_S128 = (8, 2)
P4_S32 = (4, 1)


@contextlib.contextmanager
def spied(module, name: str, sink: list, key: str):
    """Append ``out[key]`` of every call of ``module.name`` to ``sink``
    while open."""
    inner = getattr(module, name)

    def spy(*args, **kw):
        out = inner(*args, **kw)
        sink.append(out[key])
        return out
    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, inner)


@contextlib.contextmanager
def reference_grid(geometries=None, elements=None):
    """The reference's figures over ``geometries`` x ``elements`` (its
    module constants, swapped for the call)."""
    saved = RPF.PAPER_GEOMETRIES, RPF.ELEMENTS
    if geometries is not None:
        RPF.PAPER_GEOMETRIES = tuple(
            RC.ZoneGeometry(parallelism=p, n_segments=s)
            for p, s in geometries)
    if elements is not None:
        RPF.ELEMENTS = tuple(e for e in saved[1] if e.name in elements)
    try:
        yield
    finally:
        RPF.PAPER_GEOMETRIES, RPF.ELEMENTS = saved


def _cells(out: dict, fill) -> list:
    """One row a reference geometry, with ``fill`` (an iterator over the
    benchmark calls' values, in call order) in its applicable cells and
    None elsewhere."""
    flash = RC.custom16()
    return [dict({"geometry": row["geometry"]},
                 **{s.name: (next(fill) if RC.is_applicable(s, g, flash)
                             else None) for s in RPF.ELEMENTS})
            for g, row in zip(RPF.PAPER_GEOMETRIES, out["rows"])]


def reference_figure(name: str, **kw) -> dict:
    """Figure ``name`` through the reference, summarised as phase 17
    summarises the port's (``chip_smoke.figure_summary``)."""
    if name == "ckpt_zns_all_archs":
        return CS.figure_summary(name, RCK.run_all())
    fn = getattr(RPF, name)
    if name == "table3_interference":
        sink = []
        with spied(RPF.workloads, "interference_benchmark", sink,
                   "interference"):
            out = fn(**kw)
        rows = _cells(out, iter(sink))
        out["_rows"] = [{k: float("nan") if v is None else v
                         for k, v in r.items()} for r in rows]
        return CS.figure_summary(name, out)
    if name == "table4_alloc_latency":
        sink = []
        with spied(RPF.workloads, "alloc_latency_benchmark", sink,
                   "n_allocs"):
            out = fn(**kw)
        out["_n_allocs"] = _cells(out, iter(sink))
        return CS.figure_summary(name, out)
    return CS.figure_summary(name, fn(**kw))


def figures_golden() -> dict:
    """Every section of the golden file, through the reference at the
    paper's sizes."""
    return {name: reference_figure(name) for name in CS.FIGURES}


def figures_cut_golden() -> dict:
    """The figures ``chip_smoke.FIGURE_CUTS`` cuts by keyword, through
    the reference at those keywords, and the cuts themselves
    (``params``); a cut of geometries is held to :data:`GOLDEN`'s cells
    and needs no entry."""
    out = {"params": json.loads(json.dumps(CS.FIGURE_CUTS))}
    for name, kw in CS.FIGURE_CUTS.items():
        if "geometries" not in kw:
            out[name] = reference_figure(name, **kw)
    return out


def assert_same(name: str, got: dict, want: dict) -> None:
    bad = CS.figure_mismatches(name, got, want)
    assert bad == [], bad[:20]


def port(name: str, **kw) -> dict:
    """Figure ``name`` through the port on the CPU."""
    return CS.figure_functions("cpu")[name](**kw)


def geometries(*pairs):
    return tuple(ZoneGeometry(parallelism=p, n_segments=s)
                 for p, s in pairs)


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


# --------------------------------------------------------------------- #
# the golden file
# --------------------------------------------------------------------- #
def test_golden_file_holds_every_figure_at_the_papers_sizes(golden):
    assert sorted(golden) == sorted(CS.FIGURES)
    fig7b = golden["fig7b_sa_dlwa_tradeoff"]
    assert [r["threshold"] for r in fig7b["rows"]] == [0.1, 0.3, 0.5, 0.7,
                                                         0.9]
    assert fig7b["dlwa_reduction_at_low_thr"] == pytest.approx(0.85354,
                                                               abs=1e-5)
    assert len(golden["fig8_geometry_sweep"]["rows"]) == 29 * 5
    t3 = golden["table3_interference"]
    for row, raw in zip(t3["rows"], t3["unrounded"]):
        for k, v in row.items():
            if k != "geometry" and not math.isnan(v):
                assert v == round(raw[k], 2)
    t4 = golden["table4_alloc_latency"]
    assert t4["keys"] == ["block_us", "fixed_us", "rows", "superblock_us"]
    cells = [v for r in t4["n_allocs"] for k, v in r.items()
             if k != "geometry" and v is not None]
    assert len(cells) == 29 and set(cells) == {16.0}
    assert [r["arch"] for r in golden["ckpt_zns_all_archs"]["rows"]] == list(
        list_archs())


@pytest.mark.parametrize("name", CHEAP)
def test_golden_section_is_current(golden, name):
    """Regenerating a section through the reference on the CPU gives the
    committed file's (interference factors at rel 1e-5, wear spreads at
    rel 1e-12, everything else exactly)."""
    assert_same(name, reference_figure(name), golden[name])


def test_golden_table4_row_is_current(golden):
    """Table 4's P8, S128 row through the reference: its keys, sample
    counts and N/A cells are the file's (its times are the CPU's)."""
    with reference_grid([P8_S128]):
        got = reference_figure("table4_alloc_latency")
    want = golden["table4_alloc_latency"]
    assert got["keys"] == want["keys"]
    assert got["n_allocs"] == [r for r in want["n_allocs"]
                               if r["geometry"] == "P8, S128"]


# --------------------------------------------------------------------- #
# the port against the reference
# --------------------------------------------------------------------- #
def test_fig4a_port_equals_golden(golden):
    out = port("fig4a_7a_dlwa_vs_occupancy")
    assert (out["_dispatches"], out["_op_steps"], out["_lane_ops"]) == (
        2, 16, 80)
    assert_same("fig4a_7a_dlwa_vs_occupancy",
                CS.figure_summary("fig4a_7a_dlwa_vs_occupancy", out),
                golden["fig4a_7a_dlwa_vs_occupancy"])


def test_ckpt_port_equals_golden(golden):
    """Every arch's checkpoint epochs, recorded and replayed one lane an
    arch, at full size on the CPU."""
    out = port("ckpt_zns_all_archs")
    assert out["_dispatches"] == 2
    assert_same("ckpt_zns_all_archs",
                CS.figure_summary("ckpt_zns_all_archs", out),
                golden["ckpt_zns_all_archs"])


def test_ckpt_one_arch_equals_reference():
    got = TCK.checkpoint_traffic("granite-3-8b", device="cpu")
    want = RCK.checkpoint_traffic("granite-3-8b")
    assert {k: v for k, v in got.items() if not k.startswith("_")} == want


def test_fig7b_port_equals_reference_at_200k_ops():
    got = port("fig7b_sa_dlwa_tradeoff", n_ops=200_000)
    assert got["_dispatches"] == 2
    assert_same("fig7b_sa_dlwa_tradeoff",
                CS.figure_summary("fig7b_sa_dlwa_tradeoff", got),
                reference_figure("fig7b_sa_dlwa_tradeoff", n_ops=200_000))


def test_fig7c_wear_port_equals_reference_at_200k_ops_one_repeat():
    got = port("fig7c_wear", n_ops=200_000, repeats=1)
    assert_same("fig7c_wear", CS.figure_summary("fig7c_wear", got),
                reference_figure("fig7c_wear", n_ops=200_000, repeats=1))


def test_lane_wear_report_equals_the_shims():
    """The lane-level wear report read off a replay's final state equals
    ``wear_report`` of the port's shim and of the reference's shim after
    the same traffic, key for key."""
    got = port("fig7c_wear", n_ops=200_000, repeats=1)["_wear"]
    flash, zone = RC.zn540()
    for name, spec, tspec, aware in (
            ("baseline", RC.FIXED, TPF.FIXED, False),
            ("silentzns", RC.SUPERBLOCK, TPF.SUPERBLOCK, True)):
        ref = RC.ZNSDevice(flash, zone, spec, max_active=14,
                           wear_aware=aware)
        shim = TDevice(*TPF.zn540(), tspec, max_active=14,
                       wear_aware=aware, device="cpu")
        for dev, kv, lsm, fs in ((ref, RKV, RLSM, RZoneFS),
                                 (shim, KVBenchConfig, LSMSimulator,
                                  ZoneFS)):
            lsm(fs(dev, finish_threshold=0.1), kv(
                n_ops=200_000, seed=0, max_concurrent_jobs=6)).run()
        assert got[name] == R_METRICS.wear_report(ref)
        assert got[name] == T_METRICS.wear_report(shim)


def test_fig7c_wear_leveling_port_equals_reference_at_40_rounds():
    got = port("fig7c_wear_leveling", rounds=40)
    assert (got["_dispatches"], got["_op_steps"]) == (1, 192)
    assert_same("fig7c_wear_leveling",
                CS.figure_summary("fig7c_wear_leveling", got),
                reference_figure("fig7c_wear_leveling", rounds=40))


def test_per_lane_wear_aware_equals_two_dispatches():
    """Two lanes of one dispatch, ``wear_aware`` off and on through
    ``stack_dyn``, equal two engines built with it off and on, each
    replaying its lane alone: every state field bit for bit."""
    flash, zone = TPF.zn540()
    eng = TPF.workloads.make_engine(flash, zone, TPF.SUPERBLOCK,
                                    max_active=14, device="cpu")
    rec = TPF.recorder(eng)
    for i in range(40):
        z = i % 8
        rec.zone_write(z, max(1, rec.zone_pages // 3))
        rec.zone_finish(z)
        rec.zone_reset(z)
    both = replay_recorders(eng, [rec, rec], dyns=[
        eng.dyn(wear_aware=False), eng.dyn(wear_aware=True)])
    for lane, aware in enumerate((False, True)):
        alone = TPF.workloads.make_engine(flash, zone, TPF.SUPERBLOCK,
                                          max_active=14, wear_aware=aware,
                                          device="cpu")
        one = replay_recorders(alone, [rec])
        for name, a, b in zip(TE.DeviceState._fields, both.states,
                              one.states):
            assert torch.equal(a[lane], b[0]), (aware, name)
    w = [eng.block_wear(TPF.lane_state(both, k)) for k in (0, 1)]
    assert w[0].std() > w[1].std()      # the leveling shows at 40 rounds


def test_fig8_port_equals_reference_at_p8_s128():
    got = port("fig8_geometry_sweep", geometries=geometries(P8_S128))
    with reference_grid([P8_S128]):
        want = reference_figure("fig8_geometry_sweep")
    assert got["_dispatches"] == len(got["rows"]) // 5
    assert_same("fig8_geometry_sweep",
                CS.figure_summary("fig8_geometry_sweep", got), want)
    assert got["fixed_over_vchunk2_P8S128"] == want[
        "fixed_over_vchunk2_P8S128"]


@pytest.mark.parametrize("element", ("fixed", "block", "vchunk2",
                                     "vchunk4"))
def test_table3_port_equals_reference_at_p4_s32(element):
    got = port("table3_interference", geometries=geometries(P4_S32),
               elements=tuple(e for e in TPF.ELEMENTS
                              if e.name == element))
    assert got["_dispatches"] == 1 and got["_page_clock"] == 0
    with reference_grid([P4_S32], [element]):
        want = reference_figure("table3_interference")
    assert_same("table3_interference",
                CS.figure_summary("table3_interference", got), want)


def test_table4_port_structure_equals_reference_at_p8_s128(golden):
    got = CS.figure_summary("table4_alloc_latency", port(
        "table4_alloc_latency", geometries=geometries(P8_S128)))
    want = golden["table4_alloc_latency"]
    assert got["keys"] == want["keys"]
    assert got["n_allocs"] == [r for r in want["n_allocs"]
                               if r["geometry"] == "P8, S128"]


def test_table3_rounding_flip_is_one_step():
    """A factor whose last bit moves it across a rounding boundary may
    differ by one step; any other difference is a mismatch."""
    want = {"rows": [{"geometry": "g", "fixed": 1.0, "vchunk2": 2.0}],
            "unrounded": [{"geometry": "g", "fixed": 1.005,
                           "vchunk2": 2.0}],
            "fixed_minus_vchunk2_multiseg": -1.0}
    flip = json.loads(json.dumps(want))
    flip["unrounded"][0]["fixed"] = 1.0050000001
    flip["rows"][0]["fixed"] = round(1.0050000001, 2)
    flip["fixed_minus_vchunk2_multiseg"] = flip["rows"][0]["fixed"] - 2.0
    assert CS.figure_mismatches("table3_interference", flip, want) == []
    bad = json.loads(json.dumps(want))
    bad["rows"][0]["vchunk2"] = 2.01
    assert CS.figure_mismatches("table3_interference", bad, want)


# --------------------------------------------------------------------- #
# the drivers
# --------------------------------------------------------------------- #
def parse_rows(text: str) -> list:
    """(name, derived keys) of each ``name,us,derived`` row."""
    out = []
    for line in text.strip().splitlines():
        name, _, derived = line.split(",", 2)
        out.append((name, [kv.split("=", 1)[0]
                           for kv in derived.split(";") if kv]))
    return out


def test_run_figures_prints_the_references_rows(golden, monkeypatch,
                                                tmp_path):
    """``run_figures --device cpu`` prints the reference's row names and
    derived keys in its order.  The slow figures are stubbed with the
    golden file's outputs (Table 4 and the engine comparator with their
    keys); Fig. 4a runs."""
    monkeypatch.setattr(
        RCOMMON.Bench, "timeit",
        lambda self, name, fn, keys=(): self.rows.append(
            (name, 0.0, ";".join(f"{k}=0" for k in keys))))
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        RRUN.main()
    want = parse_rows(buf.getvalue())
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    for name in CS.FIGURES[1:-1]:
        monkeypatch.setattr(TPF, name,
                            lambda *a, _s=golden[name], **k: dict(_s))
    t4 = golden["table4_alloc_latency"]["keys"]
    monkeypatch.setattr(TPF, "table4_alloc_latency",
                        lambda **k: {key: 1.0 for key in t4})
    monkeypatch.setattr(TCK, "run_all", lambda **k: dict(
        golden["ckpt_zns_all_archs"]))
    keys = dict(want)["engine_batched_drivers"]
    monkeypatch.setattr(TRUN, "engine_batched_drivers",
                        lambda **k: {key: 1.0 for key in keys})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TRUN.main(["--device", "cpu"])
    got = parse_rows(buf.getvalue())
    assert got == want
    fig4a = buf.getvalue().splitlines()[0]
    assert fig4a.endswith("reduction_at_10pct=0.8636;paper_claim=0.8636")


def test_paper_headline_cli_prints_the_references_report(tmp_path):
    """``paper_headline --quick --device cpu`` prints the reference CLI's
    lines (the reference's recompile line aside) and writes its report's
    figures."""
    from benchmarks import paper_headline as RHEAD

    outs = {}
    for name, main, argv in (
            ("ref", RHEAD.main, []),
            ("port", THEAD.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.json"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["--quick", "--out", str(path)] + argv) == 0
        outs[name] = (buf.getvalue().splitlines(),
                      json.loads(path.read_text()))
    (ref_lines, ref_rep), (lines, rep) = outs["ref"], outs["port"]
    assert lines[:-2] == ref_lines[:-2]
    assert lines[-2] == "zns_alloc launches a pass: [0.0, 0.0]"
    for fig in ("dlwa", "wear"):
        assert rep[fig] == ref_rep[fig]
    assert rep["exec"]["traditional_s"] == pytest.approx(
        ref_rep["exec"]["traditional_s"], rel=1e-6)


def test_roofline_report_reads_the_dry_runs_json(tmp_path):
    from repro_torch.analysis.roofline import Roofline

    rl = Roofline(flops=4e15, hbm_bytes=2e12, coll_bytes=1e11,
                  model_flops=3e15).report()
    cells = [
        {"arch": "granite-3-8b", "shape": "decode_32k", "mesh": "single",
         "ok": True, "memory": {"argument_bytes": 3.5e9}, "step_s": 4.0,
         "roofline": dict(rl, residency_gb=12.5)},
        {"arch": "xlstm-125m", "shape": "train_4k", "mesh": "multi",
         "ok": True, "memory": {"argument_bytes": 1e8}, "step_s": 1.0,
         "roofline": dict(rl, residency_gb=0.5)},
        {"arch": "jamba-1.5-large-398b", "shape": "prefill_32k",
         "mesh": "single", "ok": False, "error": "TimeoutError: cell"},
    ]
    for i, cell in enumerate(cells):
        (tmp_path / f"{i}.json").write_text(json.dumps(cell))
    rows = TROOF.table(str(tmp_path))
    assert [(r["arch"], r["ok"]) for r in rows] == [
        ("granite-3-8b", True), ("jamba-1.5-large-398b", False)]
    assert rows[0]["argument_gb"] == 3.5
    assert rows[0]["roofline_fraction"] == rl["roofline_fraction"]
    md = TROOF.markdown(str(tmp_path)).splitlines()
    assert len(md) == 4 and "FAIL: TimeoutError: cell" in md[3]
    assert TROOF.summary(str(tmp_path)) == {
        "cells_single_ok": 1, "cells_multi_ok": 1, "fails": 1,
        "worst_roofline": "granite-3-8b",
        "mean_roofline_fraction": rl["roofline_fraction"]}
    assert TROOF.summary(str(tmp_path / "absent"))["cells_single_ok"] == 0


def test_drivers_import_neither_jax_nor_the_reference():
    """No ``tools/`` module names ``jax``, ``repro`` or ``benchmarks`` in an
    import, and importing the drivers loads none of them."""
    for path in sorted(TOOLS.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "repro",
                                               "benchmarks"), (path, n)
    code = ("import sys\n"
            + "".join(f"import repro_torch.tools.{m}\n" for m in DRIVERS)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'repro', 'benchmarks')]\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                   cwd=str(ROOT), timeout=120)


# --------------------------------------------------------------------- #
# the whole script's cuts of phase 17
# --------------------------------------------------------------------- #
def test_cut_golden_file_is_current():
    """The cut figures' file holds this script's cuts, and regenerating
    it through the reference on the CPU gives the committed file."""
    want = json.loads(CUT_GOLDEN.read_text())
    assert want["params"] == json.loads(json.dumps(CS.FIGURE_CUTS))
    got = figures_cut_golden()
    assert sorted(got) == sorted(want)
    for name in CS.FIGURE_CUTS:
        if name in want:
            assert_same(name, got[name], want[name])


@pytest.mark.parametrize("name", sorted(CS.FIGURE_CUTS))
def test_whole_script_cut_port_equals_golden(golden, name):
    """Each figure as phase 17 cuts it in the whole script
    (``chip_smoke.cut_figure``), through the port on the CPU, equals the
    summary the card's run is held to."""
    fn, want = CS.cut_figure(name, CS.figure_functions("cpu")[name],
                             golden[name], CS.FIGURE_CUTS,
                             json.loads(CUT_GOLDEN.read_text()))
    got = fn()
    assert_same(name, CS.figure_summary(name, got), want)
    if name == "table4_alloc_latency":
        assert [r["geometry"] for r in want["n_allocs"]] == [
            "P16, S256", "P4, S32"]


if __name__ == "__main__":
    GOLDEN.parent.mkdir(exist_ok=True)
    GOLDEN.write_text(json.dumps(figures_golden(), indent=1,
                                 sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
    CUT_GOLDEN.write_text(json.dumps(figures_cut_golden(), indent=1,
                                     sort_keys=True) + "\n")
    print(f"wrote {CUT_GOLDEN}", file=sys.stderr)
