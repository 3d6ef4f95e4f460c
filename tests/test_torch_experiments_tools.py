"""The port's readers of its dry-run JSONs: ``tools/recompute_roofline``
and ``tools/write_experiments`` (the counterparts of the reference's
``tools/recompute_roofline.py`` and ``tools/write_experiments.py``).

Two JSONs are written by the port's dry run itself (a subprocess each:
the fake process group is the process's default group): xlstm-125m's
decode_32k on (16, 16) and its long_500k on (2, 16, 16).
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.tools import recompute_roofline as RR
from repro_torch.tools import roofline_report as R
from repro_torch.tools import write_experiments as WE

REPO = Path(__file__).resolve().parent.parent
CELLS = (("xlstm-125m", "decode_32k", "single"),
         ("xlstm-125m", "long_500k", "multi"))


@pytest.fixture(scope="module")
def dryrun_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    for arch, shape, mesh in CELLS:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", str(out)],
            capture_output=True, text=True, timeout=600, cwd=str(REPO),
            env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
        assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    return out


def _copy(src: Path, dst: Path) -> Path:
    shutil.copytree(src, dst)
    return dst


def _load(d: Path) -> dict:
    return {p.name: json.loads(p.read_text())
            for p in sorted(d.glob("*.json"))}


def test_recompute_gives_back_the_dry_runs_terms(dryrun_dir, tmp_path,
                                                 capsys):
    want = _load(dryrun_dir)
    d = _copy(dryrun_dir, tmp_path / "d")
    RR.main(["--dir", str(d)])
    assert _load(d) == want
    assert "recomputed 2 of 2" in capsys.readouterr().out


def test_recompute_restores_blanked_terms_and_skips_failures(
        dryrun_dir, tmp_path, capsys):
    want = _load(dryrun_dir)
    d = _copy(dryrun_dir, tmp_path / "d")
    for p in d.glob("*.json"):
        j = json.loads(p.read_text())
        j["roofline"], j["analytic_detail"] = {}, {}
        del j["analytic"]
        p.write_text(json.dumps(j))
    failed = {"arch": "granite-3-8b", "shape": "train_4k", "mesh": "single",
              "ok": False, "error": "RuntimeError: boom"}
    (d / "granite-3-8b__train_4k__single.json").write_text(
        json.dumps(failed))
    RR.main(["--dir", str(d)])
    got = _load(d)
    assert got.pop("granite-3-8b__train_4k__single.json") == failed
    assert got == want
    printed = capsys.readouterr().out
    assert "recomputed 2 of 3" in printed and "skipped 1 not ok" in printed


def test_recompute_keeps_the_recorded_collectives_as_a_floor(dryrun_dir,
                                                             tmp_path):
    d = _copy(dryrun_dir, tmp_path / "d")
    p = d / "xlstm-125m__decode_32k__single.json"
    j = json.loads(p.read_text())
    j["collectives"]["total"] = 1e15
    p.write_text(json.dumps(j))
    RR.main(["--dir", str(d)])
    j = json.loads(p.read_text())
    assert j["roofline"]["coll_bytes_per_dev"] == 1e15
    assert j["roofline"]["bottleneck"] == "collective"


#: the reference page's TPU figures (197 TF/s bf16, 819 GB/s HBM, 50 GB/s
#: ICI), none of which the port's page may state
TPU = re.compile(r"TPU|\b197\b|\b819\b|(?<![0-9])50 GB/s|ICI")


def test_page_holds_the_reports_counts_and_tables(dryrun_dir, tmp_path):
    out = tmp_path / "exp.md"
    WE.main(["--dir", str(dryrun_dir), "--out", str(out)])
    page = out.read_text()
    s = R.summary(str(dryrun_dir))
    assert s["cells_single_ok"] == s["cells_multi_ok"] == 1
    assert f"**{s['cells_single_ok']}/1 cells ok**" in page
    assert f"**{s['cells_multi_ok']}/1 cells ok**" in page
    assert f"failures: {s['fails']}" in page
    for mesh in ("single", "multi"):
        assert R.markdown(str(dryrun_dir), mesh) in page
    assert not TPU.search(page), TPU.search(page)
    assert "989 TFLOP/s" in page and "3.35 TB/s" in page
    assert "Left out: no figures CSV" in page
    assert "| paper claim |" not in page


def test_page_takes_the_figures_csv_and_the_perf_log(dryrun_dir, tmp_path):
    d = _copy(dryrun_dir, tmp_path / "results" / "dryrun")
    (tmp_path / "results" / "perf_log.md").write_text("## perf log\n\nx\n")
    csv = tmp_path / "figures.csv"
    csv.write_text(
        "fig4a_7a_dlwa_vs_occupancy,1234.5,reduction_at_10pct=0.8642;"
        "paper_claim=0.8636\n"
        "fig9_throughput,99.0,peak_P16_1job=119.2;P8_1job=59.6;"
        "P8_2jobs=119.2\n"
        "roofline_dryrun_summary,0.0,cells_single_ok=1;fails=0\n")
    out = tmp_path / "exp.md"
    WE.main(["--dir", str(d), "--figures", str(csv), "--out", str(out)])
    page = out.read_text()
    assert ("| DLWA −86.36% @10% occupancy (superblock, ZN540) | "
            "reduction_at_10pct=0.8642 | fig4a_7a_dlwa_vs_occupancy |"
            in page)
    assert "peak_P16_1job=119.2, P8_1job=59.6, P8_2jobs=119.2" in page
    assert ("| Table 4: alloc latency fixed ≪ superblock < vchunk < block "
            "| not in the CSV | table4_alloc_latency |" in page)
    assert "Left out" not in page
    assert page.endswith("## perf log\n\nx\n")
    assert not TPU.search(page)
