"""The port's paper headline vs the JAX reference and its artifact.

At tiny geometry the port's ``paper_report`` must equal the JAX
``paper_report`` (DLWA and erase fields exactly, execution seconds at
rel 1e-6: both time the same traces in f32, and XLA may contract a
multiply-add the port rounds twice).  At the paper's own device (zn540)
it must reproduce the reference's committed ``BENCH_paper.json``.
"""

import json
import pathlib

import pytest

from repro.core import headline as j_headline
from repro.core.geometry import FlashGeometry, ZoneGeometry
from repro_torch.core import geometry as t_geometry
from repro_torch.core import headline as t_headline

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(occupancies=(0.1, 0.5), dlwa_zones=2, wear_zones=2,
            wear_cycles=2, exec_cycles=1, max_active=3)


def assert_report_matches(got, want):
    assert got["dlwa"] == want["dlwa"]
    assert got["wear"] == want["wear"]
    for key, value in want["exec"].items():
        if key in ("traditional_s", "silent_s", "speedup"):
            assert got["exec"][key] == pytest.approx(value, rel=1e-6), key
        else:
            assert got["exec"][key] == value, key


def test_tiny_report_matches_jax():
    want = j_headline.paper_report(
        FlashGeometry(4, 1, 8, 4, 4096), ZoneGeometry(4, 2), **TINY)
    got = t_headline.paper_report(
        t_geometry.FlashGeometry(4, 1, 8, 4, 4096),
        t_geometry.ZoneGeometry(4, 2), device="cpu", **TINY)
    assert_report_matches(got, want)
    assert got["launches"] == {"zns_alloc_per_pass": [0.0, 0.0]}
    assert got["wear"]["traditional_erases"] > got["wear"]["silent_erases"]


def test_zn540_report_reproduces_bench_paper(capsys):
    """The CLI at the paper's device on the CPU: DLWA 10.0006 -> 1.3637
    (reduction 0.8636...), erases 2816 -> 896, exec 392.01 s -> 124.75 s."""
    assert t_headline.main(["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    want = json.loads((ROOT / "BENCH_paper.json").read_text())
    assert_report_matches(got, want)
    assert got["dlwa"]["reduction_at_10pct"] == 0.8636363636363636
    assert (got["wear"]["traditional_erases"],
            got["wear"]["silent_erases"]) == (2816.0, 896.0)


def test_headline_engine_matches_reference_config():
    jeng = j_headline.build_headline_engine()
    teng = t_headline.build_headline_engine(device="cpu")
    assert teng.cfg.n_groups == jeng.cfg.n_groups == 4
    assert teng.cfg.per_group == jeng.cfg.per_group == 1056
    assert teng.cfg.n_slots == jeng.cfg.n_slots == 88
    assert teng.cfg.take == jeng.cfg.take
    flash, zone = t_geometry.zn540()
    with pytest.raises(ValueError, match="together"):
        t_headline.build_headline_engine(flash, None, device="cpu")
    with pytest.raises(ValueError, match="together"):
        t_headline.build_headline_engine(None, zone, device="cpu")
