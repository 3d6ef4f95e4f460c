"""The port's analysis layer and dry run against the reference's.

``analysis.flops`` is the reference's arithmetic over the port's configs
and parameter counts: ``cell_cost`` equals ``repro.analysis.flops`` at rel
1e-12 on all 32 applicable cells on both production meshes, with
``pick_n_micro`` and ``fit_batch_axes`` equal too.  ``analysis.roofline``
keeps the reference's fields and report keys with the H100's constants.
``analysis.collectives`` reads a record of the collectives a step called under the
reference's category names.  The dry-run CLI runs as a subprocess (it
starts a fake process group of 512 or 256 ranks, which sets the
process's default group), on the reference test's cell and on one whose
caches are sequence-sharded."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from jax.sharding import AbstractMesh

from repro.analysis import flops as JF
from repro.analysis import roofline as JR
from repro.configs import applicable_cells, get_arch as j_get_arch
from repro.configs import get_shape as j_get_shape
from repro.launch import sharding as JS
from repro_torch.analysis import collectives as CO
from repro_torch.analysis import flops as FL
from repro_torch.analysis import roofline as RL
from repro_torch.configs import get_arch, get_shape
from repro_torch.launch import dryrun as DR
from repro_torch.launch import sharding as SH

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JD  # noqa: E402  (sets XLA_FLAGS)
if _flags is None:          # the reference's module sets 512 host devices
    os.environ.pop("XLA_FLAGS", None)     # at import: undo it for this
else:                                     # process's JAX
    os.environ["XLA_FLAGS"] = _flags

REPO = Path(__file__).resolve().parent.parent
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b))


def cost_args(cfg, shape: dict, axes: tuple, n_micro: int, fsdp: bool):
    """The dry run's ``cell_cost`` arguments for batch axes ``axes``."""
    dp = 1
    for ax in axes:
        dp *= shape[ax]
    return dict(dp=max(1, dp), tp=1 if cfg.family == "ssm"
                else shape["model"], n_micro=n_micro, fsdp=fsdp,
                append_impl="scatter", param_dp=shape["data"])


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", applicable_cells())
def test_cell_cost_matches_reference(arch, shape, mesh_kind):
    sizes, names = MESHES[mesh_kind]
    am, m = AbstractMesh(sizes, names), dict(zip(names, sizes))
    jcfg, cfg = j_get_arch(arch), get_arch(arch)
    jcell, cell = j_get_shape(shape), get_shape(shape)
    b = cell.global_batch
    for incl in (False, True):
        assert SH.fit_batch_axes(m, b, incl) == JS.fit_batch_axes(am, b, incl)
    n_micro = DR.pick_n_micro(cfg, cell, m)
    assert n_micro == JD.pick_n_micro(jcfg, jcell, am)
    assert SH._needs_fsdp(cfg) == JS._needs_fsdp(jcfg)
    n_dev = 512 if mesh_kind == "multi" else 256
    incl = JS.batch_includes_model(jcfg)
    want = JF.cell_cost(jcfg, jcell, n_dev, **cost_args(
        jcfg, dict(am.shape), JS.fit_batch_axes(am, b, incl), n_micro,
        JS._needs_fsdp(jcfg)))
    got = FL.cell_cost(cfg, cell, n_dev, **cost_args(
        cfg, m, SH.fit_batch_axes(m, b, SH.batch_includes_model(cfg)),
        n_micro, SH._needs_fsdp(cfg)))
    for field in ("flops", "hbm_bytes", "coll_bytes", "model_flops"):
        assert close(getattr(got, field), getattr(want, field)), field
    assert got.detail.keys() == want.detail.keys()
    for k, v in want.detail.items():
        assert close(got.detail[k], v), k
    assert FL.expert_param_count(cfg) == JF.expert_param_count(jcfg)


def test_roofline_on_h100_constants():
    args = dict(flops=3e15, hbm_bytes=2e12, coll_bytes=5e10,
                model_flops=2e15)
    ours, ref = RL.Roofline(**args), JR.Roofline(**args)
    assert ours.report().keys() == ref.report().keys()
    assert (RL.PEAK_FLOPS_BF16, RL.HBM_BW, RL.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert ours.t_compute == 3e15 / 989e12
    assert ours.t_memory == 2e12 / 3.35e12
    assert ours.t_collective == 5e10 / 450e9
    assert ours.bottleneck == "compute"
    assert ours.useful_fraction == ref.useful_fraction
    assert RL.model_flops_train(7, 11) == JR.model_flops_train(7, 11)
    assert RL.model_flops_forward(7, 11) == JR.model_flops_forward(7, 11)


def test_collective_record_categories():
    rec = CO.CollectiveRecord()
    rec.ops = [("all-reduce", 8), ("all-gather", 64), ("all-reduce", 4)]
    assert CO.collective_bytes(rec) == {"all-reduce": 12,
                                        "all-gather": 64, "total": 76}
    assert CO.collective_count(rec) == {"all-reduce": 2, "all-gather": 1}
    assert set(CO.COLLECTIVE_OPS) == {"all-gather", "all-reduce",
                                      "reduce-scatter", "all-to-all",
                                      "collective-permute"}


def run_dryrun(tmp_path, arch, shape, mesh):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    return json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json")
                      .read_text())


def test_dryrun_cell_on_512_ranks(tmp_path):
    """The reference test's cell (``tests/test_distributed.py``):
    xlstm-125m decode_32k on the (2, 16, 16) mesh; its analytic terms are
    the reference's ``cell_cost``."""
    res = run_dryrun(tmp_path, "xlstm-125m", "decode_32k", "multi")
    assert res["ok"]
    assert res["devices"] == 512
    assert res["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    rl = res["roofline"]
    assert rl["t_memory_s"] > 0
    jcfg, cell = j_get_arch("xlstm-125m"), j_get_shape("decode_32k")
    am = AbstractMesh(*MESHES["multi"])
    want = JF.cell_cost(jcfg, cell, 512, **cost_args(
        jcfg, dict(am.shape), JS.fit_batch_axes(am, cell.global_batch, True),
        1, JS._needs_fsdp(jcfg)))
    assert close(rl["flops_per_dev"], want.flops)
    assert close(rl["hbm_bytes_per_dev"], want.hbm_bytes)
    assert close(res["analytic"]["coll_bytes"], want.coll_bytes)
    assert rl["residency_gb"] == round(
        want.detail["residency_bytes"] / 1e9, 2)
    assert rl["t_memory_s"] == want.hbm_bytes / 3.35e12
    assert res["memory"]["argument_bytes"] > 0
    assert res["collective_scale"] == rl["n_micro"] == 1


def test_dryrun_counts_collectives_of_sequence_sharded_decode(tmp_path):
    """granite-3-8b's 8 KV heads do not divide |model| 16, so its caches
    are sequence-sharded: the step gathers the heads it shards and runs
    a distributed softmax."""
    res = run_dryrun(tmp_path, "granite-3-8b", "decode_32k", "single")
    assert res["ok"] and res["devices"] == 256
    assert res["attn_impl"] == "dense"
    assert sum(res["collective_counts"].values()) >= 1
    assert res["collectives"]["total"] > 0
