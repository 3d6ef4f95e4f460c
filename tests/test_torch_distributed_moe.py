"""The port's expert-parallel MoE and placed Mamba paths on the CPU (gloo),
on a (data 2, model 2) mesh by the production rules, in f32:

* (a) the placed MoE layer on tokens split over ``data`` against the
  reference's ``moe_apply`` on ALL tokens -- routes, kept masks and
  positions EQUAL (read off the reference's own ``top_k`` / ``argsort``
  / ``bincount``, ``tests/test_torch_moe.reference_call``), the output at
  rel 1e-5 and the aux loss within 1e-6 -- for the reduced jamba,
  llama4-scout (a shared expert) and deepseek-v2 (int8 dispatch at
  capacity factor 0.5, dropping pairs of both ranks' tokens), and a
  skewed case in which rank 0's tokens alone fill expert 0, so that a
  capacity or positions taken per rank would keep rank 1's pairs, which
  the reference drops;
* (b) the placed train step of the reduced jamba and deepseek-v2 (int8,
  capacity factor 0.5) against the unplaced one, with every routing
  margin above ``MIN_MARGIN`` and the placed forward's routes, kept
  masks and positions equal: loss, nll and grad_norm at rel 1e-5, every
  gradient leaf, and every parameter and AdamW moment after one step at
  1e-4.  The step's AdamW takes eps 1e-3 (which moves neither the
  metrics nor the moments): at eps 1e-8 the first step moves an element
  whose gradient is near eps by up to ``lr * g / eps``, so the ~1e-6
  gradient differences of a sum in another order reach 1.3e-4 (jamba)
  and 4.8e-4 (deepseek) in dense layers' parameters -- the same finding
  as ``chip_smoke.py`` phase 16c's;
* (c) the reduced jamba's prefill and 3 decode steps on placed f32 caches
  (Mamba's conv and SSM state sharded over batch and channels) against
  the unplaced run, logits at rel 1e-5;
* (d) one placed MoE call's collectives: an all-to-all over ``data``, an
  all-reduce over ``model``, and no all-gather as large as an expert
  stack's shard;
* ``launch.serve.build(..., mesh=)``, which places each layer as it is
  drawn, against placing the whole build; and a reduced llama4-scout's
  train step with its FSDP'd leaves placed stacked over the repetitions
  (``sharding.StackedParams``), as the production meshes place
  llama4-scout's, against the unplaced step;
* the int8 fold on the device (``moe.fold_f32``) against the numpy left
  fold bit for bit;
* (e) the dry run's ``deepseek-v2-236b decode_32k`` cell on the 256-rank
  mesh (MLA, device-limited routing, the int8 fold on ``meta``, 10
  experts a rank) in a subprocess.

The ranks are spawned processes that import ``repro_torch`` alone
(``tests/_dist_moe_workers.py``); JAX runs here and hands them numpy
arrays.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_moe_workers as MW
from _train_common import configs, make_batch, reference_params
from repro.configs import get_arch as j_get_arch
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import moe as TMOE
from test_torch_moe import reference_call

REPO = Path(__file__).resolve().parents[1]
JAMBA = "jamba-1.5-large-398b"
DEEPSEEK = "deepseek-v2-236b"
LLAMA4 = "llama4-scout-17b-a16e"
MIN_MARGIN = 1e-5
TIMEOUT_S = 240
T_LAYER = 64


def _moe_params(rng, dims):
    e, d, f = dims.n_experts, dims.d_model, dims.d_ff
    p = {"router": 0.02 * rng.standard_normal((d, e)),
         "w_gate": rng.standard_normal((e, d, f)) / d ** 0.5,
         "w_up": rng.standard_normal((e, d, f)) / d ** 0.5,
         "w_down": rng.standard_normal((e, f, d)) / f ** 0.5}
    if dims.n_shared:
        fs = f * dims.n_shared
        p["shared"] = {"w_gate": rng.standard_normal((d, fs)) / d ** 0.5,
                       "w_up": rng.standard_normal((d, fs)) / d ** 0.5,
                       "w_down": rng.standard_normal((fs, d)) / fs ** 0.5}
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def _layer_case(name, dims, seed, skew=False):
    """(config, reference MoEDims, numpy params, tokens (T, d))."""
    rng = np.random.default_rng(seed)
    p = _moe_params(rng, dims)
    x = rng.standard_normal((T_LAYER, dims.d_model)).astype(np.float32)
    if skew:
        # rank 0's tokens (the first half) all pick expert 0 first
        u = np.full(dims.d_model, 0.125, np.float32)
        p["router"][:, 0] = u
        x[:T_LAYER // 2] += 3 * u
    return name, dims, p, x


def _dims(name, **over):
    return dataclasses.replace(JT._moe_dims(j_get_arch(name).reduced()),
                               **over)


LAYER_CASES = {
    "jamba": _layer_case(JAMBA, _dims(JAMBA), 40),
    "llama4": _layer_case(LLAMA4, _dims(LLAMA4), 41),
    "deepseek-int8-drops": _layer_case(
        DEEPSEEK, _dims(DEEPSEEK, capacity_factor=0.5), 42),
    "skewed": _layer_case(JAMBA, _dims(JAMBA, capacity_factor=1.0), 43,
                          skew=True),
}


@pytest.fixture(scope="module")
def reference():
    layer = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, (_, dims, p, x) in LAYER_CASES.items():
            out, aux, gate_idx, keep, pos = reference_call(
                mp, jax.tree.map(jnp.asarray, p), jnp.asarray(x), dims)
            layer[name] = {"out": out, "aux": aux, "gate_idx": gate_idx,
                           "keep": keep, "pos": pos,
                           "c": JMOE.capacity(T_LAYER, dims)}
    train = {}
    for name, arch, over, seed in (
            ("jamba", JAMBA, {}, 20),
            ("deepseek-int8-drops", DEEPSEEK, {"capacity_factor": 0.5}, 26)):
        jcfg, _ = configs(arch, **over)
        train[name] = (arch, over, jax.tree.map(
            np.asarray, reference_params(jcfg, seed, "f32")),
            make_batch(jcfg, seed + 1, "f32"))
    prompt = np.random.default_rng(1).integers(
        0, j_get_arch(JAMBA).reduced().vocab, (4, 8)).astype(np.int32)
    return {"layer": layer, "train": train, "prompt": prompt}


@pytest.fixture(scope="module")
def four(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distmoe")
    layer = {name: (cfg, dataclasses.asdict(dims), p, x)
             for name, (cfg, dims, p, x) in LAYER_CASES.items()}
    train = reference["train"]
    return run_ranks(MW.four_ranks, 4, layer, train,
                     train["jamba"][2], reference["prompt"],
                     work_dir=str(tmp), timeout_s=TIMEOUT_S)[0]


def rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_placed_moe_layer_matches_the_reference(reference, four, name):
    want, got = reference["layer"][name], four["layer"][name]
    assert np.array_equal(got["gate_idx"], want["gate_idx"])
    assert np.array_equal(got["keep"], want["keep"])
    assert np.array_equal(got["pos"], want["pos"])
    assert got["placements"][0] == "S(0)"     # the tokens' split kept
    assert rel(got["out"], want["out"]) <= 1e-5
    assert abs(got["aux"] - want["aux"]) <= 1e-6
    half = T_LAYER // 2
    dropped = ~want["keep"]
    if name == "deepseek-int8-drops":
        assert dropped[:half].any() and dropped[half:].any()
    elif name != "skewed":
        assert not dropped.any()


def test_skewed_case_drops_what_per_rank_capacity_would_keep(reference):
    """Rank 0's 32 tokens fill expert 0 (C = 32); rank 1's pairs for
    expert 0 are dropped, though a rank-local capacity (capacity(32) =
    16) and rank-local positions would keep its first 16."""
    want = reference["layer"]["skewed"]
    dims = LAYER_CASES["skewed"][1]
    half = T_LAYER // 2
    gate, keep, pos = want["gate_idx"], want["keep"], want["pos"]
    c = want["c"]
    assert ((gate[:half] == 0) & keep[:half]).sum() == c
    mine = gate[half:] == 0
    local_pos = np.cumsum(mine.reshape(-1)).reshape(mine.shape) - 1
    would_keep = mine & (local_pos < JMOE.capacity(half, dims))
    assert would_keep.any() and not keep[half:][would_keep].any()


@pytest.mark.parametrize("name", ["jamba", "deepseek-int8-drops"])
def test_placed_moe_train_step_matches_unplaced(four, name):
    got = four["train"][name]
    assert got["margin"] > MIN_MARGIN, got["margin"]
    assert got["routes_equal"]
    assert (got["drops"] > 0) == (name == "deepseek-int8-drops")
    loss0, loss = got["loss"]
    assert abs(loss - loss0) <= 1e-5 * abs(loss0), (loss, loss0)
    assert got["grads"] <= 1e-4, got["grads"]
    for k in ("loss", "nll", "grad_norm"):
        assert abs(got["metrics"][k] - got["ref_metrics"][k]) <= 1e-5 * abs(
            got["ref_metrics"][k]), (k, got["metrics"], got["ref_metrics"])
    assert got["moments"] <= 1e-4, got["moments"]
    assert got["params"] <= 1e-4, got["params"]


def test_stacked_fsdp_train_step_matches_unplaced(four):
    """FSDP over the repetition dim (llama4-scout's leaves on the
    production meshes) on a reduced llama4-scout: the layers read their
    repetition off a stacked leaf, and its gradient reaches the owner's
    row on every rank's same backward."""
    got = four["stacked"]
    assert got["stacked"]
    for k in ("loss", "nll", "grad_norm"):
        assert abs(got["metrics"][k] - got["ref_metrics"][k]) <= 1e-5 * abs(
            got["ref_metrics"][k]), (k, got["metrics"], got["ref_metrics"])
    assert got["params"] <= 1e-4, got["params"]


def test_placed_jamba_decode_matches_unplaced(four):
    got = four["decode"]
    assert got["placements"]["conv"] == ["S(1)", "S(3)"]
    assert got["placements"]["ssm"] == ["S(1)", "S(2)"]
    assert got["logits"] <= 1e-5, got["logits"]
    assert got["caches"] <= 1e-5, got["caches"]


def test_placed_build_equals_shard_model(four):
    """``serve.build(..., mesh=)`` places each layer as it is drawn (what
    serves a model larger than one card) and gives what placing the whole
    build gives."""
    got = four["build"]
    assert got["names"] and got["placed"] and got["equal"], got


def test_placed_moe_collectives(four):
    """Dispatch and combine are all-to-alls over data, the expert
    products' partial sums one all-reduce over model, and the only
    all-gathers are the (E,) counts: no expert stack is gathered."""
    got = four["layer"]["jamba"]
    ops = got["collectives"]
    assert ("all-to-all", "data") in {(c, a) for c, _, a in ops}
    assert ("all-reduce", "model") in {(c, a) for c, _, a in ops}
    gathers = [b for c, b, _ in ops if c == "all-gather"]
    assert all(b < got["stack_bytes"] for b in gathers), (
        gathers, got["stack_bytes"])
    assert sum(b for c, b, a in ops
               if c == "all-to-all" and a == "data") > 0


def test_row_parallel_sums_bf16_partials_in_f32(four):
    """``shards.row_parallel`` in bf16 rounds each output once, after the
    f32 partial sums are summed over ``model``: off one process's f32
    product by at most 2^-8 of the largest output, and on fewer outputs
    than bf16 partials rounded apiece and summed."""
    got = four["row_parallel"]
    for k in ("local", "placed"):
        share, worst = got[k]
        assert worst <= 2.0 ** -8, (k, got)
        assert share < got["bf16_partials"][0], (k, got)


@pytest.mark.parametrize("step", [
    TMOE._DROPPED_SCALE, float(np.float32(3 * 2.0 ** -30)),
    float(np.float32(1.5 * 2.0 ** -28)), 0.75])
def test_fold_f32_on_the_device_is_the_left_fold(step):
    """``moe.fold_f32`` (tensor ops, no host read: the placed int8 fold,
    and on ``meta``) equals ``moe._fold_f32``'s numpy left fold bit for
    bit: starts across 41 binades and at 0, counts up to 10^5, and steps
    whose ulp ratio is a tie in some binade."""
    rng = np.random.default_rng(7)
    firsts = [0.0, step] + [float(np.float32(rng.uniform(1, 2) * 2.0 ** e))
                            for e in range(-40, 1)]
    for n in (0, 1, 2, 3, 17, 1000, 24576, 100000):
        got = TMOE.fold_f32(torch.tensor(firsts, dtype=torch.float32), step,
                            torch.tensor(n), max(n, 1))
        want = [TMOE._fold_f32(f, step, n) for f in firsts]
        assert got.tolist() == want, (step, n)


def test_dryrun_deepseek_decode_cell(tmp_path):
    """deepseek-v2-236b decode_32k on the (16, 16) mesh: MLA, device-
    limited routing, int8 dispatch folded on ``meta`` and 10 experts a
    rank; the all-to-all bytes are recorded beside the analytic EP term."""
    arch, shape = DEEPSEEK, "decode_32k"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    res = json.loads((tmp_path / f"{arch}__{shape}__single.json")
                     .read_text())
    assert res["ok"] and res["devices"] == 256
    assert res["collective_counts"]["all-to-all"] > 0
    ep = res["ep_all_to_all"]
    assert ep["recorded_bytes"] == res["collectives"]["all-to-all"] > 0
    assert ep["analytic_bytes"] > 0
