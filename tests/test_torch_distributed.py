"""The port's distributed paths on the CPU (gloo): the sharded train step
and the sharded-cache decode of a reduced granite-3-8b on a (data 2,
model 2) mesh by the production rules, the GPipe pipeline, the
pod-hierarchical all-reduce, a (2, 2, 2) mesh and the elastic restore
of a checkpoint.

The reference's own sharded tests (``tests/test_distributed.py``) fail on
this JAX release, so the port is held to the single-device reference:
the sharded loss to the port's unsharded loss at rel 1e-5 in f32 (the
same sums in another order) and to the reference's compiled
``loss_fn`` at ``_train_common``'s f32 bar, every gradient leaf at 1e-4,
the decode logits at 1e-5 of the unsharded run's and at the reference
test's rel 3e-2 of the reference's, with the caches heads-sharded on
(2, 2) (bf16, within one rounding of the unsharded run's) and
sequence-sharded on (1, 4) with 2 KV heads (f32, at 1e-5), the pipeline
at its 1e-5 and the hierarchical all-reduce at its rtol 1e-6.

The ranks are spawned processes (``launch.mesh.run_ranks``) that import
``repro_torch`` alone (``tests/_dist_workers.py``); JAX runs here, in the
parent, and hands them numpy arrays.  One 4-rank group runs every (2, 2)
check and one 8-rank group the (2, 2, 2) ones: starting a group costs
more than its checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _dist_workers as W
from _train_common import (F32_TOL, configs, make_batch, reference_params,
                           reference_run, rel_err)
from repro.models import transformer as JT
from repro_torch.launch.mesh import run_ranks

ARCH = "granite-3-8b"
NARROW_KV = 2       # KV heads that |model| 4 does not divide
TIMEOUT_S = 240
ONE_BF16_ROUNDING = 2.0 ** -7


@pytest.fixture(scope="module")
def reference():
    jcfg, _ = configs(ARCH)
    params = reference_params(jcfg, 0, "f32")
    tree = jax.tree.map(np.asarray, params)
    batch = make_batch(jcfg, 0, "f32")
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab, (4, 8)).astype(np.int32)
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((4, 8, 8)) * 0.3).astype(np.float32)
    x = rng.standard_normal((8, 16, 8)).astype(np.float32)
    narrow_jcfg, _ = configs(ARCH, n_kv_heads=NARROW_KV)
    narrow = reference_params(narrow_jcfg, 0, "f32")
    return {"jcfg": jcfg, "params": params, "tree": tree, "batch": batch,
            "prompt": prompt, "ws": ws, "x": x, "narrow_jcfg": narrow_jcfg,
            "narrow": narrow,
            "narrow_tree": jax.tree.map(np.asarray, narrow)}


@pytest.fixture(scope="module")
def four(reference, tmp_path_factory):
    r = reference
    tmp = tmp_path_factory.mktemp("dist4")
    return run_ranks(W.four_ranks, 4, ARCH, r["tree"], r["batch"],
                     r["prompt"], r["ws"], r["x"], str(tmp / "ckpt"),
                     r["narrow_tree"], work_dir=str(tmp),
                     timeout_s=TIMEOUT_S)[0]


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist8")
    return run_ranks(W.eight_ranks, 8, work_dir=str(tmp),
                     timeout_s=TIMEOUT_S)


def test_sharded_loss_matches_unsharded_and_reference(reference, four):
    loss0, loss, grad_err = four["loss"]
    assert abs(loss - loss0) / abs(loss0) < 1e-5, (loss, loss0)
    assert grad_err < 1e-4, grad_err
    want = reference_run(reference["jcfg"], reference["params"],
                         reference["batch"])[0]
    assert rel_err(loss, want) < F32_TOL, (loss, float(want))


def test_sharded_train_step_matches_unsharded(four):
    err, metrics, ref_metrics = four["train_step"]
    assert err < 1e-4, err
    for k in ("loss", "nll", "grad_norm"):
        assert abs(metrics[k] - ref_metrics[k]) <= 1e-5 * abs(
            ref_metrics[k]), (k, metrics[k], ref_metrics[k])


def _first_step_err(jcfg, params, prompt, first) -> float:
    """The sharded first decode step against the reference's
    single-device ``forward_decode`` from fresh caches at position 0."""
    b = prompt.shape[0]
    want, _ = jax.jit(lambda p, t, c, po: JT.forward_decode(
        p, jcfg, t, c, po))(params, jnp.asarray(prompt[:, 0]),
                            JT.init_caches(jcfg, b, 16),
                            jnp.zeros((b,), jnp.int32))
    want = np.asarray(want)[:, :jcfg.vocab]
    return float(np.abs(first[:, :jcfg.vocab] - want).max()
                 / np.abs(want).max())


def test_sharded_cache_decode_matches(reference, four):
    got = four["decode"]
    assert got["placements"]["k"] == ["S(1)", "S(3)"], got["placements"]
    assert got["logits"] < 1e-5, got["logits"]
    assert got["cache_ulps"] <= ONE_BF16_ROUNDING, got["cache_ulps"]
    err = _first_step_err(reference["jcfg"], reference["params"],
                          reference["prompt"], got["first"])
    assert err < 3e-2, err


def test_sequence_sharded_cache_decode_matches(reference, four):
    """2 KV heads on |model| 4: the caches are sharded on the sequence
    (11 rows split 3, 3, 3, 2), prefill and each decode step write only
    the rows a rank's shard holds, and decode runs the one-pass
    ``impl="dense"`` attention over the split rows.  The caches are f32
    here: in bf16, one element rounded the other way moves the logits by
    about 7e-6 on any mesh, (4, 1) included, which would decide a 1e-5
    bar; the first step from fresh caches stays in bf16."""
    got = four["decode_seq"]
    assert got["placements"]["k"] == ["S(1)", "S(2)"], got["placements"]
    assert got["logits"] < 1e-5, got["logits"]
    assert got["caches"] < 1e-5, got["caches"]
    err = _first_step_err(reference["narrow_jcfg"], reference["narrow"],
                          reference["prompt"], got["first"])
    assert err < 3e-2, err


def test_pipeline_apply_matches_sequential(reference, four):
    out, util = four["pipeline"]
    ref = reference["x"]
    for w in reference["ws"]:
        ref = np.tanh(ref @ w)
    assert np.abs(out - ref).max() < 1e-5
    assert abs(util - 4 / 7) < 1e-9


def test_hierarchical_psum_equals_flat_all_reduce(four, eight):
    for rel, mean_err, raised in (four["hier"], eight[0][2]):
        assert rel < 1e-6, rel
        assert mean_err < 1e-4, mean_err
        assert raised


def test_multipod_mesh_builds(eight):
    for shape, dp, _ in eight:
        assert shape == {"pod": 2, "data": 2, "model": 2}
        assert dp == ("pod", "data")


def test_elastic_restore_round_trips_bit_for_bit(four):
    placed, sharded, unsharded, *_ = four["checkpoint"]
    assert placed
    assert sharded
    assert unsharded


def test_fit_restarts_onto_a_mesh(four):
    *_, restored_from, steps, finite = four["checkpoint"]
    assert restored_from == 1
    assert steps == 1 and finite
