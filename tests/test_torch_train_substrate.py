"""The port's training substrate held to the JAX reference on the CPU:
AdamW step by step and its schedule, gradient accumulation over one and
two microbatches, int8 compression with error feedback (bit for bit),
the data streams (bit for bit), checkpoints (round trip, rotation,
cross-restore in both directions, the reference's leaf keys), the
checkpoint store's ZNS telemetry, the fault-tolerant loop (restart
equivalence, straggler detection) and the training CLI.

The reference's functions run compiled (``jax.jit``), as in its train
step.  Tolerances: the optimizer's f32 moments at ``rel_err`` 1e-6 (1e-5
while they carry a clip, whose gradient norm is summed in another
order) and
the parameters within one ulp of their dtype plus 1e-5 of their largest
update (:func:`within_an_ulp`: the two packages add the gradient norm in
different orders); gradient accumulation at 1e-6 in f32 and 2^-7 (a
bf16 ulp) in bf16; everything else exactly.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.core import SUPERBLOCK as J_SUPERBLOCK
from repro.models import transformer as JT
from repro.train import checkpoint as JCK
from repro.train import data as JD
from repro.train import grad as JG
from repro.train import optimizer as JOPT
from repro_torch.core import SUPERBLOCK
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.train import checkpoint as TCK
from repro_torch.train import data as TD
from repro_torch.train import grad as TG
from repro_torch.train import optimizer as TOPT
from repro_torch.train.loop import LoopConfig, fit

from _train_common import (configs, make_batch, port_model,
                           reference_params, rel_err)


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def same_bits(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.reshape(-1).view(np.uint8).tobytes() == b.reshape(-1).view(
        np.uint8).tobytes()


def in_order(model, tree):
    """A reference-layout tree as tensors in ``model.parameters()``
    order (paired by name through ``params_from_numpy``)."""
    by_name = dict(TT.params_from_numpy(model.cfg, as_np(tree),
                                        device="cpu").named_parameters())
    return [by_name[n].detach().clone() for n, _ in model.named_parameters()]


def within_an_ulp(got, want, before) -> bool:
    """``got`` within one ulp of ``want`` in their dtype (f32 or bf16), at
    the magnitude of the update's operands (``p - lr * (...)`` may cancel
    to near 0, where an ulp of ``p`` is many of the result's), plus 1e-5
    of the leaf's largest update: the two packages add the gradient norm
    in different orders, so the clip and the moments part by ~1e-7."""
    mant = 7 if np.asarray(want).dtype.name == "bfloat16" else 23
    got, want, before = (np.asarray(x, np.float64) for x in (got, want,
                                                              before))
    mag = np.maximum(np.abs(before), np.abs(want))
    ulp = np.where(mag > 0, np.exp2(np.floor(np.log2(
        np.where(mag > 0, mag, 1.0))) - mant), 0.0)
    step = np.abs(want - before).max()
    return bool(np.all(np.abs(got - want) <= ulp + 1e-5 * step))


# --------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------- #
def test_schedule_matches_the_reference():
    jcfg = JOPT.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    tcfg = TOPT.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    steps = np.arange(0, 120, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: JOPT.schedule(jcfg, s)))(
        steps))
    got = TOPT.schedule(tcfg, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    assert rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_steps_match_the_reference(dtype):
    """Four updates of the reduced granite's parameters from the same
    gradients (a clipped first step, then unclipped small ones), the
    port's parameters and state carried over from the reference's after
    two."""
    jcfg, tcfg = configs("granite-3-8b")
    params = reference_params(jcfg, 40, dtype)
    opt_kw = dict(lr=1e-2, warmup_steps=2, total_steps=8)
    jopt, topt = JOPT.AdamWConfig(**opt_kw), TOPT.AdamWConfig(**opt_kw)
    rng = np.random.default_rng(41)
    leaves, tdef = jax.tree.flatten(params)
    jupdate = jax.jit(lambda p, g, s: JOPT.update(jopt, p, g, s))
    model = port_model(tcfg, params)
    jstate, tstate = JOPT.init(params), TOPT.init(model)
    for k in range(4):
        scale = 10.0 if k == 0 else 1e-3
        grads = tdef.unflatten([
            jnp.asarray(scale * rng.standard_normal(a.shape), a.dtype)
            for a in leaves])
        before = as_np(params)
        params, jstate, jm = jupdate(params, grads, jstate)
        model, tstate, tm = TOPT.update(topt, model, in_order(model, grads),
                                        tstate)
        assert float(tm["lr"]) == float(jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= (
            1e-5 * float(jm["grad_norm"]))
        got = TOPT.state_to_numpy(tstate)
        want = as_np(jstate)
        assert int(got.step) == int(want.step) == k + 1
        # steps 0-1 carry step 0's clip, whose gradient norm the two
        # packages add in different orders (~1e-6 apart in bf16); from
        # the reference's state at step 2 on, nothing is clipped
        tol = 1e-5 if k < 2 else 1e-6
        for g, w in ((got.mu, want.mu), (got.nu, want.nu)):
            jax.tree.map(lambda a, b: np.testing.assert_array_less(
                rel_err(a, b), tol), g, w)
        got_p = TT.params_to_numpy(model, bf16_dtype=jnp.bfloat16)
        assert all(jax.tree.leaves(jax.tree.map(
            within_an_ulp, got_p, as_np(params), before)))
        if k == 1:       # the reference's state carried into the port
            tstate = TOPT.state_from_numpy(tcfg, want, device="cpu")
            model = TT.set_trainable(TT.params_from_numpy(
                tcfg, as_np(params), device="cpu"))
    assert tstate.mu.embed.dtype == torch.float32


def test_adamw_clip_reports_the_norm_before_clipping():
    cfg = TOPT.AdamWConfig(lr=1e-3, grad_clip=1.0)
    model = nn.Module()
    model.w = nn.Parameter(torch.zeros(4))
    state = TOPT.init(model)
    _, _, m = TOPT.update(cfg, model, [torch.full((4,), 1e6)], state)
    assert float(m["grad_norm"]) > 1e5
    assert float(model.w.abs().max()) < 2e-3


# --------------------------------------------------------------------- #
# gradient accumulation and compression
# --------------------------------------------------------------------- #
class Linear(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = nn.Parameter(w)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_accumulate_grads_matches_the_reference(n_micro, dtype):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(42)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    y = rng.standard_normal((6, 4)).astype(np.float32)

    def jloss(p, b):
        err = (b["x"] @ p["w"]).astype(jnp.float32) - b["y"]
        return jnp.mean(err ** 2), {"err": jnp.mean(err)}

    def tloss(m, b):
        err = (b["x"] @ m.w).float() - b["y"]
        return (err ** 2).mean(), {"err": err.mean()}
    wl, wg, wm = jax.jit(lambda p, b: JG.accumulate_grads(
        jloss, p, b, n_micro))({"w": jnp.asarray(w, jd)},
                               {"x": jnp.asarray(x, jd), "y": y})
    tl, tg, tm = TG.accumulate_grads(
        tloss, Linear(torch.from_numpy(w).to(td)),
        {"x": torch.from_numpy(x).to(td), "y": torch.from_numpy(y)},
        n_micro)
    want_dtype = np.float32 if n_micro > 1 else np.asarray(wg["w"]).dtype
    assert np.asarray(wg["w"]).dtype == want_dtype
    assert tg[0].dtype == (torch.float32 if n_micro > 1 else td)
    # bf16 products round to bf16 in both packages, not always alike
    tol = 1e-6 if dtype == "f32" else 2.0 ** -7
    assert rel_err(tg[0].float().numpy(), wg["w"]) <= tol
    assert abs(float(tl) - float(wl)) <= tol * abs(float(wl))
    assert abs(float(tm["err"]) - float(wm["err"])) <= tol


def test_compress_int8_is_the_reference_bit_for_bit():
    """Per-tensor scales (a multiply by f32(1/127), as compiled), rounding
    half to even, clipping, an all-zero tensor, and bf16 input."""
    rng = np.random.default_rng(43)
    cases = [rng.standard_normal(257).astype(np.float32) * 10 ** e
             for e in (-9, -3, 0, 4)]
    half = np.arange(-6, 7, dtype=np.float32) + 0.5    # ties to even
    cases += [half * (6.5 / 127), np.zeros(5, np.float32),
              np.float32([3e-13, -1e-13])]
    jfn = jax.jit(JG.compress_int8)
    for g in cases:
        for jd, td in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
            q, s = jfn(jnp.asarray(g, jd))
            tq, ts = TG.compress_int8(torch.from_numpy(g).to(td))
            assert np.array_equal(tq.numpy(), np.asarray(q))
            assert ts.item() == float(s)
            assert np.array_equal(TG.decompress_int8(tq, ts).numpy(),
                                  np.asarray(JG.decompress_int8(q, s)))


def test_error_feedback_is_the_reference_bit_for_bit():
    """Three compressed steps of a reduced granite's gradients with the
    residual carried: the port's scale is shared per reference leaf
    (``transformer.leaf_groups``), as the reference quantizes its stacked
    leaves."""
    jcfg, tcfg = configs("granite-3-8b")
    params = reference_params(jcfg, 44, "bf16")
    model = port_model(tcfg, params)
    rng = np.random.default_rng(45)
    leaves, tdef = jax.tree.flatten(params)
    jef, tef = JG.init_error_feedback(params), TG.init_error_feedback(model)
    groups = TT.leaf_groups(model)
    assert len(groups) == len(leaves)
    jfn = jax.jit(JG.compress_grads_ef)
    for _ in range(3):
        grads = tdef.unflatten([jnp.asarray(
            rng.standard_normal(a.shape) * 1e-2, a.dtype) for a in leaves])
        deq, jef = jfn(grads, jef)
        tdeq, tef = TG.compress_grads_ef(in_order(model, grads), tef,
                                         groups)
        for got, want in ((tdeq, deq), (tef, jef)):
            got = TT.params_to_numpy(TT.like(model, got))
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                         got, as_np(want))


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #
def test_data_streams_are_the_reference_bit_for_bit(tmp_path):
    for kw in (dict(vocab=1000, batch=4, seq=16, seed=3),
               dict(vocab=50304, batch=8, seq=33, seed=0, host_id=1,
                    n_hosts=2)):
        j, t = JD.SyntheticLM(**kw), TD.SyntheticLM(**kw)
        for step in (0, 1, 7, 1000):
            a, b = j.batch_at(step), t.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k])
        it = t.iterate(5)
        assert np.array_equal(next(it)["tokens"], j.batch_at(5)["tokens"])
    jp = JD.write_synthetic_corpus(tmp_path / "j.bin", 5000, 512, seed=2)
    tp = TD.write_synthetic_corpus(tmp_path / "t.bin", 5000, 512, seed=2)
    assert jp.read_bytes() == tp.read_bytes()
    j = JD.MemmapLM(str(jp), vocab=300, batch=4, seq=64, seed=1)
    t = TD.MemmapLM(str(tp), vocab=300, batch=4, seq=64, seed=1)
    for step in (0, 3, 99):
        for k in ("tokens", "labels"):
            assert np.array_equal(j.batch_at(step)[k], t.batch_at(step)[k])
    with pytest.raises(ValueError):
        TD.SyntheticLM(vocab=10, batch=3, seq=4, n_hosts=2).batch_at(0)


# --------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------- #
def _states(seed: int):
    """The reduced granite in bf16 after one AdamW update, in both
    packages' forms: (reference tree, port tree)."""
    jcfg, tcfg = configs("granite-3-8b")
    params = reference_params(jcfg, seed, "bf16")
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), a.dtype), params)
    opt_cfg = JOPT.AdamWConfig(lr=1e-2)
    params, opt, _ = JOPT.update(opt_cfg, params, grads, JOPT.init(params))
    model = TT.params_from_numpy(tcfg, as_np(params), device="cpu")
    topt = TOPT.state_from_numpy(tcfg, as_np(opt), device="cpu")
    return ({"params": params, "opt": opt}, {"params": model, "opt": topt},
            tcfg)


def _fresh(tcfg):
    model = TT.init_params(tcfg, torch.Generator().manual_seed(9),
                           device="cpu")
    return {"params": model, "opt": TOPT.init(model)}


def _same(port_tree, ref_tree) -> None:
    got = {"params": TT.params_to_numpy(port_tree["params"],
                                        bf16_dtype=jnp.bfloat16),
           "opt": TOPT.state_to_numpy(port_tree["opt"])}
    want = as_np(ref_tree)
    assert int(got["opt"].step) == int(want["opt"].step)
    jax.tree.map(same_bits, {"p": got["params"], "mu": got["opt"].mu,
                             "nu": got["opt"].nu},
                 {"p": want["params"], "mu": want["opt"].mu,
                  "nu": want["opt"].nu})


def test_checkpoint_keys_and_manifest_are_the_reference(tmp_path):
    """The same state saved by both packages: the same leaves in the same
    order under the same keys (``opt..mu.slots.0...``: a NamedTuple field
    prints as ``.mu``), shapes, dtypes and bytes."""
    ref, port, _ = _states(46)
    JCK.CheckpointManager(tmp_path / "j", async_save=False).save(
        0, ref, meta={"step": 0})
    TCK.CheckpointManager(tmp_path / "t", async_save=False).save(
        0, port, meta={"step": 0})
    jm = json.loads((tmp_path / "j/step_00000000/manifest.json").read_text())
    tm = json.loads((tmp_path / "t/step_00000000/manifest.json").read_text())
    assert tm == jm
    keys = [JCK._key_str(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert [leaf["key"] for leaf in tm["leaves"]] == keys
    assert "opt..mu.slots.0.mixer.self.wq" in keys and "opt..step" in keys
    assert {leaf["dtype"] for leaf in tm["leaves"]} == {
        "bfloat16", "float32", "int32"}


def test_checkpoint_round_trip_and_cross_restore(tmp_path):
    ref, port, tcfg = _states(47)
    # port -> port
    ck = TCK.CheckpointManager(tmp_path / "t", keep=2)
    ck.save(3, port, meta={"step": 3, "loss": 1.5})
    like = _fresh(tcfg)
    got, meta = ck.restore(like)
    assert meta == {"step": 3, "loss": 1.5}
    assert got["params"] is like["params"]          # restored in place
    _same(got, ref)
    # port -> reference
    jlike = jax.tree.map(jnp.zeros_like, ref)
    back, _ = JCK.CheckpointManager(tmp_path / "t").restore(jlike)
    jax.tree.map(same_bits, as_np(back), as_np(ref))
    # reference -> port
    JCK.CheckpointManager(tmp_path / "j", async_save=False).save(
        5, ref, meta={"step": 5})
    got, meta = TCK.CheckpointManager(tmp_path / "j").restore(_fresh(tcfg))
    assert meta == {"step": 5}
    _same(got, ref)
    with pytest.raises(FileNotFoundError):
        TCK.CheckpointManager(tmp_path / "empty").restore(_fresh(tcfg))


def test_checkpoint_rotation_keeps_k(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32), "b": [np.int32(3)]}
    ck = TCK.CheckpointManager(tmp_path, keep=2)
    for s in range(5):
        ck.save(s, tree, meta={"step": s})
    ck.wait()
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    assert ck.saves == 5 and ck.bytes_saved == 5 * (40 + 4)
    like = {"a": torch.zeros(10), "b": [np.int32(0)]}
    got, _ = ck.restore(like)
    assert torch.equal(got["a"], tree["a"]) and int(got["b"][0]) == 3


def test_zns_telemetry_reports_as_the_reference(tmp_path):
    """The same save sequence through both packages' checkpoint stores
    (zn540, SUPERBLOCK): three managers' saves with rotation, then
    checkpoint-sized files written and rotated out directly -- the
    reports are equal."""
    jz = JCK.ZNSTelemetry(element=J_SUPERBLOCK)
    tz = TCK.ZNSTelemetry(element=SUPERBLOCK, device="cpu")
    tree = {"w": np.zeros((64, 64), np.float32), "v": np.zeros(3, np.int32)}
    for pkg, z, d in ((JCK, jz, "j"), (TCK, tz, "t")):
        ck = pkg.CheckpointManager(tmp_path / d, keep=1, async_save=False,
                                   zns=z)
        for s in range(3):
            ck.save(s, tree, meta={"step": s})
    mib = 1 << 20
    for z in (jz, tz):
        for s in range(4):
            for i, size in enumerate((700 * mib, 300 * mib, 5 * mib)):
                z.write_file(f"c{s}/{i}", size, TCK.LIFETIME_CKPT)
            z.write_file(f"log{s}", 64 << 10, TCK.LIFETIME_LOG)
            if s:
                for i in range(3):
                    z.delete_file(f"c{s - 1}/{i}")
    want, got = jz.report(), tz.report()
    assert got == want
    assert got["resets"] > 0 and got["finishes"] > 0


# --------------------------------------------------------------------- #
# the loop and the CLI
# --------------------------------------------------------------------- #
def _loop_setup(tmp_path, name):
    jcfg, tcfg = configs("granite-3-8b")
    model = port_model(tcfg, reference_params(jcfg, 48, "f32"))
    opt_cfg = TOPT.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=6)
    data = TD.SyntheticLM(vocab=tcfg.vocab, batch=2, seq=8, seed=1)
    ck = TCK.CheckpointManager(tmp_path / name, keep=2)
    return (TM.make_train_step(tcfg, opt_cfg), model, TOPT.init(model),
            data, ck)


def test_fit_restart_replays_the_uninterrupted_run(tmp_path):
    step, model, opt, data, ck = _loop_setup(tmp_path, "a")
    full = fit(step, model, opt, data, ck, LoopConfig(total_steps=6,
                                                      ckpt_every=2))
    assert full.restored_from is None and len(full.losses) == 6
    step, model, opt, data, ck = _loop_setup(tmp_path, "b")
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        fit(step, model, opt, data, ck,
            LoopConfig(total_steps=6, ckpt_every=2, fail_at_step=3))
    step, model, opt, data, ck = _loop_setup(tmp_path, "b")
    again = fit(step, model, opt, data, ck, LoopConfig(total_steps=6,
                                                       ckpt_every=2))
    assert again.restored_from == 1
    assert again.losses == full.losses[2:]           # bit for bit
    assert full.losses[-1] < full.losses[0]


def test_fit_flags_stragglers():
    """A step 50 times its peers' wall time is flagged against the
    rolling median and reported to the hook.  The steps are stand-ins
    that sleep (the loop, not the model, is under test), so a loaded
    host's jitter cannot reach the 3x factor."""
    model = Linear(torch.zeros(2))
    seen, calls = [], []

    def step(p, o, b):
        time.sleep(1.0 if len(calls) == 7 else 0.02)
        calls.append(1)
        return p, o, {"loss": torch.tensor(1.0)}
    data = TD.SyntheticLM(vocab=10, batch=1, seq=2)
    res = fit(step, model, None, data, None,
              LoopConfig(total_steps=10, straggler_factor=3.0),
              on_straggler=lambda s, dt: seen.append(s))
    assert 7 in res.stragglers and seen == res.stragglers
    assert len(res.losses) == 10


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "xlstm-125m", "--reduced", "--steps", "3", "--batch",
            "2", "--seq", "8", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "2", "--device", "cpu"]
    run = launch_train.main(args)
    out = capsys.readouterr().out
    assert "[train] xlstm-125m (reduced)" in out
    assert "ZNS ckpt-store telemetry: DLWA=" in out
    res = run["result"]
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert run["ckpt"].all_steps() == [1, 2]
    again = launch_train.main(args)
    assert "restored from checkpoint step 2" in capsys.readouterr().out
    assert again["result"].losses == []
