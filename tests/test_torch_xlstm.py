"""The port's xLSTM path held to the JAX package on the CPU: the forward of
``chunked_remat_scan``, ``log_sigmoid``, the mLSTM and sLSTM blocks
(prefill through both scans' plain versions, decode with its caches),
the sLSTM gate layout, whole prefill + decode runs of the reduced
xlstm-125m through ``serve.generate``, decode from scratch against the
reference's whole-sequence forward, the parameter round trip and count,
and the port's lint.

Tolerances (``rel_err`` = max abs difference over max abs reference), as
in ``tests/test_torch_mamba.py``: 1e-3 in f32 (summation order), 3e-2 in
bf16 (bf16 rounds after every op in both packages, not always at the
same places).  The reference runs compiled (``jax.jit``), as it is
served.

The reference refuses an f32 sLSTM prefill: its scan's carry ``h``
starts in bf16 (``init_slstm_cache``) and the step returns it in the
activation dtype, so ``lax.scan`` raises "carry input and carry output
must have equal types".  The f32 sLSTM prefill is held to a ``lax.scan``
of the reference's own ``_slstm_step`` with an f32 ``h`` carry, and the
f32 model runs use an mLSTM-only pattern.

Like the Mamba state, the reference's prefill hands both xLSTM caches
back unchanged, so decode starts every xLSTM layer from its initial
state; the runs below pin that.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.check import lint as JLINT
from repro.configs import get_arch as j_get_arch
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro_torch.check import lint as TLINT
from repro_torch.configs import get_arch
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX

XLSTM = "xlstm-125m"
TOL = {"f32": 1e-3, "bf16": 3e-2}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
ROOT = Path(__file__).resolve().parent.parent
D, H = 64, 4                 # the reduced width: mLSTM P 32, sLSTM ph 16


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def to_np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def torch_like(a) -> torch.Tensor:
    """A reference leaf as a torch tensor of the same dtype, bit for
    bit."""
    a = np.asarray(a)
    td = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    return torch.from_numpy(a.astype(np.float32)).to(td)


def params_as(p, jd):
    return jax.tree.map(lambda a: a.astype(jd), p)


# --------------------------------------------------------------------- #
# the scan and the gate
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("t", [37, 256])
def test_chunked_remat_scan_equals_lax_scan(t):
    """A two-part carry and two stacked outputs: T 37 takes the
    reference's plain scan, T 256 its chunks of 128."""
    rng = np.random.default_rng(t)
    xs = rng.standard_normal((t, 3, 5)).astype(np.float32)
    w = rng.standard_normal((5, 5)).astype(np.float32) * 0.3

    def j_step(carry, x):
        a, s = carry
        a = jnp.tanh(a @ w + x)
        return (a, s + a.sum()), (a, a.mean(-1))

    def t_step(carry, x):
        a, s = carry
        a = torch.tanh(a @ torch.from_numpy(w) + x)
        return (a, s + a.sum()), (a, a.mean(-1))

    c0 = (np.zeros((3, 5), np.float32), np.float32(0))
    want_c, want_y = jax.lax.scan(j_step, tuple(map(jnp.asarray, c0)),
                                  jnp.asarray(xs))
    ref_c, ref_y = jax.jit(lambda c, x: JL.chunked_remat_scan(
        j_step, c, x, chunk=128))(tuple(map(jnp.asarray, c0)),
                                  jnp.asarray(xs))
    got_c, got_y = TL.chunked_remat_scan(
        t_step, (torch.zeros(3, 5), torch.tensor(0.0)),
        torch.from_numpy(xs), chunk=128)
    for got, want, ref in zip(list(got_c) + list(got_y),
                              list(want_c) + list(want_y),
                              list(ref_c) + list(ref_y)):
        assert tuple(got.shape) == want.shape
        assert rel_err(to_np(got), want) <= 1e-6
        assert rel_err(to_np(got), ref) <= 1e-6
    assert tuple(got_y[0].shape) == (t, 3, 5)


def test_log_sigmoid_is_the_reference_form():
    x = np.array([-1e4, -120.0, -30.0, -5.0, -0.3, 0.0, 0.7, 5.0, 20.0,
                  35.0, 300.0, np.inf, -np.inf, np.nan], np.float32)
    got = to_np(TL.log_sigmoid(torch.from_numpy(x)))
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    assert np.array_equal(got[inf], want[inf])
    ok = ~np.isnan(want) & ~inf        # to an ulp or so of f32
    assert np.all(np.abs(got[ok] - want[ok])
                  <= 2e-7 * np.abs(want[ok]) + 1e-30)


# --------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------- #
def mlstm_params(dt: str, seed: int = 0):
    jd = DT[dt][0]
    p = params_as(JX.mlstm_init(jax.random.PRNGKey(seed), D, H), jd)
    if dt == "bf16":      # a non-trivial norm weight
        p["out_norm"] = jnp.asarray(1 + 0.1 * np.random.default_rng(
            seed).standard_normal(p["out_norm"].shape), jd)
    return p, {k: torch_like(v) for k, v in p.items()}


def test_key_scale_is_the_rounded_root_reciprocal():
    """The compiled reference multiplies by the f32 reciprocal of √P
    rounded to the activation dtype: 1 / 5.65625 at P 32 in bf16, 1 /
    19.625 at P 384."""
    assert TX._key_scale(32, torch.bfloat16) == float(
        np.float32(1) / np.float32(5.65625))
    assert TX._key_scale(384, torch.bfloat16) == float(
        np.float32(1) / np.float32(19.625))
    assert TX._key_scale(32, torch.float32) == float(
        np.float32(1) / np.float32(np.sqrt(32)))


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s", [37, 256])
def test_mlstm_forward_matches_the_reference(dt, impl, s):
    jd, td = DT[dt]
    jp, tp = mlstm_params(dt)
    x = np.random.default_rng(3).standard_normal((2, s, D))
    want = jax.jit(lambda p, x: JX.mlstm_forward(p, x, H))(
        jp, jnp.asarray(x, jd))
    before = mlstm_ops.launches
    got = TX.mlstm_forward(tp, torch.from_numpy(x).to(td), H, impl=impl)
    assert mlstm_ops.launches == before            # the CPU path
    assert got.dtype == td
    assert rel_err(to_np(got), want) <= TOL[dt]


def _random_mlstm_cache(rng, b: int, ph: int):
    return {"c": rng.standard_normal((b, H, ph, ph)).astype(np.float32),
            "n": rng.standard_normal((b, H, ph)).astype(np.float32),
            "m": rng.standard_normal((b, H)).astype(np.float32)}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlstm_decode_matches_the_reference(dt):
    """Three steps from a random cache: the output and the cache each
    step (the port's cache is updated in place), then three from the
    initial cache (m = -1e30)."""
    jd, td = DT[dt]
    jp, tp = mlstm_params(dt, seed=4)
    rng = np.random.default_rng(4)
    step = jax.jit(lambda p, x, c: JX.mlstm_decode(p, x, c, H))
    for start in (_random_mlstm_cache(rng, 2, 2 * D // H),
                  {k: np.asarray(v) for k, v in
                   JX.init_mlstm_cache(2, D, H).items()}):
        jc = {k: jnp.asarray(v) for k, v in start.items()}
        tc = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
        for _ in range(3):
            x = rng.standard_normal((2, D))
            jo, jc = step(jp, jnp.asarray(x, jd), jc)
            to, out = TX.mlstm_decode(tp, torch.from_numpy(x).to(td), tc, H)
            assert out is tc and to.dtype == td
            assert rel_err(to_np(to), jo) <= TOL[dt]
            for k in ("c", "n", "m"):
                assert tc[k].dtype == torch.float32
                assert rel_err(to_np(tc[k]), jc[k]) <= TOL[dt], k


def test_mlstm_cache_matches_the_reference_init():
    want = JX.init_mlstm_cache(3, D, H)
    got = TX.init_mlstm_cache(3, D, H, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert np.array_equal(to_np(got[k]), np.asarray(want[k]))


# --------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------- #
def slstm_params(dt: str, seed: int = 1):
    p = params_as(JX.slstm_init(jax.random.PRNGKey(seed), D, H), DT[dt][0])
    return p, {k: torch_like(v) for k, v in p.items()}


def _slstm_forward_f32_carry(p, x):
    """The reference's ``slstm_forward`` with an f32 ``h`` carry: a
    ``lax.scan`` of its own ``_slstm_step``."""
    b = x.shape[0]
    init = JX.init_slstm_cache(b, D, H)
    carry = (init["c"], init["n"], init["m"], init["h"].astype(x.dtype))

    def step(carry, x_t):
        new = JX._slstm_step(p, x_t, carry, H)
        return new, new[3]
    _, hs = jax.lax.scan(step, carry, x.transpose(1, 0, 2))
    return hs.transpose(1, 0, 2) @ p["out"]


def test_reference_refuses_an_f32_slstm_prefill():
    p, _ = slstm_params("f32")
    with pytest.raises(TypeError, match="carry"):
        JX.slstm_forward(p, jnp.zeros((1, 3, D), jnp.float32), H)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_slstm_forward_matches_the_reference(dt, impl):
    jd, td = DT[dt]
    jp, tp = slstm_params(dt)
    x = np.random.default_rng(5).standard_normal((2, 37, D))
    fwd = (_slstm_forward_f32_carry if dt == "f32"
           else (lambda p, x: JX.slstm_forward(p, x, H)))
    want = jax.jit(fwd)(jp, jnp.asarray(x, jd))
    before = slstm_ops.launches
    got = TX.slstm_forward(tp, torch.from_numpy(x).to(td), H, impl=impl)
    assert slstm_ops.launches == before            # the CPU path
    assert got.dtype == td
    assert rel_err(to_np(got), want) <= TOL[dt]
    if dt == "bf16":
        # the compiled step adds the two rounded terms in f32 without
        # rounding the sum (the port follows it): bit for bit here
        assert np.array_equal(to_np(got), np.asarray(want, np.float32))


def _random_slstm_cache(rng, b: int, h_dtype):
    return {"c": rng.standard_normal((b, D)).astype(np.float32),
            "n": np.abs(rng.standard_normal((b, D))).astype(np.float32),
            "m": rng.standard_normal((b, H)).astype(np.float32),
            "h": np.asarray(jnp.asarray(rng.standard_normal((b, D)) * 0.5,
                                        h_dtype), np.float32)}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_slstm_decode_matches_the_reference(dt):
    """Three steps from a random cache and three from the initial one;
    the cache's ``h`` in the activation dtype on both sides (the
    reference's decode returns it so)."""
    jd, td = DT[dt]
    jp, tp = slstm_params(dt, seed=6)
    rng = np.random.default_rng(6)
    step = jax.jit(lambda p, x, c: JX.slstm_decode(p, x, c, H))
    init = {k: np.asarray(v, np.float32) for k, v in
            JX.init_slstm_cache(2, D, H).items()}
    for start in (_random_slstm_cache(rng, 2, jd), init):
        jc = {k: jnp.asarray(v, jd if k == "h" else jnp.float32)
              for k, v in start.items()}
        tc = {k: torch.from_numpy(v.copy()).to(td if k == "h"
                                              else torch.float32)
              for k, v in start.items()}
        for _ in range(3):
            x = rng.standard_normal((2, D))
            jo, jc = step(jp, jnp.asarray(x, jd), jc)
            to, out = TX.slstm_decode(tp, torch.from_numpy(x).to(td), tc, H)
            assert out is tc and to.dtype == td
            assert rel_err(to_np(to), jo) <= TOL[dt]
            for k in ("c", "n", "m", "h"):
                assert rel_err(to_np(tc[k]), jc[k]) <= TOL[dt], k


@pytest.mark.parametrize("head", range(H))
def test_slstm_gate_layout_takes_each_gate_from_one_head(head):
    """``rec`` (B, H, 4 ph) read as (B, 4d): with H = 4 the z, i, f, o
    gates take their recurrent terms from heads 0, 1, 2, 3.  Only head
    ``head``'s h_prev is non-zero and x is zero, from the initial c, n,
    m: then h = sigmoid(o) tanh(z) with o's and z's recurrent terms, so
    h is non-zero only when head 0 (z) is the live one, and n = exp(i -
    max_head i) differs from 1 only when head 1 (i) is."""
    jp, tp = slstm_params("f32", seed=7)
    rng = np.random.default_rng(7)
    h = np.zeros((2, D), np.float32)
    ph = D // H
    h[:, head * ph:(head + 1) * ph] = rng.standard_normal((2, ph))
    init = {k: np.asarray(v, np.float32) for k, v in
            JX.init_slstm_cache(2, D, H).items()}
    init["h"] = h
    jo, jc = jax.jit(lambda p, x, c: JX.slstm_decode(p, x, c, H))(
        jp, jnp.zeros((2, D), jnp.float32),
        {k: jnp.asarray(v) for k, v in init.items()})
    tc = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    to, _ = TX.slstm_decode(tp, torch.zeros(2, D), tc, H)
    assert rel_err(to_np(tc["h"]), jc["h"]) <= TOL["f32"]
    assert rel_err(to_np(tc["n"]), jc["n"]) <= TOL["f32"]
    assert bool(tc["h"].abs().max() > 0) == (head == 0)
    assert bool((tc["n"] - 1).abs().max() > 1e-6) == (head == 1)


def test_slstm_cache_matches_the_reference_init():
    want = JX.init_slstm_cache(3, D, H)
    got = TX.init_slstm_cache(3, D, H, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[1] == str(want[k].dtype)
        assert np.array_equal(to_np(got[k]),
                              np.asarray(want[k], np.float32))


def test_scan_wrappers_check_their_arguments():
    q = torch.zeros(1, 3, 2, 32)
    g = torch.zeros(1, 3, 2)
    with pytest.raises(ValueError, match="one \\(B, S, H, P\\) shape"):
        mlstm_ops.mlstm_scan(q, q[..., :16], q, g, g)
    with pytest.raises(ValueError, match="log_i and log_f"):
        mlstm_ops.mlstm_scan(q, q, q, g[:, :2], g)
    with pytest.raises(TypeError, match="float32"):
        mlstm_ops.mlstm_scan(q, q, q, g.double(), g)
    with pytest.raises(ValueError, match="unknown mlstm_scan impl"):
        mlstm_ops.mlstm_scan(q, q, q, g, g, impl="xla")
    pre = torch.zeros(1, 3, 64)
    with pytest.raises(ValueError, match="not \\(H, ph, 4 ph\\)"):
        slstm_ops.slstm_scan(pre, torch.zeros(4, 16, 32))
    with pytest.raises(TypeError, match="r_rec is"):
        slstm_ops.slstm_scan(pre, torch.zeros(4, 4, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="unknown ssm impl"):
        slstm_ops.slstm_scan(pre, torch.zeros(4, 4, 16), impl="xla")


PLAN_SHAPES = [(768, 4), (2048, 4), (1024, 4), (512, 4), (64, 4),
               (96, 3), (48, 4), (32, 4), (40, 5), (24, 3), (96, 4),
               (256, 4), (1024, 8), (1536, 8), (3072, 16)]


def test_slstm_launch_plan_at_the_served_shape():
    """xlstm-125m's sLSTM (d 768, H 4): bf16 takes a cluster of 8, 96
    units a CTA, its 147,456-byte slice of r_rec in registers as
    tensor-core fragments (12 row blocks of 16, 384 threads); f32 takes
    the L2 kernel."""
    bf = slstm_ops.launch_plan(768, 4, torch.bfloat16)
    assert bf == slstm_ops.Plan(
        "cluster", cluster=8, units=96, kb=12, threads=384,
        smem=slstm_ops.cluster_smem(768, 4, 8), r_bytes=147_456)
    assert bf.smem == 32 + 4 * (2 * 768 + 4 * 96) + 8 * 8 * 3 * 4
    assert slstm_ops.launch_plan(768, 4, torch.float32) \
        == slstm_ops.Plan("l2")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_launch_plan_keeps_the_l2_kernel_where_no_cluster_fits(
        dtype):
    """f32 always runs the L2 kernel, and so does bf16 where no cluster
    of 8 or 16 gives a CTA 16 to 96 units (d 2048 in 4 heads: a head's
    512 rows are no fragment shape; d 3072 in 16: 192 units a CTA); bf16
    moves to 16 CTAs where 8 would give a CTA more than 96 units."""
    for d, h in ((2048, 4), (3072, 16), (64, 4), (96, 3)):
        assert slstm_ops.launch_plan(d, h, dtype) == slstm_ops.Plan("l2")
    assert 2048 <= slstm_ops.MAX_D[torch.bfloat16]
    for d, h, c in ((512, 4, 8), (1024, 8, 16), (1536, 8, 16)):
        plan = slstm_ops.launch_plan(d, h, dtype)
        if dtype == torch.float32:
            assert plan == slstm_ops.Plan("l2")
        else:
            assert plan.design == "cluster" and plan.cluster == c


@pytest.mark.parametrize("d,h", PLAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_launch_plan_obeys_the_kernel_limits(d, h, dtype):
    """Every plan, at the served width, the L2 widths and the ragged
    reduced ones: the source's checks (slstm_scan_cluster_fwd) hold, the
    L2 kernel runs only where no cluster could, and the plan's shared
    bytes are the source's."""
    plan = slstm_ops.launch_plan(d, h, dtype)
    ph = d // h
    cluster_ok = [c for c in slstm_ops.CLUSTER_SIZES
                  if d % c == 0 and (d // c) % 16 == 0
                  and 4 * (d // c) <= slstm_ops.MMA_THREADS]
    if plan.design == "l2":
        assert (dtype == torch.float32 or ph % 16
                or ph // 16 not in slstm_ops.MMA_BLOCKS or not cluster_ok)
        return
    c, u = plan.cluster, plan.units
    assert dtype == torch.bfloat16 and c == min(cluster_ok) and d == c * u
    assert u % 16 == 0 and ph == 16 * plan.kb
    assert plan.kb in slstm_ops.MMA_BLOCKS
    assert plan.threads == 4 * u <= slstm_ops.MMA_THREADS
    assert plan.r_bytes == ph * 4 * u * 2
    assert plan.smem == slstm_ops.cluster_smem(d, h, c)


# --------------------------------------------------------------------- #
# the reduced xlstm-125m, served
# --------------------------------------------------------------------- #
def xlstm_cfg(jax_side: bool, **changes):
    cfg = (j_get_arch if jax_side else get_arch)(XLSTM).reduced()
    return dataclasses.replace(cfg, **changes)


#: the served variants: (name, config changes, dtype).  "ffn" is the
#: reduced config itself (d_ff 128, GELU, LayerNorm; one repetition of
#: the 4-slot pattern); "noffn" the full model's block (d_ff 0) over two
#: repetitions, so the layer scan's carry rounds between them; "mlstm"
#: an mLSTM-only pattern, which the reference can prefill in f32.
VARIANTS = {
    "ffn-bf16": ({}, "bf16"),
    "noffn-bf16": ({"d_ff": 0, "n_layers": 8}, "bf16"),
    "mlstm-f32": ({"pattern": ("mlstm", "mlstm"), "n_layers": 4}, "f32"),
    "mlstm-bf16": ({"pattern": ("mlstm", "mlstm"), "n_layers": 4}, "bf16"),
}
B, P, N_DECODE = 2, 16, 5          # prefill + 4 decode steps


def _reference_run(jcfg, params, prompts, forced=None):
    caches = JT.init_caches(jcfg, B, P + N_DECODE)
    logits, after_prefill = jax.jit(JM.make_prefill_step(jcfg))(
        params, prompts, caches)
    decode = jax.jit(JM.make_decode_step(jcfg))
    tokens = [jnp.argmax(logits[:, :jcfg.vocab], axis=-1).astype(jnp.int32)]
    all_logits = [logits]
    caches = after_prefill
    for i in range(N_DECODE - 1):
        pos = jnp.full((B,), P + i, jnp.int32)
        logits, caches = decode(params, tokens[-1], caches, pos)
        tokens.append(jnp.argmax(logits[:, :jcfg.vocab],
                                 axis=-1).astype(jnp.int32))
        all_logits.append(logits)
    return (np.stack([np.asarray(t) for t in tokens], axis=1),
            [np.asarray(lg) for lg in all_logits], after_prefill, caches)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_xlstm_serve_matches_the_reference(variant):
    """Prefill + 4 teacher-forced decode steps: every step's logits,
    every cache after prefill (unchanged: the initial states) and after
    the last step, in the reference's layout."""
    changes, dt = VARIANTS[variant]
    jcfg, tcfg = xlstm_cfg(True, **changes), xlstm_cfg(False, **changes)
    jd, td = DT[dt]
    params = params_as(JT.init_params(jax.random.PRNGKey(9), jcfg), jd)
    prompts = serve.make_prompts(tcfg, B, P, seed=9)
    tokens, logits, after_prefill, caches = _reference_run(
        jcfg, params, jnp.asarray(prompts, jnp.int32))

    model = TT.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    assert model.embed.dtype == td
    alone = serve.generate(model, tcfg, torch.from_numpy(prompts), 1)
    fresh = TT.init_caches(tcfg, B, P + 1, device="cpu")
    assert set(alone["caches"]) == set(fresh)
    for k, v in alone["caches"].items():       # prefill left them as made
        assert torch.equal(v, fresh[k]), k
    ours = TT.caches_to_numpy(tcfg, alone["caches"])
    want = jax.tree.map(np.asarray, after_prefill)
    assert jax.tree.structure(ours) == jax.tree.structure(want)
    for got, ref in zip(jax.tree.leaves(ours), jax.tree.leaves(want)):
        assert got.shape == ref.shape
        assert np.array_equal(np.asarray(got, np.float32),
                              np.asarray(ref, np.float32))

    run = serve.generate(model, tcfg, torch.from_numpy(prompts), N_DECODE,
                         forced=torch.from_numpy(tokens).long())
    assert run["launches"]["prefill"]["mlstm_scan"] == 0   # the CPU path
    assert run["launches"]["prefill"]["slstm_scan"] == 0
    tol = TOL[dt]
    for i, (got, want) in enumerate(zip(run["logits"], logits)):
        assert got.dtype == torch.float32
        err = rel_err(to_np(got)[:, :tcfg.vocab], want[:, :tcfg.vocab])
        assert err <= tol, f"step {i}: rel err {err}"
    if dt == "f32":
        assert np.array_equal(run["tokens"].numpy(), tokens)
    want = jax.tree.map(np.asarray, caches)
    ours = TT.caches_to_numpy(tcfg, run["caches"],
                              bf16_dtype=np.dtype(jnp.bfloat16))
    assert jax.tree.structure(ours) == jax.tree.structure(want)
    for (path, got), ref in zip(jax.tree.flatten_with_path(ours)[0],
                                jax.tree.leaves(want)):
        assert got.shape == ref.shape, path
        assert rel_err(got, ref) <= tol, path


def test_xlstm_decode_from_scratch_matches_the_reference_forward():
    """Four decode steps from fresh caches against the reference's
    whole-sequence forward at position 3, in f32 on the mLSTM-only
    pattern (the reference's f32 forward refuses an sLSTM layer), at
    1e-3: both step the same f32 recurrence."""
    changes = VARIANTS["mlstm-f32"][0]
    jcfg, tcfg = xlstm_cfg(True, **changes), xlstm_cfg(False, **changes)
    params = params_as(JT.init_params(jax.random.PRNGKey(1), jcfg),
                       jnp.float32)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (B, 4))
    want, _ = jax.jit(lambda p, t: JT.forward_train(p, jcfg, t))(
        params, jnp.asarray(tokens, jnp.int32))
    model = TT.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    caches = TT.init_caches(tcfg, B, 8, device="cpu")
    step = TM.make_decode_step(tcfg)
    with torch.inference_mode():
        for i in range(4):
            logits, caches = step(model, torch.from_numpy(tokens[:, i]),
                                  caches,
                                  torch.full((B,), i, dtype=torch.int32))
            assert rel_err(to_np(logits), np.asarray(want)[:, i]) < 1e-3


def test_xlstm_bf16_decode_from_scratch_matches_the_reference_forward():
    """The reduced xlstm-125m (both block kinds) in bf16: four decode
    steps from fresh caches against the reference's bf16 forward at each
    position, at the reference's own widest model-level bar, 5e-2
    (``tests/test_arch_smoke.py``): the reference's own bf16 decode
    measures up to 3.9e-2 against its forward on these inputs, since the
    two round at different places."""
    jcfg, tcfg = xlstm_cfg(True), xlstm_cfg(False)
    params = JT.init_params(jax.random.PRNGKey(2), jcfg)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (B, 4))
    want, _ = jax.jit(lambda p, t: JT.forward_train(p, jcfg, t))(
        params, jnp.asarray(tokens, jnp.int32))
    model = TT.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    caches = TT.init_caches(tcfg, B, 8, device="cpu")
    step = TM.make_decode_step(tcfg)
    with torch.inference_mode():
        for i in range(4):
            logits, caches = step(model, torch.from_numpy(tokens[:, i]),
                                  caches,
                                  torch.full((B,), i, dtype=torch.int32))
            assert rel_err(to_np(logits), np.asarray(want)[:, i]) <= 5e-2


@pytest.mark.parametrize("variant", ["ffn-bf16", "noffn-bf16"])
def test_xlstm_params_round_trip_bit_for_bit(variant):
    changes = VARIANTS[variant][0]
    jcfg, tcfg = xlstm_cfg(True, **changes), xlstm_cfg(False, **changes)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(3),
                                                   jcfg))
    model = TT.params_from_numpy(tcfg, tree, device="cpu")
    assert [b.kind for b in model.blocks] == [k for k, _ in
                                              TT.layer_plan(tcfg)]
    back = TT.params_to_numpy(model, bf16_dtype=tree["embed"].dtype)
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_xlstm_125m_param_count_and_caches():
    cfg = get_arch(XLSTM)
    assert TM.param_count(cfg) == JM.param_count(j_get_arch(XLSTM)) \
        == 145_044_480
    model = TT.init_params(cfg, device="meta")
    assert [b.kind for b in model.blocks] == ["mlstm"] * 3 + ["slstm"] \
        + ["mlstm"] * 3 + ["slstm"] + ["mlstm"] * 3 + ["slstm"]
    assert all(b.ffn is None for b in model.blocks)     # d_ff 0
    caches = TT.init_caches(cfg, 8, 16, device="meta")
    assert {k: (tuple(v.shape), v.dtype) for k, v in caches.items()} == {
        "mlstm_c": ((9, 8, 4, 384, 384), torch.float32),
        "mlstm_n": ((9, 8, 4, 384), torch.float32),
        "mlstm_m": ((9, 8, 4), torch.float32),
        "slstm_c": ((3, 8, 768), torch.float32),
        "slstm_n": ((3, 8, 768), torch.float32),
        "slstm_m": ((3, 8, 4), torch.float32),
        "slstm_h": ((3, 8, 768), torch.bfloat16)}
    assert TT.cache_slots(cfg)[3:5] == [("slstm", 0), ("mlstm", 3)]


def test_serve_main_runs_the_reduced_xlstm_on_the_cpu(capsys):
    run = serve.main(["--arch", XLSTM, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "6",
                      "--decode-tokens", "3"])
    assert tuple(run["tokens"].shape) == (2, 3)
    for phase in ("prefill", "decode"):
        assert run["launches"][phase]["mlstm_scan"] == 0
        assert run["launches"][phase]["slstm_scan"] == 0
    assert all(torch.isfinite(lg).all() for lg in run["logits"])
    assert "[serve] params:" in capsys.readouterr().out


# --------------------------------------------------------------------- #
# the port's lint
# --------------------------------------------------------------------- #
LINT_CASES = {
    "dispatch-in-loop": (
        "def f(eng, progs):\n"
        "    for p in progs:\n"
        "        eng.run_programs(p)\n"
        "    while progs:\n"
        "        run_program(progs.pop())\n"
        "    for p in progs:\n"
        "        run_program(p)  # lint: ok -- one lane at a time, the test\n"
        "    for p in progs:\n"
        "        def g():\n"
        "            return run_program(p)\n"
        "    return eng.run_programs(progs)\n",
        [3, 5]),
    "bench-schema": (
        "A = 'BENCH_paper.json'\n"
        "B = 'BENCH_nope.json'\n"
        "C = 'BENCH_gone.json'  # lint: ok -- a name that must not exist\n"
        "D = 'see BENCH_nope.json'\n"
        "if rep['schema_version'] == 3:\n"
        "    pass\n",
        [2]),
}


def _same_rule(findings, rule):
    """The reference's findings of ``rule``; of ``bench-schema``, the
    artifact-name half only (the port has no schema-version half)."""
    return [(f.path, f.line, f.rule) for f in findings if f.rule == rule
            and (rule != "bench-schema" or "is not an artifact" in f.message)]


@pytest.mark.parametrize("rule", TLINT.RULES)
def test_lint_rule_on_minimal_sources(rule):
    source, lines = LINT_CASES[rule]
    names = TLINT.bench_artifacts(ROOT)
    assert "BENCH_paper.json" in names
    got = TLINT.lint_source(source, "case.py", bench_names=names)
    assert [(f.line, f.rule) for f in got] == [(n, rule) for n in lines]
    want = JLINT.lint_source(source, "case.py", bench_names=names)
    assert [(f.path, f.line, f.rule) for f in got] == _same_rule(want, rule)


@pytest.mark.parametrize("rule", TLINT.RULES)
def test_lint_findings_equal_the_reference_on_the_repo(rule):
    """Both lints over the port's tree and the reference's own sources
    (which hold loops of dispatches the reference allowed with its
    pragma): the same findings of each rule."""
    paths = TLINT.port_files(ROOT) + sorted(
        (ROOT / "src" / "repro").rglob("*.py")) + sorted(
        (ROOT / "tests").glob("test_*.py"))
    got = [(f.path, f.line, f.rule) for f in TLINT.lint_paths(ROOT, paths)
           if f.rule == rule]
    assert got == _same_rule(JLINT.lint_paths(ROOT, paths), rule)


def test_the_port_tree_is_lint_clean():
    assert TLINT.lint_tree(ROOT) == []
    assert TLINT.main([]) == 0


# --------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------- #
@pytest.mark.cuda
def test_cuda_scans_match_their_plain_versions():
    """Both kernels against their plain versions on CUDA tensors, f32
    and bf16, at the reduced widths and ragged lengths, q/k/v as strided
    views of one projection, the sLSTM also at d 256 in 4 heads, where
    bf16 takes the cluster kernel, on the plan's kernel and on the L2
    kernel (``chip_smoke.py`` phase 7f runs the served shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = {torch.float32: 5e-5, torch.bfloat16: 2.5e-2}
    for dtype in (torch.float32, torch.bfloat16):
        for b, s in ((1, 1), (2, 37), (3, 129)):
            qkv = torch.randn((b, s, 3, H, 32), generator=gen,
                              device="cuda").to(dtype)
            q, k, v = qkv.unbind(2)
            gates = torch.randn((b, s, 2 * H), generator=gen,
                                device="cuda")
            li, lf = gates[..., :H], TL.log_sigmoid(gates[..., H:] + 2)
            pairs = [(mlstm_ops.mlstm_scan(q, k, v, li, lf),
                      mlstm_ops.mlstm_scan(q, k, v, li, lf, impl="ref"))]
            for d in (D, 256):
                pre = torch.randn((b, s, 4 * d), generator=gen,
                                  device="cuda").to(dtype)
                r = (torch.randn((H, d // H, 4 * d // H), generator=gen,
                                 device="cuda") * (d // H) ** -0.5).to(dtype)
                want_s = slstm_ops.slstm_scan(pre, r, impl="ref")
                pairs.append((slstm_ops.slstm_scan(pre, r), want_s))
                pairs.append((slstm_ops.launch(pre, r, slstm_ops.Plan("l2")),
                              want_s))
            torch.cuda.synchronize()
            for g, w in pairs:
                assert rel_err(to_np(g), to_np(w)) <= tol[dtype]


@pytest.mark.cuda
def test_cuda_mlstm_designs_match_their_plain_versions():
    """The mLSTM's two kernels on CUDA tensors in bf16: the chunkwise one
    (the plan's at P 32, 96 and 384) and the recurrent one forced at the
    same shapes, T on and off the chunk of 32, q/k/v as strided views,
    each within 2.5e-2 of the stepped plain version, the chunkwise kernel
    also of its own plain version with its operand roundings; the
    source's tiles are the plan's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels.mlstm_scan import ref as mlstm_ref
    lib = mlstm_ops._lib("chunkwise")
    for p in (32, 64, 96, 160, 384):
        assert lib.mlstm_chunkwise_tile(p) == mlstm_ops.launch_plan(
            p, torch.bfloat16).tile
    gen = torch.Generator(device="cuda").manual_seed(5)
    for b, s, p in ((1, 1, 32), (2, 31, 32), (2, 33, 32), (3, 129, 32),
                    (2, 64, 96), (2, 65, 384)):
        qkv = torch.randn((b, s, 3, H, p), generator=gen, device="cuda")
        qkv[:, :, 1] *= p ** -0.5
        q, k, v = qkv.to(torch.bfloat16).unbind(2)
        gates = torch.randn((b, s, 2 * H), generator=gen, device="cuda")
        li, lf = gates[..., :H] * 2, TL.log_sigmoid(gates[..., H:] + 3)
        want = to_np(mlstm_ops.mlstm_scan(q, k, v, li, lf, impl="ref"))
        plan = mlstm_ops.launch_plan(p, torch.bfloat16)
        assert plan.design == "chunkwise"
        got = {}
        for design in (plan, mlstm_ops.Plan("recurrent")):
            before = dict(mlstm_ops.designs)
            got[design.design] = mlstm_ops.launch(q, k, v, li, lf, design)
            torch.cuda.synchronize()
            assert mlstm_ops.designs[design.design] \
                == before[design.design] + 1
            assert rel_err(to_np(got[design.design]), want) <= 2.5e-2
        alg = mlstm_ref.mlstm_chunkwise_ref(
            q, k, v, li, lf, operands=mlstm_ref.KERNEL_OPERANDS)
        assert rel_err(to_np(got["chunkwise"]), to_np(alg)) <= 2.5e-2


@pytest.mark.cuda
def test_cuda_scan_launches_are_counted_and_limits_raise():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q = torch.zeros((1, 2, 1, 48), device="cuda")
    g = torch.zeros((1, 2, 1), device="cuda")
    with pytest.raises(ValueError, match="multiple of 32 up to 512"):
        mlstm_ops.mlstm_scan(q, q, q, g, g)
    before = mlstm_ops.launches
    q = torch.zeros((1, 2, 1, 32), device="cuda")
    mlstm_ops.mlstm_scan(q, q, q, g, g)
    assert mlstm_ops.launches == before + 1
    mlstm_ops.mlstm_scan(q, q, q, g, g, impl="ref")
    assert mlstm_ops.launches == before + 1


@pytest.mark.cuda
def test_cuda_slstm_designs_at_the_served_width():
    """The sLSTM at d 768 in 4 heads, T 129: bf16 on the tensor-core
    cluster kernel, both dtypes on the L2 kernel, each within its
    tolerance of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(3)
    tol = {torch.float32: 5e-5, torch.bfloat16: 2.5e-2}
    for dtype in (torch.float32, torch.bfloat16):
        pre = torch.randn((2, 129, 4 * 768), generator=gen,
                          device="cuda").to(dtype)
        r = (torch.randn((4, 192, 768), generator=gen, device="cuda")
             * 192 ** -0.5).to(dtype)
        want = slstm_ops.slstm_scan(pre, r, impl="ref")
        for plan in (slstm_ops.launch_plan(768, 4, dtype),
                     slstm_ops.Plan("l2")):
            before = slstm_ops.launches
            got = slstm_ops.launch(pre, r, plan)
            torch.cuda.synchronize()
            assert slstm_ops.launches == before + 1
            assert rel_err(to_np(got), to_np(want)) <= tol[dtype]
