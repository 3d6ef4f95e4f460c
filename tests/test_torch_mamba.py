"""The port's Mamba path held to the JAX package on the CPU: the block's
pieces (softplus, the causal conv), ``mamba_forward`` and
``mamba_decode`` on carried-over parameters, and whole prefill + decode
runs of the reduced Jamba with dense FFNs (its MoE layer is not ported)
through ``serve.generate``.

Tolerances (``rel_err`` = max abs difference over max abs reference), as
in ``tests/test_torch_serve.py``: 1e-3 in f32 (summation order, and the
bf16 caches), 3e-2 in bf16 (bf16 rounds after every op in both packages,
not always at the same places); bf16 cache entries at one bf16 ulp
(2**-7) in f32 runs, and the served Jamba's SSM states in f32 too, since
the conv tail that feeds them is bf16.  The port's bf16 served Jamba is
also held to the reference's f32 run at the reference's own widest bar,
5e-2 (``tests/test_arch_smoke.py``).

The reference's prefill hands every Mamba cache back unchanged
(``repro.models.transformer``: "recompute final state cheaply is
skipped"), so decode starts each Mamba layer from a zero state while the
attention layer holds the prompt's keys and values.  The port follows
it; the runs below pin that, and the decode-from-scratch test holds
stepped decode to the reference's whole-sequence forward, as
``tests/test_arch_smoke.py`` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import mamba as JMB
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.configs.jamba15_large_398b import ONE_CHIP
from repro_torch.launch import serve
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

JAMBA = "jamba-1.5-large-398b"
TOL = {"f32": 1e-3, "bf16": 3e-2}
CACHE_TOL = 2.0 ** -7
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def to_np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def torch_like(a) -> torch.Tensor:
    """A reference leaf as a torch tensor of the same dtype, bit for bit
    (bf16 and f32 both pass exactly through f32)."""
    a = np.asarray(a)
    td = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    return torch.from_numpy(a.astype(np.float32)).to(td)


def dense_jamba(jax_side: bool):
    """The reduced Jamba with its experts cut, on either side."""
    cfg = (j_get_arch if jax_side else get_arch)(JAMBA).reduced()
    return dataclasses.replace(cfg, n_experts=0, top_k=0)


def mamba_params(dt: str, d_model: int = 32, state: int = 8):
    p = JMB.mamba_init(jax.random.PRNGKey(5), d_model, state=state)
    if dt == "f32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    else:                 # bf16 as shipped; randomise the f32 leaves too
        rng = np.random.default_rng(5)
        p = dict(p, dt_bias=jnp.asarray(
            rng.standard_normal(p["dt_bias"].shape) * 0.5, jnp.float32),
            d_skip=jnp.asarray(
                1 + 0.1 * rng.standard_normal(p["d_skip"].shape),
                jnp.float32))
    return p, {k: torch_like(v) for k, v in p.items()}


# --------------------------------------------------------------------- #
# the block's pieces
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_softplus_is_jax_logaddexp_form(dt):
    """``jax.nn.softplus`` (logaddexp(x, 0)), on both sides of
    ``torch.nn.functional.softplus``'s threshold of 20 and far out."""
    jd, td = DT[dt]
    x = np.array([-120.0, -30.0, -5.0, -0.3, 0.0, 0.7, 5.0, 19.5, 20.0,
                  20.5, 35.0, 300.0], np.float32)
    got = TMB.softplus(torch.from_numpy(x).to(td))
    assert got.dtype == td
    want = jax.nn.softplus(jnp.asarray(x, jd))
    err = np.abs(to_np(got) - np.asarray(want, np.float32))
    # f32 to rounding; bf16 to one ulp of the result
    scale = np.abs(np.asarray(want, np.float32))
    assert np.all(err <= scale * (2e-7 if dt == "f32" else 2.0 ** -8)
                  + 1e-30)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_causal_conv_matches_the_reference(dt):
    jd, td = DT[dt]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = (0.1 * rng.standard_normal((4, 24))).astype(np.float32)
    got = TMB._causal_conv(torch.from_numpy(x).to(td),
                           torch.from_numpy(w).to(td))
    want = JMB._causal_conv(jnp.asarray(x, jd), jnp.asarray(w, jd))
    assert got.dtype == td
    assert rel_err(to_np(got), want) <= (1e-6 if dt == "f32" else
                                         TOL["bf16"])


def test_mamba_init_shapes_and_constants():
    gen = torch.Generator().manual_seed(0)
    p = TMB.mamba_init(gen, 64, state=16, device="cpu")
    want = JMB.mamba_init(jax.random.PRNGKey(0), 64, state=16)
    assert set(p) == set(want)
    for k, v in want.items():
        assert tuple(p[k].shape) == v.shape, k
        assert str(p[k].dtype).split(".")[1] == str(v.dtype), k
    for k in ("dt_bias", "d_skip"):               # deterministic leaves
        assert np.array_equal(to_np(p[k]), np.asarray(want[k]))
    # log(1..N): the two libraries' f32 log may differ in the last bit
    assert np.allclose(to_np(p["a_log"]), np.asarray(want["a_log"]),
                       rtol=2e-7, atol=0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mamba_forward_matches_the_reference(dt):
    jd, td = DT[dt]
    jp, tp = mamba_params(dt)
    x = np.random.default_rng(3).standard_normal((2, 12, 32))
    want = JMB.mamba_forward(jp, jnp.asarray(x, jd), state=8)
    got = TMB.mamba_forward(tp, torch.from_numpy(x).to(td), state=8)
    assert got.dtype == td
    assert rel_err(to_np(got), want) <= TOL[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mamba_decode_matches_the_reference(dt):
    """Three decode steps from a random cache: the output and both cache
    parts each step (the port's cache is updated in place)."""
    jd, td = DT[dt]
    jp, tp = mamba_params(dt)
    rng = np.random.default_rng(4)
    conv = rng.standard_normal((2, 3, 64)).astype(np.float32)
    ssm = rng.standard_normal((2, 64, 8)).astype(np.float32)
    jc = {"conv": jnp.asarray(conv, jnp.bfloat16), "ssm": jnp.asarray(ssm)}
    tc = {"conv": torch.from_numpy(conv).bfloat16(),
          "ssm": torch.from_numpy(ssm.copy())}
    for _ in range(3):
        x = rng.standard_normal((2, 32))
        jo, jc = JMB.mamba_decode(jp, jnp.asarray(x, jd), jc, state=8)
        to, out = TMB.mamba_decode(tp, torch.from_numpy(x).to(td), tc,
                                   state=8)
        assert out is tc and to.dtype == td
        assert rel_err(to_np(to), jo) <= TOL[dt]
        assert tc["conv"].dtype == torch.bfloat16
        assert rel_err(to_np(tc["conv"]), jc["conv"]) <= (
            CACHE_TOL if dt == "f32" else TOL[dt])
        assert rel_err(to_np(tc["ssm"]), jc["ssm"]) <= TOL[dt]


# --------------------------------------------------------------------- #
# the reduced Jamba, served
# --------------------------------------------------------------------- #
def test_jamba_params_round_trip_bit_for_bit():
    jcfg, tcfg = dense_jamba(True), dense_jamba(False)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(3),
                                                   jcfg))
    model = TT.params_from_numpy(tcfg, tree, device="cpu")
    assert [b.kind for b in model.blocks] == list(tcfg.pattern)
    assert model.blocks[0].mixer["a_log"].dtype == torch.float32
    back = TT.params_to_numpy(model, bf16_dtype=tree["embed"].dtype)
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_param_count_of_the_one_card_cut_equals_the_reference():
    jcfg = dataclasses.replace(j_get_arch(JAMBA), n_layers=8, n_experts=0,
                               top_k=0)
    assert dataclasses.asdict(ONE_CHIP) == dict(
        dataclasses.asdict(jcfg), source=ONE_CHIP.source)
    assert TM.param_count(ONE_CHIP) == JM.param_count(jcfg) == 8_462_049_280
    assert TT.cache_slots(ONE_CHIP) == [
        ("mamba", 0), ("mamba", 1), ("mamba", 2), ("attn", 0),
        ("mamba", 3), ("mamba", 4), ("mamba", 5), ("mamba", 6)]


B, P, N_DECODE = 2, 16, 5          # prefill + 4 decode steps


def _reference_run(jcfg, params, prompts, decode_impl):
    caches = JT.init_caches(jcfg, B, P + N_DECODE)
    logits, caches = jax.jit(JM.make_prefill_step(jcfg))(params, prompts,
                                                         caches)
    decode = jax.jit(JM.make_decode_step(jcfg, attn_impl=decode_impl))
    tokens = [jnp.argmax(logits[:, :jcfg.vocab], axis=-1).astype(jnp.int32)]
    all_logits = [logits]
    for i in range(N_DECODE - 1):
        pos = jnp.full((B,), P + i, jnp.int32)
        logits, caches = decode(params, tokens[-1], caches, pos)
        tokens.append(jnp.argmax(logits[:, :jcfg.vocab],
                                 axis=-1).astype(jnp.int32))
        all_logits.append(logits)
    return (np.stack([np.asarray(t) for t in tokens], axis=1),
            [np.asarray(lg) for lg in all_logits], caches)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_jamba_serve_matches_the_reference(dt):
    """Prefill + 4 teacher-forced decode steps of the reduced dense Jamba
    (7 Mamba layers, attention at slot 3): every step's logits and the
    final KV and Mamba caches.  As in ``tests/test_torch_serve.py``, f32
    runs are held to JAX's Pallas decode attention and bf16 runs to its
    default."""
    jcfg, tcfg = dense_jamba(True), dense_jamba(False)
    jd, td = DT[dt]
    params = JT.init_params(jax.random.PRNGKey(7), jcfg)
    if dt == "f32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    prompts = serve.make_prompts(tcfg, B, P, seed=7)
    tokens, logits, caches = _reference_run(
        jcfg, params, jnp.asarray(prompts, jnp.int32),
        "pallas" if dt == "f32" else "xla")

    model = TT.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    assert model.embed.dtype == td
    # prefill alone leaves every Mamba cache as it was: zero
    alone = serve.generate(model, tcfg, torch.from_numpy(prompts), 1)
    assert not alone["caches"]["conv"].any()
    assert not alone["caches"]["ssm"].any()
    assert alone["caches"]["k"].any()
    run = serve.generate(model, tcfg, torch.from_numpy(prompts), N_DECODE,
                         forced=torch.from_numpy(tokens).long())
    assert run["launches"]["prefill"]["ssm_scan"] == 0    # the CPU path
    tol = TOL[dt]
    for i, (got, want) in enumerate(zip(run["logits"], logits)):
        assert got.dtype == torch.float32
        err = rel_err(to_np(got)[:, :tcfg.vocab], want[:, :tcfg.vocab])
        assert err <= tol, f"step {i}: rel err {err}"
    if dt == "f32":
        assert np.array_equal(run["tokens"].numpy(), tokens)
    want = jax.tree.map(np.asarray, caches)
    bf16 = want["slots"][3]["kv"]["k"].dtype
    ours = TT.caches_to_numpy(tcfg, run["caches"], bf16_dtype=bf16)
    assert jax.tree.structure(ours) == jax.tree.structure(want)
    for (path, got), ref in zip(jax.tree.flatten_with_path(ours)[0],
                                jax.tree.leaves(want)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        # f32: a bf16 cache entry, or an SSM state fed by the bf16 conv
        # tail, may sit one bf16 ulp away
        limit = CACHE_TOL if dt == "f32" else TOL["bf16"]
        assert rel_err(got, ref) <= limit, path


def test_jamba_decode_from_scratch_matches_the_reference_forward():
    """Four decode steps from empty caches against the reference's
    whole-sequence forward at position 3 -- ``tests/test_arch_smoke.py``'s
    check for the recurrent families, here in f32 and at 1e-2 (the
    reference's own decode measures 4.8e-3 against it: the KV cache and
    the conv tail round decode's inputs to bf16, the forward does not)."""
    jcfg, tcfg = dense_jamba(True), dense_jamba(False)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          JT.init_params(jax.random.PRNGKey(1), jcfg))
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
    assert rel_err(to_np(logits), np.asarray(want)[:, 3]) < 1e-2


def test_jamba_bf16_serve_is_within_the_reference_bar_of_its_f32_run():
    """The port's bf16 run of the reduced dense Jamba against the
    reference's f32 run of the same parameters and prompts (teacher-forced
    with the f32 run's tokens): every step's logits and the final KV and
    Mamba caches at the reference's own widest model-level bar, 5e-2
    (``tests/test_arch_smoke.py``)."""
    jcfg, tcfg = dense_jamba(True), dense_jamba(False)
    params = JT.init_params(jax.random.PRNGKey(7), jcfg)
    prompts = serve.make_prompts(tcfg, B, P, seed=7)
    tokens, logits, caches = _reference_run(
        jcfg, jax.tree.map(lambda a: a.astype(jnp.float32), params),
        jnp.asarray(prompts, jnp.int32), "pallas")
    model = TT.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    assert model.embed.dtype == torch.bfloat16
    run = serve.generate(model, tcfg, torch.from_numpy(prompts), N_DECODE,
                         forced=torch.from_numpy(tokens).long())
    for i, (got, want) in enumerate(zip(run["logits"], logits)):
        err = rel_err(to_np(got)[:, :tcfg.vocab], want[:, :tcfg.vocab])
        assert err <= 5e-2, f"step {i}: rel err {err}"
    want = jax.tree.map(np.asarray, caches)
    ours = TT.caches_to_numpy(tcfg, run["caches"],
                              bf16_dtype=want["slots"][3]["kv"]["k"].dtype)
    for (path, got), ref in zip(jax.tree.flatten_with_path(ours)[0],
                                jax.tree.leaves(want)):
        assert got.shape == ref.shape, path
        assert rel_err(got, ref) <= 5e-2, path
