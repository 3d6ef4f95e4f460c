"""Cross-attention and the encoder of the port held to the JAX reference on
the CPU: the cross layer's functions (``cross_forward``, ``cross_decode``,
``memory_kv``) at a memory of 16 rows and a ragged one of 37, the
encoder, whole prefill + 3 decode steps of the reduced
llama-3.2-vision-11b (and a GQA variant of it) and seamless-m4t-medium
with the reference's parameters carried across by ``params_from_numpy``,
the parameter round trip, ``param_count`` of the published configs and
the serve CLI's inputs.

Tolerances are ``tests/test_torch_serve.py``'s: f32 1e-3, bf16 3e-2, and
cached bf16 keys/values one bf16 ulp (2**-7) in f32 runs.  The memory is
bf16 as the reference CLI draws it, so an f32 run also holds the port's
``bf16 @ f32`` promotion (memory K/V in f32) to ``jnp``'s -- except
where an encoder reads it: the reference's encoder scan refuses a carry
whose dtype the first layer changes, so its f32 runs take the same
memory in f32.

The reference runs under ``jax.jit``, as it is served.  Its f32 decode is
its Pallas kernel in interpret mode and its bf16 decode its default
(``"xla"``), as in ``tests/test_torch_serve.py``.  Its ``"chunked"`` and
``"pallas"`` decode raise at a memory that ``min(1024, M)`` or
``min(512, M)`` rows do not divide; every M here is below 512, so both
take it whole.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import list_archs as j_list_archs
from repro.configs.base import SHAPES as J_SHAPES
from repro.launch import serve as j_serve
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import serve
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

VISION, SEAMLESS = "llama-3.2-vision-11b", "seamless-m4t-medium"
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


def memory_of(rng, b, m, d, dt="bf16"):
    """A memory as the reference CLI draws it (bf16), in both packages,
    cast to ``dt``."""
    mem = torch.from_numpy(rng.standard_normal((b, m, d)) * 0.1).to(
        torch.bfloat16).to(DT[dt][1])
    return jnp.asarray(mem.float().numpy(), DT[dt][0]), mem


# --------------------------------------------------------------------- #
# the cross layer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m", [16, 37])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_cross_layer_matches_the_reference(dt, m, hq, hkv):
    """``memory_kv``, ``cross_forward`` and ``cross_decode`` (with and
    without a lengths buffer) against ``repro.models.attention``, over a
    bf16 memory; ``cross_prefill`` writes the same K/V in place."""
    jd, td = DT[dt]
    rng = np.random.default_rng(m + 10 * hq + hkv)
    b, s, d, hd = 2, 9, 32, 16
    dims = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd)
    p = {"wq": rng.standard_normal((d, hq * hd)) / d ** 0.5,
         "wk": rng.standard_normal((d, hkv * hd)) / d ** 0.5,
         "wv": rng.standard_normal((d, hkv * hd)) / d ** 0.5,
         "wo": rng.standard_normal((hq * hd, d)) / (hq * hd) ** 0.5}
    jp = {k: jnp.asarray(v, jd) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(td) for k, v in p.items()}
    jmem, tmem = memory_of(rng, b, m, d)
    x = rng.standard_normal((b, s, d))
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)

    jkv = JA.memory_kv(jp, jmem, n_kv_heads=hkv, head_dim=hd)
    tkv = TA.memory_kv(tp, tmem, n_kv_heads=hkv, head_dim=hd)
    for name in ("k", "v"):
        assert tkv[name].dtype == td and jkv[name].dtype == jd
        assert tkv[name].shape == (b, m, hkv, hd)
        assert rel_err(to_np(tkv[name]), jkv[name]) <= TOL[dt]

    want = jax.jit(lambda p_, x_, m_: JA.cross_forward(p_, x_, m_, **dims))(
        jp, jx, jmem)
    got = TA.cross_forward(tp, tx, tmem, **dims)
    assert got.dtype == td and rel_err(to_np(got), want) <= TOL[dt]
    cache = {n: torch.zeros((b, m, hkv, hd), dtype=td) for n in ("k", "v")}
    again, cache = TA.cross_prefill(tp, tx, tmem, cache, **dims)
    assert torch.equal(again, got)
    for name in ("k", "v"):
        assert torch.equal(cache[name], tkv[name])

    xt = rng.standard_normal((b, d))
    want = jax.jit(lambda p_, x_, kv_: JA.cross_decode(
        p_, x_, kv_, impl="pallas", **dims))(jp, jnp.asarray(xt, jd), jkv)
    lengths = torch.full((b,), m, dtype=torch.int32)
    for lens in (None, lengths):
        got = TA.cross_decode(tp, torch.from_numpy(xt).to(td), tkv,
                              lengths=lens, **dims)
        assert got.dtype == td and rel_err(to_np(got), want) <= TOL[dt]


def test_cross_prefill_refuses_a_cache_that_would_round():
    """The reference replaces its bf16 memory caches with the projection's
    output: an f32 projection into a bf16 cache would round it."""
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy(rng.standard_normal(s)).float() for k, s in
         (("wq", (8, 8)), ("wk", (8, 8)), ("wv", (8, 8)), ("wo", (8, 8)))}
    cache = {n: torch.zeros((1, 3, 2, 4), dtype=torch.bfloat16)
             for n in ("k", "v")}
    with pytest.raises(TypeError, match="round"):
        TA.cross_prefill(p, torch.zeros((1, 2, 8)), torch.zeros((1, 3, 8)),
                         cache, n_heads=2, n_kv_heads=2, head_dim=4)


# --------------------------------------------------------------------- #
# configs: parameters, memory length
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,n", [(VISION, 9_585_397_760),
                                    (SEAMLESS, 614_854_656)])
def test_param_count_of_the_published_configs(name, n):
    assert TM.param_count(get_arch(name)) == JM.param_count(
        j_get_arch(name)) == n


def test_memory_len_equals_the_reference():
    assert list_archs() == j_list_archs()
    for name in list_archs():
        for cell in SHAPES:
            assert TM.memory_len(get_arch(name), SHAPES[cell]) == (
                JM.memory_len(j_get_arch(name), J_SHAPES[cell]))
    assert TM.memory_len(get_arch(VISION), SHAPES["train_4k"]) == 1601
    assert TM.memory_len(get_arch(SEAMLESS), SHAPES["train_4k"]) == 1024


def _variant(name: str, ref: bool):
    get = j_get_arch if ref else get_arch
    if name == "vision-kv2":          # GQA: 4 query heads over 2 KV heads
        return dataclasses.replace(get(VISION).reduced(), n_kv_heads=2)
    return get(name).reduced()


@pytest.mark.parametrize("name", [VISION, SEAMLESS])
def test_cross_params_round_trip_bit_for_bit(name):
    jcfg, tcfg = _variant(name, True), _variant(name, False)
    tree = jax.tree.map(np.asarray,
                        JT.init_params(jax.random.PRNGKey(3), jcfg))
    model = TT.params_from_numpy(tcfg, tree, device="cpu")
    assert len(model.blocks) == jcfg.n_layers
    assert len(model.encoder) == jcfg.encoder_layers
    assert [b.cross is not None for b in model.blocks] == [
        k == "cross" for k in jcfg.layer_kinds()]
    back = TT.params_to_numpy(model, bf16_dtype=tree["embed"].dtype)
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint16), b.view(np.uint16))
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in flat_a) == TM.param_count(tcfg)


# --------------------------------------------------------------------- #
# the encoder and whole runs
# --------------------------------------------------------------------- #
def _params(jcfg, dt):
    params = JT.init_params(jax.random.PRNGKey(7), jcfg)
    if dt == "f32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_encode_matches_the_reference(dt):
    """The seamless encoder (bidirectional self-attention with RoPE, then
    ``enc_norm``) over a memory in the weights' dtype, against the
    compiled reference."""
    jcfg, tcfg = _variant(SEAMLESS, True), _variant(SEAMLESS, False)
    params = _params(jcfg, dt)
    jmem, tmem = memory_of(np.random.default_rng(5), 2, 37, tcfg.d_model,
                           dt)
    want = jax.jit(lambda p_, m_: JT.encode(p_, jcfg, m_))(params, jmem)
    model = TT.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    got = TT.encode(model, tcfg, tmem)
    assert got.dtype == DT[dt][1] and want.dtype == DT[dt][0]
    assert rel_err(to_np(got), want) <= TOL[dt]


B, P, N_DECODE = 2, 16, 4          # prefill + 3 decode steps


def _reference_run(jcfg, params, prompts, memory, decode_impl):
    caches = JT.init_caches(jcfg, B, P + N_DECODE,
                            memory_len=memory.shape[1])
    logits, caches = jax.jit(JM.make_prefill_step(jcfg))(params, prompts,
                                                         caches, memory)
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


SERVE_CASES = [(VISION, 16), ("vision-kv2", 37), (SEAMLESS, 16),
               (SEAMLESS, 37)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name,m", SERVE_CASES,
                         ids=[f"{n}-M{m}" for n, m in SERVE_CASES])
def test_cross_serve_matches_the_reference(name, m, dt):
    """Prefill + 3 teacher-forced decode steps with a memory of ``m``
    rows (bf16; in the weights' dtype where an encoder reads it): every
    step's logits, the final KV caches and the memory K/V in the
    reference's ``caches["memory_kv"]`` layout."""
    jcfg, tcfg = _variant(name, True), _variant(name, False)
    params = _params(jcfg, dt)
    prompts = serve.make_prompts(tcfg, B, P, seed=7)
    jmem, tmem = memory_of(np.random.default_rng(m), B, m, tcfg.d_model,
                           dt if tcfg.encoder_layers else "bf16")
    tokens, logits, caches = _reference_run(
        jcfg, params, jnp.asarray(prompts, jnp.int32), jmem,
        "pallas" if dt == "f32" else "xla")

    model = TT.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    run = serve.generate(model, tcfg, torch.from_numpy(prompts), N_DECODE,
                         memory=tmem, forced=torch.from_numpy(tokens).long())
    assert run["caches"]["memory_k"].dtype == DT[dt][1]
    assert run["caches"]["memory_len"].tolist() == [m] * B
    for i, (got, want) in enumerate(zip(run["logits"], logits)):
        assert got.dtype == torch.float32
        assert np.array_equal(to_np(got)[:, tcfg.vocab:],
                              want[:, tcfg.vocab:])
        err = rel_err(to_np(got)[:, :tcfg.vocab], want[:, :tcfg.vocab])
        assert err <= TOL[dt], f"step {i}: rel err {err}"
    if dt == "f32":
        assert np.array_equal(run["tokens"].numpy(), tokens)
    want = jax.tree.map(np.asarray, caches)
    bf16 = next(a.dtype for a in jax.tree.leaves(want)
                if a.dtype.name == "bfloat16")
    ours = TT.caches_to_numpy(tcfg, run["caches"], bf16_dtype=bf16)
    assert jax.tree.structure(ours) == jax.tree.structure(want)
    for (path, got), ref in zip(jax.tree.flatten_with_path(ours)[0],
                                jax.tree.leaves(want)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        limit = (TOL["bf16"] if dt == "bf16" else
                 CACHE_TOL if ref.dtype == bf16 else TOL["f32"])
        assert rel_err(got, ref) <= limit, path


def test_prefill_without_a_memory_raises():
    cfg = get_arch(VISION).reduced()
    model = serve.build(cfg, seed=0, device="cpu")
    caches = TT.init_caches(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="memory"):
        TT.forward_prefill(model, cfg, torch.zeros((1, 4), dtype=torch.long),
                           caches)


# --------------------------------------------------------------------- #
# the serve CLI
# --------------------------------------------------------------------- #
class _Drawn(Exception):
    pass


@pytest.mark.parametrize("name", [VISION, SEAMLESS])
def test_serve_cli_draws_the_reference_inputs(monkeypatch, capsys, name):
    """``serve.main`` at ``--reduced`` on the CPU: its prompts and memory
    bit for bit the reference CLI's (read off the reference's prefill
    call), both kernels' plain versions run, and the memory K/V cached."""
    argv = ["--arch", name, "--reduced", "--batch", "2", "--prompt-len",
            "8", "--decode-tokens", "3", "--seed", "4"]
    seen = {}

    def capture(cfg, *a, **k):
        def prefill(params, prompts, caches, memory=None):
            seen.update(prompts=np.asarray(prompts),
                        memory=np.asarray(memory))
            raise _Drawn
        return prefill
    monkeypatch.setattr(j_serve.MDL, "make_prefill_step", capture)
    monkeypatch.setattr(j_serve.jax, "jit", lambda f, **k: f)  # eager
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(_Drawn):
        j_serve.main()
    run = serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[serve] {name}" in out and "memory: (2, 16, 64)" in out
    assert np.array_equal(run["prompts"].numpy(), seen["prompts"])
    assert run["memory"].dtype == torch.bfloat16
    assert np.array_equal(run["memory"].view(torch.int16).numpy(),
                          seen["memory"].view(np.int16))
    assert run["tokens"].shape == (2, 3)
    assert run["caches"]["memory_k"].shape == (
        run["cfg"].pattern.count("cross") * TT.n_scan_reps(run["cfg"]), 2,
        16, run["cfg"].n_kv_heads, 16)
    assert run["launches"]["prefill"]["flash_attention"] == 0
    again = serve.generate(run["model"], run["cfg"], run["prompts"], 3,
                           memory=run["memory"], attn_impl="ref")
    assert torch.equal(again["tokens"], run["tokens"])


# --------------------------------------------------------------------- #
# rounding as the compiled reference rounds
# --------------------------------------------------------------------- #
def test_carry_rounds_at_every_repetition_of_a_looped_scan():
    assert TT.carry_rounds(0, 1, 3) == [True, True, True]
    assert TT.carry_rounds(1, 2, 2) == [False, True, False, True, False]
    # one repetition: XLA drops the one-trip loop and fuses across it
    assert TT.carry_rounds(0, 5, 1) == [False] * 5
    assert TT.carry_rounds(0, 1, 1) == [False]


EXACT_CASES = {
    # every layer boundary a step of the looped scan
    "granite-3-reps": ("granite-3-8b", 3, ("attn",)),
    # one step of three layers: no loop, nothing rounded between them
    "granite-1-rep": ("granite-3-8b", 3, ("attn",) * 3),
}


@pytest.mark.parametrize("name", list(EXACT_CASES))
def test_bf16_caches_bit_identical_to_the_compiled_reference(name):
    """In bf16 the stack rounds where the compiled reference does -- the
    f32 residual sum into each norm within a scan step, the rounded carry
    between steps -- so every cached key and value equals the reference's
    bit for bit (decode held to its Pallas kernel, whose f32 softmax the
    port's shares)."""
    arch, n_layers, pattern = EXACT_CASES[name]
    jcfg, tcfg = (dataclasses.replace(get(arch).reduced(), n_layers=n_layers,
                                      pattern=pattern)
                  for get in (j_get_arch, get_arch))
    params = _params(jcfg, "bf16")
    prompts = serve.make_prompts(tcfg, B, P, seed=7)
    caches = JT.init_caches(jcfg, B, P + N_DECODE)
    logits, caches = jax.jit(JM.make_prefill_step(jcfg))(
        params, jnp.asarray(prompts, jnp.int32), caches)
    decode = jax.jit(JM.make_decode_step(jcfg, attn_impl="pallas"))
    tokens = [jnp.argmax(logits[:, :jcfg.vocab], axis=-1).astype(jnp.int32)]
    for i in range(N_DECODE - 1):
        logits, caches = decode(params, tokens[-1], caches,
                                jnp.full((B,), P + i, jnp.int32))
        tokens.append(jnp.argmax(logits[:, :jcfg.vocab],
                                 axis=-1).astype(jnp.int32))
    forced = np.stack([np.asarray(t) for t in tokens], axis=1)

    model = TT.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    run = serve.generate(model, tcfg, torch.from_numpy(prompts), N_DECODE,
                         forced=torch.from_numpy(forced).long())
    want = jax.tree.map(np.asarray, caches)
    ours = TT.caches_to_numpy(tcfg, run["caches"],
                              bf16_dtype=want["slots"][0]["kv"]["k"].dtype)
    for (path, got), ref in zip(jax.tree.flatten_with_path(ours)[0],
                                jax.tree.leaves(want)):
        assert np.array_equal(got.view(np.uint16), ref.view(np.uint16)), (
            path)


def test_gelu_and_rope_frequencies_equal_the_compiled_reference():
    """``jax.nn.gelu`` compiled rounds every op to bf16 (the port's
    ``gelu``, bit for bit); the compiled reference folds ``1 /
    theta**x`` in f64 (the port's ``rope_frequencies``, bit for bit)."""
    x = np.random.default_rng(0).standard_normal(100_000) * 3
    want = jax.jit(jax.nn.gelu)(jnp.asarray(x, jnp.bfloat16))
    got = TL.gelu(torch.from_numpy(x).to(torch.bfloat16))
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))
    for d in (16, 64, 128):
        for theta in (1e4, 5e5, 1e6):
            want = jax.jit(lambda: JL.rope_frequencies(d, theta))()
            assert np.array_equal(TL.rope_frequencies(d, theta).numpy(),
                                  np.asarray(want))
