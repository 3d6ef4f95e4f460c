"""The port's serving path held to the JAX reference on the CPU: configs,
layers one by one, attention layers over the cache, and whole prefill +
decode runs of the reduced dense models with the reference's parameters
carried across by ``params_from_numpy``.

Tolerances (``rel_err`` = max abs difference over max abs reference):

* f32 (parameters cast to f32 in both packages): 1e-3 -- the two
  frameworks sum products in different orders (~1e-6 on the logits), and
  the KV cache is bf16 in both, so a cached key or value that rounds to
  the neighbouring bf16 number moves later decode steps by ~1e-4; cached
  keys/values are compared at one bf16 ulp (2**-7);
* bf16 as shipped: 3e-2 -- bf16 rounds after every op in both packages,
  but not always at the same places (fused vs unfused elementwise
  chains), which moves a few logits by an ulp or two per layer.

The reference's decode defaults to ``attn_impl="xla"``, which rounds the
softmax probabilities to bf16 before P.V; the port computes them in f32
like the Pallas kernel.  So f32 runs are held to JAX's ``"pallas"``
decode (interpret mode) and bf16 runs to its default.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import list_archs as j_list_archs
from repro.configs.base import SHAPES as J_SHAPES
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

DENSE = ("granite-3-8b", "phi3-mini-3.8b", "codeqwen1.5-7b", "minitron-8b")
TOL = {"f32": 1e-3, "bf16": 3e-2}
CACHE_TOL = 2.0 ** -7


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def to_np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def jnp_from(a: np.ndarray, dtype):
    return jnp.asarray(a, dtype)


def torch_from(a: np.ndarray, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


# --------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------- #
def test_every_config_field_equals_the_reference():
    assert list_archs() == j_list_archs()
    for name in list_archs():
        for ours, theirs in ((get_arch(name), j_get_arch(name)),
                             (get_arch(name).reduced(),
                              j_get_arch(name).reduced())):
            assert (dataclasses.asdict(ours)
                    == dataclasses.asdict(theirs)), name
            assert ours.padded_vocab == theirs.padded_vocab
            assert ours.resolved_head_dim == theirs.resolved_head_dim
            assert ours.layer_kinds() == theirs.layer_kinds()
    assert ({k: dataclasses.asdict(v) for k, v in SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()})
    for name in list_archs():            # the layer pattern bookkeeping
        assert TT.slot_kinds(get_arch(name)) == JT.slot_kinds(
            j_get_arch(name))
        assert TT.n_scan_reps(get_arch(name)) == JT.n_scan_reps(
            j_get_arch(name))


@pytest.mark.parametrize("name", DENSE)
def test_param_count_on_meta_equals_the_reference(name):
    assert TM.param_count(get_arch(name)) == JM.param_count(
        j_get_arch(name))
    if name == "granite-3-8b":
        assert TM.param_count(get_arch(name)) == 8_171_884_544


# --------------------------------------------------------------------- #
# layers one by one
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layers_match_the_reference(dt):
    jd, td = DT[dt]
    tol = TOL[dt]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = jnp_from(x, jd), torch_from(x, td)
    assert rel_err(to_np(TL.rmsnorm(tx, torch_from(w, td))),
                   JL.rmsnorm(jx, jnp_from(w, jd))) <= tol
    assert rel_err(to_np(TL.layernorm(tx, torch_from(w, td),
                                      torch_from(b, td))),
                   JL.layernorm(jx, {"w": jnp_from(w, jd),
                                     "b": jnp_from(b, jd)})) <= tol
    # RoPE: prefill positions (S,) on (B, H, S, D); decode (B, 1, 1)
    q = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    pos = np.arange(5)
    assert rel_err(to_np(TL.apply_rope(torch_from(q, td),
                                       torch.from_numpy(pos), 500.0)),
                   JL.apply_rope(jnp_from(q, jd), jnp.asarray(pos),
                                 500.0)) <= tol
    q1 = q[:, :, :1]
    pb = np.array([3, 9])[:, None, None]
    assert rel_err(to_np(TL.apply_rope(torch_from(q1, td),
                                       torch.from_numpy(pb))),
                   JL.apply_rope(jnp_from(q1, jd), jnp.asarray(pb))) <= tol
    p = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in
         (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)),
          ("w_in", (64, 96)), ("w_out", (96, 64)))}
    jp = {k: jnp_from(v, jd) for k, v in p.items()}
    tp = {k: torch_from(v, td) for k, v in p.items()}
    assert rel_err(to_np(TL.swiglu(tx, tp)), JL.swiglu(jx, jp)) <= tol
    assert rel_err(to_np(TL.gelu_mlp(tx, tp)), JL.gelu_mlp(jx, jp)) <= tol
    table = rng.standard_normal((40, 64)).astype(np.float32)
    tok = np.array([[0, 39, 7], [5, 5, 1]])
    assert np.array_equal(
        to_np(TL.embed(torch.from_numpy(tok), torch_from(table, td))),
        np.asarray(JL.embed(jnp.asarray(tok), jnp_from(table, jd)),
                   np.float32))
    got = TL.unembed(tx, torch_from(table, td))
    want = JL.unembed(jx, jnp_from(table, jd))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert rel_err(to_np(got), want) <= 1e-5


def test_rope_frequencies_and_init_shapes():
    assert np.allclose(to_np(TL.rope_frequencies(16, 1e6)),
                       np.asarray(JL.rope_frequencies(16, 1e6)), rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    w = TL.dense_init(gen, 256, 512, device="cpu", dtype=torch.float32)
    assert w.shape == (256, 512)
    assert abs(float(w.std()) - 256 ** -0.5) < 3e-3
    e = TL.embedding_init(gen, 300, 64, device="cpu")
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std())
                                             - 0.02) < 2e-3


def _attn_params(rng, d, hq, hkv, hd):
    return {"wq": (rng.standard_normal((d, hq * hd)) / d ** 0.5),
            "wk": (rng.standard_normal((d, hkv * hd)) / d ** 0.5),
            "wv": (rng.standard_normal((d, hkv * hd)) / d ** 0.5),
            "wo": (rng.standard_normal((hq * hd, d)) / (hq * hd) ** 0.5)}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_attention_layers_over_the_cache(dt, hq, hkv):
    """attn_prefill then two attn_decode steps, each against the
    reference's (Pallas-interpret decode), cache included."""
    jd, td = DT[dt]
    tol = TOL[dt]
    rng = np.random.default_rng(hq * 10 + hkv)
    b, s, d, hd, max_seq = 2, 12, 32, 16, 16
    dims = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd, rope_theta=1e4)
    p = _attn_params(rng, d, hq, hkv, hd)
    jp = {k: jnp_from(v, jd) for k, v in p.items()}
    tp = {k: torch_from(v, td) for k, v in p.items()}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    jc = JA.init_kv_cache(b, max_seq, hkv, hd)
    tc = TA.init_kv_cache(b, max_seq, hkv, hd, device="cpu")
    jo, jc = JA.attn_prefill(jp, jnp_from(x, jd), jc, **dims)
    to, tc = TA.attn_prefill(tp, torch_from(x, td), tc, **dims)
    assert to.dtype == td
    assert rel_err(to_np(to), jo) <= tol
    for name in ("k", "v"):
        assert rel_err(to_np(tc[name]), jc[name]) <= CACHE_TOL
    for step in range(2):
        xt = rng.standard_normal((b, d)).astype(np.float32)
        pos = np.array([s + step, s - 3 + 2 * step], np.int32)
        jo, jc = JA.attn_decode(jp, jnp_from(xt, jd), jc,
                                jnp.asarray(pos), impl="pallas", **dims)
        to, tc = TA.attn_decode(tp, torch_from(xt, td), tc,
                                torch.from_numpy(pos), **dims)
        assert rel_err(to_np(to), jo) <= tol
        for name in ("k", "v"):
            assert rel_err(to_np(tc[name]), jc[name]) <= CACHE_TOL


@pytest.mark.parametrize("causal,rope", [(True, True), (False, False)])
def test_attn_forward_matches_the_reference(causal, rope):
    rng = np.random.default_rng(8)
    b, s, d, hq, hkv, hd = 2, 10, 32, 8, 2, 16
    dims = dict(n_heads=hq, n_kv_heads=hkv, head_dim=hd, rope_theta=1e4,
                causal=causal, use_rope=rope)
    p = _attn_params(rng, d, hq, hkv, hd)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    positions = np.arange(3, 3 + s)
    want = JA.attn_forward({k: jnp.asarray(v, jnp.float32)
                            for k, v in p.items()}, jnp.asarray(x),
                           positions=jnp.asarray(positions), **dims)
    got = TA.attn_forward({k: torch_from(v, torch.float32)
                           for k, v in p.items()}, torch.from_numpy(x),
                          positions=torch.from_numpy(positions), **dims)
    assert rel_err(to_np(got), want) <= 1e-5


def test_cache_append_drops_out_of_range_positions():
    b, s, hkv, hd = 3, 6, 2, 4
    rng = np.random.default_rng(3)
    k0 = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v0 = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    kn = rng.standard_normal((b, hkv, hd)).astype(np.float32)
    vn = rng.standard_normal((b, hkv, hd)).astype(np.float32)
    pos = np.array([2, s, s + 5], np.int32)      # one write, two drops
    jc = JA.cache_append({"k": jnp.asarray(k0, jnp.bfloat16),
                          "v": jnp.asarray(v0, jnp.bfloat16)},
                         jnp.asarray(kn), jnp.asarray(vn),
                         jnp.asarray(pos))
    tc = {"k": torch_from(k0, torch.bfloat16),
          "v": torch_from(v0, torch.bfloat16)}
    before = {k: v.clone() for k, v in tc.items()}
    out = TA.cache_append(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                          torch.from_numpy(pos))
    assert out is tc                                  # in place
    for name in ("k", "v"):
        assert np.array_equal(to_np(tc[name]),
                              np.asarray(jc[name], np.float32))
        assert torch.equal(tc[name][1:], before[name][1:])


# --------------------------------------------------------------------- #
# carry-over
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["granite-3-8b", "minitron-8b"])
def test_params_round_trip_bit_for_bit(name):
    jcfg = j_get_arch(name).reduced()
    jparams = JT.init_params(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = TT.params_from_numpy(get_arch(name).reduced(), tree,
                                 device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert len(model.blocks) == jcfg.n_layers
    back = TT.params_to_numpy(model, bf16_dtype=tree["embed"].dtype)
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint16), b.view(np.uint16))


# --------------------------------------------------------------------- #
# whole prefill + decode runs
# --------------------------------------------------------------------- #
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


CASES = [(name, None) for name in DENSE] + [("granite-3-8b", 2)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name,kv", CASES,
                         ids=[n if kv is None else f"{n}-kv{kv}"
                              for n, kv in CASES])
def test_serve_matches_the_reference(name, kv, dt):
    jcfg, tcfg = j_get_arch(name).reduced(), get_arch(name).reduced()
    if kv is not None:              # GQA: 4 query heads over 2 KV heads
        jcfg = dataclasses.replace(jcfg, n_kv_heads=kv)
        tcfg = dataclasses.replace(tcfg, n_kv_heads=kv)
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
    run = serve.generate(model, tcfg, torch.from_numpy(prompts), N_DECODE,
                         forced=torch.from_numpy(tokens).long())
    assert len(run["logits"]) == N_DECODE
    for i, (got, want) in enumerate(zip(run["logits"], logits)):
        assert got.dtype == torch.float32
        # the padded tail is masked in both
        assert np.array_equal(to_np(got)[:, tcfg.vocab:],
                              want[:, tcfg.vocab:])
        err = rel_err(to_np(got)[:, :tcfg.vocab], want[:, :tcfg.vocab])
        assert err <= TOL[dt], f"step {i}: rel err {err}"
    if dt == "f32":
        assert np.array_equal(run["tokens"].numpy(), tokens)
    want = jax.tree.map(np.asarray, caches)
    ours = TT.caches_to_numpy(tcfg, run["caches"], bf16_dtype=want[
        "slots"][0]["kv"]["k"].dtype)
    for name_kv in ("k", "v"):
        got = ours["slots"][0]["kv"][name_kv]
        ref = want["slots"][0]["kv"][name_kv]
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert rel_err(got, ref) <= (CACHE_TOL if dt == "f32" else TOL[dt])


def test_serve_cli_runs_on_the_cpu(capsys):
    run = serve.main(["--arch", "granite-3-8b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "8",
                      "--decode-tokens", "3"])
    out = capsys.readouterr().out
    assert "[serve] granite-3-8b" in out and "ms/token" in out
    assert run["tokens"].shape == (2, 3)
    assert (run["tokens"] >= 0).all() and (run["tokens"] < 512).all()
    assert run["caches"]["k"].shape == (2, 2, 11, 4, 16)
    # the CPU wrappers ran the plain versions: no kernel launch counted
    assert run["launches"] == {
        "prefill": {"flash_attention": 0, "decode_attention": 0,
                    "ssm_scan": 0, "mlstm_scan": 0, "slstm_scan": 0},
        "decode": {"flash_attention": 0, "decode_attention": 0,
                   "ssm_scan": 0, "mlstm_scan": 0, "slstm_scan": 0}}
    # the plain attention path gives the same run on the CPU
    again = serve.generate(run["model"], run["cfg"], run["prompts"], 3,
                           attn_impl="ref")
    assert torch.equal(again["tokens"], run["tokens"])
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", "granite-3-8b", "--reduced"])
