"""The port's multi-head latent attention held to the JAX reference on the
CPU, at the reduced deepseek-v2 (d 64, 4 heads, q_lora 32, kv_lora 32,
nope / rope / v head dims 16 / 8 / 16, so attention runs at head dim 24):
the layer's full form, prefill (output and both latent caches) and three
absorbed decode steps; the flash kernel's plain version at MLA's head dims;
the latent cache's layout; parameter counts at full size and at the
one-card cut; and the serving CLI.  The whole reduced model served against
the reference, and its parameter round trip, are ``SERVE_CASES`` of
``tests/test_torch_moe.py``.

Tolerances are ``tests/test_torch_serve.py``'s: rel err 1e-3 in f32
(summation order; the latent cache is bf16 in both packages, so a cached
entry may round to the neighbouring bf16 number -- caches are held at one
bf16 ulp, 2**-7, and decode steps that read them at 1e-3) and 3e-2 in
bf16 (both packages round after every op, not always at the same places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.kernels.flash_attention.ops import attention_chunked
from repro.models import mla as JMLA
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.configs.deepseek_v2_236b import ONE_CHIP
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.launch import serve
from repro_torch.models import mla as TMLA
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

DEEPSEEK = "deepseek-v2-236b"
TOL = {"f32": 1e-3, "bf16": 3e-2}
CACHE_TOL = 2.0 ** -7
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S, STEPS = 2, 16, 3


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def to_np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _layer(dt: str):
    """The reduced config, the reference's MLA parameters (in ``dt``) and
    the same parameters carried over to the port bit for bit."""
    jcfg, tcfg = j_get_arch(DEEPSEEK).reduced(), get_arch(DEEPSEEK).reduced()
    jp = JMLA.mla_init(jax.random.PRNGKey(5), jcfg)
    if dt == "f32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = {k: TT._from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _x(rng, shape, dt: str):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, DT[dt][0]), torch.from_numpy(a).to(DT[dt][1])


def test_reduced_config_runs_attention_at_head_dim_24():
    cfg = get_arch(DEEPSEEK).reduced()
    assert (cfg.mla, cfg.d_model, cfg.n_heads, cfg.q_lora, cfg.kv_lora,
            cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim) == (
        True, 64, 4, 32, 32, 16, 8, 16)
    assert TT.layer_plan(cfg) == [("mla", False), ("mla", True)]
    assert TT.slot_kinds(cfg) == JT.slot_kinds(j_get_arch(DEEPSEEK).reduced())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_mla_forward_matches_the_reference(dt, causal):
    jcfg, tcfg, jp, tp = _layer(dt)
    jx, tx = _x(np.random.default_rng(1), (B, S, 64), dt)
    want = JMLA.mla_forward(jp, jx, jcfg, causal=causal)
    before = fops.launches
    got = TMLA.mla_forward(tp, tx, tcfg, causal=causal)
    assert fops.launches == before          # the plain version on the CPU
    assert got.dtype == DT[dt][1] and got.shape == (B, S, 64)
    assert rel_err(to_np(got), want) <= TOL[dt]
    assert torch.equal(got, TMLA.mla_forward(tp, tx, tcfg, causal=causal,
                                             impl="ref"))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mla_prefill_and_decode_match_the_reference(dt):
    """Prefill (output and both caches), then three absorbed decode steps
    (outputs and caches), each package from its own state; a last
    position past the cache writes nothing in either."""
    jcfg, tcfg, jp, tp = _layer(dt)
    rng = np.random.default_rng(2)
    jx, tx = _x(rng, (B, S, 64), dt)
    jcache = JMLA.init_mla_cache(B, S + STEPS, jcfg)
    tcache = TMLA.init_mla_cache(B, S + STEPS, tcfg, device="cpu")
    want, jcache = JMLA.mla_prefill(jp, jx, jcache, jcfg)
    got, same = TMLA.mla_prefill(tp, tx, tcache, tcfg)
    assert same is tcache                   # written in place
    assert rel_err(to_np(got), want) <= TOL[dt]
    limit = CACHE_TOL if dt == "f32" else TOL[dt]
    for name in ("c_kv", "k_rope"):
        assert tcache[name].dtype == torch.bfloat16
        assert tcache[name].shape == jcache[name].shape
        assert rel_err(to_np(tcache[name]), jcache[name]) <= limit, name
        assert not tcache[name][:, S:].any()
    for i in range(STEPS):
        jx, tx = _x(rng, (B, 64), dt)
        pos = np.array([S + i, S + i + (i == STEPS - 1) * 99], np.int32)
        want, jcache = JMLA.mla_decode(jp, jx, jcache, jnp.asarray(pos),
                                       jcfg)
        got, _ = TMLA.mla_decode(tp, tx, tcache, torch.from_numpy(pos),
                                 tcfg)
        assert got.dtype == DT[dt][1] and got.shape == (B, 64)
        assert rel_err(to_np(got), want) <= TOL[dt], f"step {i}"
        for name in ("c_kv", "k_rope"):
            assert rel_err(to_np(tcache[name]), jcache[name]) <= limit
    # the out-of-range position of sequence 1 left its last row empty
    assert not tcache["c_kv"][1, -1].any()
    assert tcache["c_kv"][0, -1].any()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [192, 24])
def test_flash_plain_version_at_mla_head_dims(d, dt):
    """MLA's head dims -- deepseek-v2's nope 128 + rope 64, and the
    reduced config's 16 + 8 -- with V zero-padded from 2/3 of D, causal,
    against the reference's chunked attention (whose block divides S)."""
    rng = np.random.default_rng(d)
    b, h, s = 2, 4, 48
    q, k = (rng.standard_normal((b, h, s, d)) for _ in range(2))
    v = np.zeros((b, h, s, d))
    v[..., :2 * d // 3] = rng.standard_normal((b, h, s, 2 * d // 3))
    jd, td = DT[dt]
    got = fops.attention(*(torch.from_numpy(a.astype(np.float32)).to(td)
                           for a in (q, k, v)), causal=True)
    want = attention_chunked(*(jnp.asarray(a, jd) for a in (q, k, v)),
                             causal=True, block_k=16)
    assert got.shape == (b, h, s, d) and got.dtype == td
    assert rel_err(to_np(got), want) < (2.5e-2 if dt == "bf16" else 5e-5)
    assert not to_np(got)[..., 2 * d // 3:].any()


def test_latent_cache_layout_round_trips_bit_for_bit():
    """The port's stacked latent caches in the reference's layout: the
    tree, shapes and dtypes of ``init_caches``, and every layer's entries
    bit for bit."""
    jcfg = dataclasses.replace(j_get_arch(DEEPSEEK).reduced(), n_layers=3)
    tcfg = dataclasses.replace(get_arch(DEEPSEEK).reduced(), n_layers=3)
    caches = TT.init_caches(tcfg, B, 8, device="cpu")
    assert set(caches) == {"c_kv", "k_rope"}
    assert caches["c_kv"].shape == (3, B, 8, 32)
    assert caches["k_rope"].shape == (3, B, 8, 8)
    gen = torch.Generator().manual_seed(0)
    for t in caches.values():
        t.copy_(torch.randn(t.shape, generator=gen))
    want = jax.tree.map(np.asarray, JT.init_caches(jcfg, B, 8))
    ours = TT.caches_to_numpy(tcfg, caches,
                              bf16_dtype=want["first"]["kv"]["c_kv"].dtype)
    assert jax.tree.structure(ours) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
    for name in ("c_kv", "k_rope"):
        layers = [ours["first"]["kv"][name]] + list(
            ours["slots"][0]["kv"][name])
        for i, a in enumerate(layers):
            assert np.array_equal(a.view(np.uint16), TT._to_numpy(
                caches[name][i])), (name, i)


def test_param_counts_of_deepseek_v2_and_its_one_card_cut():
    full = get_arch(DEEPSEEK)
    assert TM.param_count(full) == JM.param_count(j_get_arch(DEEPSEEK))
    assert TM.active_param_count(full) == JM.active_param_count(
        j_get_arch(DEEPSEEK))
    ref = dataclasses.replace(j_get_arch(DEEPSEEK), n_layers=10)
    assert dataclasses.asdict(ONE_CHIP) == dict(
        dataclasses.asdict(ref), source=ONE_CHIP.source)
    assert TM.param_count(ONE_CHIP) == JM.param_count(ref) == 36_611_322_880
    assert TM.active_param_count(ONE_CHIP) == JM.active_param_count(
        ref) == 3_911_480_320
    assert len(ONE_CHIP.source) <= 200
    plan = TT.layer_plan(ONE_CHIP)
    assert plan == [("mla", False)] + [("mla", True)] * 9


def test_serve_cli_runs_the_reduced_deepseek_on_the_cpu(capsys):
    run = serve.main(["--arch", DEEPSEEK, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8",
                      "--decode-tokens", "3"])
    assert "[serve] deepseek-v2-236b" in capsys.readouterr().out
    assert run["tokens"].shape == (2, 3)
    assert run["caches"]["c_kv"].shape == (2, 2, 11, 32)
    assert run["caches"]["k_rope"].shape == (2, 2, 11, 8)
    assert all(v == 0 for phase in run["launches"].values()
               for v in phase.values())
    again = serve.generate(run["model"], run["cfg"], run["prompts"], 3,
                           attn_impl="ref")
    assert torch.equal(again["tokens"], run["tokens"])
