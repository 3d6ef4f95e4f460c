"""The port's MoE layer and the MoE stacks held to the JAX reference on
the CPU: ``moe_apply`` at the reduced jamba, llama4-scout and deepseek-v2
``MoEDims`` and at a top-6, 16-expert, device-limited, int8 case that
drops; the int8 scale quirk at slot ``(0, C-1)``; ties going to the
lower index; whole prefill + decode runs of the reduced llama4-scout, the
reduced jamba with its experts, a llama4-scout with a dense first layer
and the reduced deepseek-v2 (MLA, int8 dispatch); parameter round trips
and parameter counts.

The reference's routes, kept mask and positions are read from the calls
it makes (``jax.lax.top_k``, ``jnp.argsort``, ``jnp.bincount``, wrapped
for an eager call) and must EQUAL the port's; its output and aux loss
come from the compiled call, as the served reference's do.  Outputs and
the aux loss are
held at the tolerances of ``tests/test_torch_serve.py`` (``rel_err`` =
max abs difference over max abs reference): 1e-3 in f32 (summation
order), 3e-2 in bf16 (bf16 rounds after every op in both packages, not
always at the same places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.configs.llama4_scout_17b_a16e import ONE_CHIP
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT

LLAMA4 = "llama4-scout-17b-a16e"
JAMBA = "jamba-1.5-large-398b"
DEEPSEEK = "deepseek-v2-236b"
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


def torch_dims(jdims) -> TMOE.MoEDims:
    return TMOE.MoEDims(**dataclasses.asdict(jdims))


# --------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------- #
def moe_params(rng, dims, dtype: str):
    """Seeded numpy parameters with ``moe_init``'s distributions."""
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
    return p


def both(tree, dtype: str):
    """A numpy tree as (jax, torch) trees: the router f32, every other
    leaf in ``dtype`` (both sides round f32 -> bf16 to nearest even)."""
    jd, td = DT[dtype]

    def conv(t, name):
        if isinstance(t, dict):
            return [dict(zip(t, v)) for v in zip(*(conv(t[k], k)
                                                   for k in t))]
        a = np.asarray(t, np.float32)
        if name == "router":
            return [jnp.asarray(a), torch.from_numpy(a)]
        return [jnp.asarray(a, jd), torch.from_numpy(a).to(td)]
    return conv(tree, "")


def reference_call(monkeypatch, p, x, dims):
    """The reference's ``moe_apply`` run eagerly, with its routes (the
    last ``top_k``), its stable sort by expert and its counts read off
    the calls it makes, and its output and aux loss from the compiled
    call (``jax.jit``, as the reference serves it: compiled, XLA on the
    CPU multiplies the int8 scale by 1/127 and keeps the dequantising
    bf16 x bf16 product exact in f32 when the activations are f32,
    where the eager call divides and rounds the product to bf16); returns
    (out, aux, gate_idx, keep, pos), keep and pos token-major (T, k)."""
    seen = {"top_k": [], "argsort": [], "bincount": []}
    for mod, name in ((jax.lax, "top_k"), (jnp, "argsort"),
                      (jnp, "bincount")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            seen[_name].append(out)
            return out
        monkeypatch.setattr(mod, name, wrapped)
    JMOE.moe_apply(p, x, dims)
    monkeypatch.undo()
    out, aux = jax.jit(JMOE.moe_apply, static_argnums=2)(p, x, dims)
    gate_idx = np.asarray(seen["top_k"][-1][1])
    t, k = gate_idx.shape
    order = np.asarray(seen["argsort"][-1])
    counts = np.asarray(seen["bincount"][-1])
    starts = np.cumsum(counts) - counts
    sorted_e = gate_idx.reshape(-1)[order]
    pos_sorted = np.arange(t * k) - starts[sorted_e]
    pos = np.empty(t * k, np.int64)
    pos[order] = pos_sorted
    c = JMOE.capacity(t, dims)
    return (np.asarray(out, np.float32), float(aux), gate_idx,
            (pos < c).reshape(t, k), pos.reshape(t, k))


def _dims(name):
    return JT._moe_dims(j_get_arch(name).reduced())


#: (name, reference MoEDims): the three reduced configs, and deepseek-v2's
#: routing at 16 experts (top-6 over 4 groups, limit 2, int8, 2 shared)
#: with a capacity factor low enough to drop
LAYER_CASES = [
    ("jamba", _dims(JAMBA)),
    ("llama4", _dims(LLAMA4)),
    ("deepseek", _dims(DEEPSEEK)),
    ("top6-int8-drops", JMOE.MoEDims(16, 6, 64, 32, n_shared=2,
                                     capacity_factor=0.5, route_groups=4,
                                     route_limit=2, int8_dispatch=True)),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name,jdims", LAYER_CASES,
                         ids=[n for n, _ in LAYER_CASES])
def test_moe_apply_matches_the_reference(monkeypatch, name, jdims, dt):
    rng = np.random.default_rng(len(name))
    t = 48
    jp, tp = both(moe_params(rng, jdims, dt), dt)
    x = rng.standard_normal((t, jdims.d_model)).astype(np.float32)
    jd, td = DT[dt]
    want, aux, gate_idx, keep, pos = reference_call(
        monkeypatch, jp, jnp.asarray(x, jd), jdims)
    out, r = TMOE.moe_forward(tp, torch.from_numpy(x).to(td),
                              torch_dims(jdims))
    assert out.dtype == td and out.shape == (t, jdims.d_model)
    assert np.array_equal(r.gate_idx.numpy(), gate_idx)
    assert np.array_equal(r.keep.numpy(), keep)
    assert np.array_equal(r.pos.numpy(), pos)
    if name == "top6-int8-drops":
        assert not keep.all()
    else:
        assert keep.all()             # the reduced configs' capacity 4.0
    assert rel_err(to_np(out), want) <= TOL[dt]
    assert abs(float(r.aux) - aux) <= TOL["f32"] * abs(aux)
    got, got_aux = TMOE.moe_apply(tp, torch.from_numpy(x).to(td),
                                  torch_dims(jdims))
    assert torch.equal(got, out) and float(got_aux) == float(r.aux)


def test_mixed_dtypes_promote_as_jnp_does(monkeypatch):
    """f32 tokens over bf16 experts: ``jnp.einsum`` promotes to f32, and
    so must the port (``torch.bmm`` refuses mixed dtypes)."""
    jdims = LAYER_CASES[1][1]
    rng = np.random.default_rng(3)
    jp, tp = both(moe_params(rng, jdims, "bf16"), "bf16")
    x = rng.standard_normal((24, jdims.d_model)).astype(np.float32)
    want, _, gate_idx, _, _ = reference_call(monkeypatch, jp,
                                             jnp.asarray(x), jdims)
    out, r = TMOE.moe_forward(tp, torch.from_numpy(x), torch_dims(jdims))
    assert out.dtype == torch.float32
    assert np.array_equal(r.gate_idx.numpy(), gate_idx)
    assert rel_err(to_np(out), want) <= TOL["f32"]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_int8_scale_quirk_at_the_last_slot_of_expert_0(monkeypatch, dt):
    """The reference adds every dropped pair's scale (1e-6 / 127: their
    payload is zeroed first) into slot (0, C-1).  Every token routes to
    expert 0, so 56 of 64 are dropped, and token 7 -- the one kept in
    (0, C-1) -- has a scale near theirs, so the quirk multiplies its
    dequantised row ~47-fold.  The port must give that row as the
    reference does."""
    jdims = JMOE.MoEDims(4, 1, 64, 32, capacity_factor=0.25,
                         int8_dispatch=True)
    t, d = 64, 64
    rng = np.random.default_rng(0)
    p = moe_params(rng, jdims, dt)
    u = np.full(d, 0.125, np.float32)
    p["router"] = np.zeros((d, 4), np.float32)
    p["router"][:, 0] = u
    x = (3 * u + 0.1 * rng.standard_normal((t, d))).astype(np.float32)
    x[7] = 1e-5 * u
    jp, tp = both(p, dt)
    jd, td = DT[dt]
    want, _, gate_idx, keep, pos = reference_call(
        monkeypatch, jp, jnp.asarray(x, jd), jdims)
    c = JMOE.capacity(t, jdims)
    assert c == 8 and (gate_idx == 0).all()
    assert keep.sum() == c and pos[7, 0] == c - 1
    out, r = TMOE.moe_forward(tp, torch.from_numpy(x).to(td),
                              torch_dims(jdims))
    assert np.array_equal(r.keep.numpy(), keep)
    assert np.array_equal(r.pos.numpy(), pos)
    # the quirk is material: the scale at (0, C-1) grows ~47-fold
    own = np.float32(np.abs(x[7].astype(np.float32)).max() / 127.0)
    step = np.float32(np.float32(1e-6) / np.float32(127.0))
    quirk = TMOE._fold_f32(float(own), float(step), t - c)
    assert quirk / own > 40
    got, ref = to_np(out), want
    assert rel_err(got[7], ref[7]) <= TOL[dt]
    assert rel_err(got, ref) <= TOL[dt]
    assert not got[c:].any()          # the dropped tokens add nothing


def test_moe_apply_gradients_match_the_reference(monkeypatch):
    """``jax.grad`` of the reference's compiled ``moe_apply`` (out . ct +
    aux) against the port's autograd in f32, routes, kept masks and
    positions EQUAL: the router, expert and shared weights' gradients at
    ``rel_err`` <= 1e-4, the input's too.  The input's gradient runs
    through each token's int8 scale (the payload is rounded), whose
    cotangent the compiled reference sums in bf16 (its eager gradient
    differs by 4e-3 to 8e-3, an f32 sum by ~1e-2): the port's
    ``_Dequant`` sums as it does.  The dropping top-6 int8 case: slot
    (0, C-1) holds a kept pair's scale and the dropped pairs' folded
    ones, and a fold that cut the slot's gradient fails the input's
    check."""
    rng = np.random.default_rng(31)
    jdims = dict(LAYER_CASES)["top6-int8-drops"]
    p = moe_params(rng, jdims, "f32")
    x = rng.standard_normal((48, jdims.d_model)).astype(np.float32)
    t, d = x.shape
    ct = rng.standard_normal((t, d)).astype(np.float32)
    jp, tp = both(p, "f32")
    _, _, gate_idx, keep, pos = reference_call(monkeypatch, jp,
                                               jnp.asarray(x), jdims)
    assert not keep.all()

    def jloss(p, x):
        out, aux = JMOE.moe_apply(p, x, jdims)
        return jnp.sum(out * ct) + aux
    w_gp, w_gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp,
                                                          jnp.asarray(x))
    leaves = [tp["router"], tp["w_gate"], tp["w_up"], tp["w_down"]]
    names = ["router", "w_gate", "w_up", "w_down"]
    if "shared" in tp:
        leaves += [tp["shared"][n] for n in ("w_gate", "w_up", "w_down")]
        names += [("shared", n) for n in ("w_gate", "w_up", "w_down")]
    for leaf in leaves:
        leaf.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    out, r = TMOE.moe_forward(tp, tx, torch_dims(jdims))
    assert np.array_equal(r.gate_idx.numpy(), gate_idx)
    assert np.array_equal(r.keep.numpy(), keep)
    assert np.array_equal(r.pos.numpy(), pos)
    loss = (out * torch.from_numpy(ct)).sum() + r.aux
    grads = torch.autograd.grad(loss, leaves + [tx])
    for name, g in zip(names, grads):
        want = (w_gp[name[0]][name[1]] if isinstance(name, tuple)
                else w_gp[name])
        assert rel_err(to_np(g), want) <= 1e-4, name
    assert rel_err(to_np(grads[-1]), w_gx) <= 1e-4


def test_combine_adds_in_the_order_of_the_reference_scatter():
    """Three bf16 contributions 1, 2^-8, 2^-8 (the last two half an ulp
    of 1): added in ascending expert id they give 1 (two ties to even),
    in any order that adds the small ones first 1 + 2^-7.  The port must
    give what the reference's combine statement gives."""
    t, k, e, c = 3, 3, 3, 1
    gate_idx = np.array([[2, 0, 1], [0, 1, 2], [1, 2, 0]])
    y = np.zeros((e * c + 1, 1), np.float32)
    y[:3, 0] = [1.0, 2.0 ** -8, 2.0 ** -8]          # expert 0, 1, 2
    w = np.ones((t, k), np.float32)
    # the reference's combine (repro/models/moe.py), pairs sorted by expert
    flat_e = gate_idx.reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    contrib = (jnp.asarray(y, jnp.bfloat16)[flat_e[order]]
               * jnp.asarray(w.reshape(-1)[order], jnp.bfloat16)[:, None])
    want = jnp.zeros((t, 1), jnp.bfloat16).at[
        np.repeat(np.arange(t), k)[order]].add(contrib)
    got = TMOE._combine(torch.from_numpy(y).to(torch.bfloat16),
                        torch.from_numpy(gate_idx),
                        torch.from_numpy(gate_idx * c),
                        torch.from_numpy(w))
    assert np.array_equal(to_np(got), np.asarray(want, np.float32))
    assert (to_np(got) == 1.0).all()


def test_fold_f32_is_a_left_fold_in_f32():
    acc = np.float32(0.03125)
    for _ in range(1000):
        acc = np.float32(acc + np.float32(7.874e-9))
    assert TMOE._fold_f32(0.03125, float(np.float32(7.874e-9)), 1000) \
        == float(acc)
    assert TMOE._fold_f32(1.5, 2.0, 0) == 1.5


def test_top_k_ties_go_to_the_lower_index(monkeypatch):
    """Exact ties (equal single products of the router): top-3 of
    experts tied at 0.5 is the three lowest, and with device-limited
    routing over 4 tied groups the two lowest groups win."""
    d = 16
    x = np.zeros((6, d), np.float32)
    x[:, 0] = np.arange(1, 7)
    row = [0.1, 0.5, 0.3, 0.5, 0.5, 0.2, 0.0, 0.5]
    for groups, limit, want in ((0, 0, [1, 3, 4]), (4, 2, [1, 3, 2])):
        jdims = JMOE.MoEDims(8, 3, d, 8, capacity_factor=4.0,
                             route_groups=groups, route_limit=limit)
        p = moe_params(np.random.default_rng(1), jdims, "f32")
        p["router"] = np.zeros((d, 8), np.float32)
        p["router"][0] = row
        jp, tp = both(p, "f32")
        _, _, gate_idx, _, _ = reference_call(monkeypatch, jp,
                                              jnp.asarray(x), jdims)
        _, r = TMOE.moe_forward(tp, torch.from_numpy(x), torch_dims(jdims))
        assert (gate_idx == want).all()
        assert np.array_equal(r.gate_idx.numpy(), gate_idx)
    # all tied: the k lowest experts
    jdims = JMOE.MoEDims(8, 3, d, 8)
    p = moe_params(np.random.default_rng(1), jdims, "f32")
    p["router"] = np.zeros((d, 8), np.float32)
    _, r = TMOE.moe_forward(both(p, "f32")[1], torch.from_numpy(x),
                            torch_dims(jdims))
    assert (r.gate_idx.numpy() == [0, 1, 2]).all()


def test_capacity_matches_the_reference():
    for dims in [d for _, d in LAYER_CASES]:
        for n in (1, 7, 8, 48, 512, 4096):
            assert TMOE.capacity(n, torch_dims(dims)) == JMOE.capacity(
                n, dims)
    # the llama4 cut's prefill (8 x 512 tokens) and decode (8 tokens)
    dims = TT.moe_dims(ONE_CHIP)
    assert TMOE.capacity(8 * 512, dims) == 320
    assert TMOE.capacity(8, dims) == 8


def test_routes_replay_keeps_the_recorded_experts():
    """The check hook: replayed routes send each token to the recorded
    experts with this call's probabilities there, renormalised."""
    jdims = LAYER_CASES[0][1]
    rng = np.random.default_rng(9)
    tp = both(moe_params(rng, jdims, "f32"), "f32")[1]
    x = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    dims = torch_dims(jdims)
    out, r = TMOE.moe_forward(tp, x, dims)
    again, r2 = TMOE.moe_forward(tp, x, dims, routes=r.gate_idx)
    assert torch.equal(again, out) and torch.equal(r2.gate_vals,
                                                   r.gate_vals)
    flipped = r.gate_idx.flip(1)
    _, r3 = TMOE.moe_forward(tp, x, dims, routes=flipped)
    assert torch.equal(r3.gate_idx, flipped)
    assert torch.allclose(r3.gate_vals, r.gate_vals.flip(1))


def test_routes_replay_weights_ignore_this_calls_group_mask():
    """Under device-limited routing the recorded groups are part of the
    replayed choice: a replayed expert outside this call's groups keeps
    its probability as its weight (this call's mask would zero it)."""
    jdims = LAYER_CASES[3][1]                 # 16 experts, 4 groups, limit 2
    rng = np.random.default_rng(10)
    tp = both(moe_params(rng, jdims, "f32"), "f32")[1]
    x = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    dims = torch_dims(jdims)
    _, r = TMOE.moe_forward(tp, x, dims)
    probs = torch.softmax(x @ tp["router"], dim=-1)
    # every token's top-6 lies in its 2 groups of 4: move one choice to an
    # expert of a group it did not pick
    group = r.gate_idx // 4
    other = torch.tensor([next(e for e in range(16)
                               if e // 4 not in set(g.tolist()))
                          for g in group])
    routes = r.gate_idx.clone()
    routes[:, -1] = other
    _, r2 = TMOE.moe_forward(tp, x, dims, routes=routes)
    want = probs.gather(1, routes)
    assert torch.equal(r2.gate_idx, routes)
    assert torch.allclose(r2.gate_vals, want / want.sum(-1, keepdim=True))
    assert bool((r2.gate_vals[:, -1] > 0).all())


# --------------------------------------------------------------------- #
# configs and parameter counts
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", [LLAMA4, JAMBA])
def test_param_counts_on_meta_equal_the_reference(name):
    assert TM.param_count(get_arch(name)) == JM.param_count(
        j_get_arch(name))
    assert TM.active_param_count(get_arch(name)) == JM.active_param_count(
        j_get_arch(name))


def test_param_count_of_the_llama4_one_card_cut():
    ref = dataclasses.replace(j_get_arch(LLAMA4), n_layers=16)
    assert dataclasses.asdict(ONE_CHIP) == dict(
        dataclasses.asdict(ref), source=ONE_CHIP.source)
    assert TM.param_count(ONE_CHIP) == JM.param_count(ref) == 36_269_102_080
    assert TM.active_param_count(ONE_CHIP) == JM.active_param_count(ref)
    assert len(ONE_CHIP.source) <= 200
    assert all(moe for _, moe in TT.layer_plan(ONE_CHIP))


# --------------------------------------------------------------------- #
# whole prefill + decode runs
# --------------------------------------------------------------------- #
B, P, N_DECODE = 2, 16, 5          # prefill + 4 decode steps


def _variant(name: str, jax_side: bool):
    get = j_get_arch if jax_side else get_arch
    if name == "llama4-first-dense":
        return dataclasses.replace(get(LLAMA4).reduced(), n_layers=3,
                                   first_layer_dense=True, dense_d_ff=192)
    return get(name).reduced()


SERVE_CASES = [LLAMA4, JAMBA, "llama4-first-dense", DEEPSEEK]


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


@pytest.mark.parametrize("name", SERVE_CASES)
def test_moe_params_round_trip_bit_for_bit(name):
    jcfg, tcfg = _variant(name, True), _variant(name, False)
    tree = jax.tree.map(np.asarray,
                        JT.init_params(jax.random.PRNGKey(3), jcfg))
    model = TT.params_from_numpy(tcfg, tree, device="cpu")
    assert len(model.blocks) == jcfg.n_layers
    moe = [isinstance(b.ffn, TT.MoEFFN) for b in model.blocks]
    assert moe == [m for _, m in TT.layer_plan(tcfg)]
    assert moe == [jcfg.is_moe_layer(i) for i in range(jcfg.n_layers)]
    if tcfg.first_layer_dense:
        assert model.blocks[0].ffn["w_gate"].shape == (64, tcfg.dense_d_ff)
    back = TT.params_to_numpy(model, bf16_dtype=tree["embed"].dtype)
    flat_a, tdef_a = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in flat_a) == TM.param_count(tcfg)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", SERVE_CASES)
def test_moe_serve_matches_the_reference(name, dt):
    """Prefill + 4 teacher-forced decode steps: every step's logits and
    the final caches (KV, Mamba, the dense first layer's).  As in
    ``tests/test_torch_serve.py``, f32 runs are held to JAX's Pallas
    decode attention and bf16 runs to its default."""
    jcfg, tcfg = _variant(name, True), _variant(name, False)
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
        limit = CACHE_TOL if dt == "f32" else TOL["bf16"]
        assert rel_err(got, ref) <= limit, path


def test_moe_layers_record_and_replay_their_routes():
    """The serving check hooks on a reduced llama4-scout: a recorded run
    replayed through every MoE layer gives the same run."""
    cfg = get_arch(LLAMA4).reduced()
    model = serve.build(cfg, seed=0, device="cpu")
    prompts = torch.from_numpy(serve.make_prompts(cfg, B, P, seed=0))
    layers = [m for m in model.modules() if isinstance(m, TT.MoEFFN)]
    assert len(layers) == cfg.n_layers
    for m in layers:
        m.record = []
    run = serve.generate(model, cfg, prompts, 3)
    for m in layers:
        assert [r.gate_idx.shape for r in m.record] == [(B * P, 1), (B, 1),
                                                        (B, 1)]
        m.replay, m.record = iter([r.gate_idx for r in m.record]), None
    again = serve.generate(model, cfg, prompts, 3, forced=run["tokens"])
    for a, b in zip(run["logits"], again["logits"]):
        assert torch.equal(a, b)
