"""The zns_alloc selection kernel of the port: plain version vs the
Pallas kernel (interpret mode), the ILP oracle and a numpy brute force.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel
itself is held to that plain version, bit for bit, by the ``cuda``-marked
test below (skipped without a card) and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import allocator as j_allocator
from repro.kernels.zns_alloc.ops import zns_alloc as j_zns_alloc
from repro_torch.core import alloc_exact
from repro_torch.core import allocator as t_allocator
from repro_torch.kernels.zns_alloc import ops, ref

GRID = [(2, 8, 1), (4, 64, 4), (8, 128, 3), (16, 256, 8), (3, 33, 5)]


def random_rows(rng, L, G, W, *, wear_max=99):
    wear = rng.integers(0, wear_max, (L, G, W)).astype(np.int32)
    avail = rng.choice([0, 1, 2, 3], (L, G, W)).astype(np.int32)
    elig = (rng.random((L, G)) < 0.8).astype(np.int32)
    return wear, avail, elig


@pytest.mark.parametrize("g,w,take", GRID)
def test_pallas_contract_matches_jax_pallas(g, w, take):
    rng = np.random.default_rng(g * 1000 + w + take)
    wear, avail, elig = (a[0] for a in random_rows(rng, 1, g, w))
    elig = elig.astype(bool)
    s_jax, f_jax = j_zns_alloc(jnp.asarray(wear), jnp.asarray(avail),
                               jnp.asarray(elig), take=take, impl="pallas")
    sel, feasible = ops.zns_alloc(torch.from_numpy(wear),
                                  torch.from_numpy(avail),
                                  torch.from_numpy(elig), take=take)
    assert sel.dtype == torch.bool and feasible.dtype == torch.bool
    assert np.array_equal(sel.numpy(), np.asarray(s_jax))
    assert bool(feasible) == bool(f_jax)
    s_ref, ok = ref.zns_alloc_ref(torch.from_numpy(wear),
                                  torch.from_numpy(avail),
                                  torch.from_numpy(elig), take=take)
    assert s_ref.dtype == ok.dtype == torch.int32
    assert np.array_equal(s_ref.numpy().astype(bool), np.asarray(s_jax))
    # the plain torch selection and the reference's XLA selection agree
    s_x, f_x = j_allocator.select_lowest_wear(
        jnp.asarray(wear), jnp.asarray(avail), jnp.asarray(elig), take)
    s_t, f_t = t_allocator.select_lowest_wear(
        torch.from_numpy(wear), torch.from_numpy(avail),
        torch.from_numpy(elig), take)
    assert np.array_equal(s_t.numpy(), np.asarray(s_x))
    assert bool(f_t) == bool(f_x)


@settings(max_examples=20, deadline=None, derandomize=True)
@given(st.integers(0, 2**31 - 1))
def test_allocate_cost_matches_exact_dp(seed):
    """The kernel contract vs the copied ILP dynamic program."""
    rng = np.random.default_rng(seed)
    g, w, take = 4, 16, 3
    wear = rng.integers(0, 50, (g, w)).astype(np.int32)
    avail = rng.choice([0, 1, 2, 3], (g, w)).astype(np.int32)
    sel, feas = t_allocator.allocate(wear, avail, np.ones(g, bool), take,
                                     device="cpu")
    dp = alloc_exact.solve(wear.reshape(-1), avail.reshape(-1),
                           np.repeat(np.arange(g), w), z=take * g,
                           k_max=take, l_min=g,
                           eligible_groups=list(range(g)))
    assert feas == dp.feasible
    if dp.feasible:
        assert float(wear[sel].sum()) == pytest.approx(dp.cost)
        assert float(t_allocator.selection_cost(
            torch.from_numpy(wear), torch.from_numpy(sel), take)) \
            == pytest.approx(dp.cost)


def brute_force(wear, avail, elig, by_wear, take_eff, pge, take):
    """Row by row in plain Python: sort every column by its key."""
    L, G, W = wear.shape
    cols = np.zeros((L, G, take), np.int32)
    ok = np.zeros((L, G), np.int32)
    cost = np.zeros((L, G), np.float32)
    for l in range(L):
        for g in range(G):
            free = [bool(elig[l, g]) and avail[l, g, c] in (0, 3)
                    and c < pge[l] for c in range(W)]
            ok[l, g] = sum(free)

            def key(c):
                if not free[c]:
                    return (2, 0, c)
                return (0, int(wear[l, g, c]) if by_wear[l] else 0, c)
            picks = sorted(range(W), key=key)[:take]
            picks.sort(key=lambda c: (0, int(wear[l, g, c]), c)
                       if free[c] else (2, 0, c))
            cols[l, g] = picks
            total = np.float32(0)
            for r in range(min(take, int(take_eff[l]))):
                c = picks[r]
                total = total + (np.float32(wear[l, g, c]) if free[c]
                                 else np.float32(np.inf))
            cost[l, g] = total
    return cols, ok, cost


@pytest.mark.parametrize("L,G,W,take", [(3, 4, 24, 5), (2, 5, 17, 3),
                                        (4, 2, 40, 8), (1, 3, 6, 6)])
def test_engine_variant_matches_brute_force(L, G, W, take):
    rng = np.random.default_rng(L * 100 + G * 10 + W + take)
    wear, avail, elig = random_rows(rng, L, G, W, wear_max=6)
    by_wear = (np.arange(L) % 2).astype(np.int32)
    take_eff = rng.integers(0, take + 1, L).astype(np.int32)
    pge = rng.integers(max(1, W // 2), W + 1, L).astype(np.int32)
    want = brute_force(wear, avail, elig, by_wear, take_eff, pge, take)
    args = [torch.from_numpy(a) for a in (wear, avail, elig, by_wear,
                                          take_eff, pge)]
    cols, ok, cost, sel = ops.zns_alloc_rows(*args, take=take,
                                             with_sel=True)
    assert cols.dtype == ok.dtype == sel.dtype == torch.int32
    assert cost.dtype == torch.float32
    assert np.array_equal(cols.numpy(), want[0])
    assert np.array_equal(ok.numpy(), want[1])
    assert np.array_equal(cost.numpy(), want[2])
    # sel marks exactly the free picks
    picked = np.zeros_like(sel.numpy())
    for l, g in np.ndindex(L, G):
        for c in want[0][l, g]:
            free = (elig[l, g] and avail[l, g, c] in (0, 3)
                    and c < pge[l])
            picked[l, g, c] = int(free)
    assert np.array_equal(sel.numpy(), picked)
    assert ops.zns_alloc_rows(*args, take=take)[3] is None


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(0)
    wear, avail, elig = (torch.from_numpy(a)
                         for a in random_rows(rng, 2, 3, 8))
    one = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="take"):
        ops.zns_alloc_rows(wear, avail, elig, one, one, one * 8, take=9)
    with pytest.raises(TypeError, match="int32"):
        ops.zns_alloc_rows(wear.long(), avail.long(), elig, one, one,
                           one * 8, take=2)
    with pytest.raises(ValueError, match="shape"):
        ops.zns_alloc_rows(wear, avail, elig[:1], one, one, one * 8,
                           take=2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.zns_alloc_rows(wear, avail, elig.t().contiguous().t(), one,
                           one, one * 8, take=2)
    with pytest.raises(ValueError, match="width"):
        big = torch.zeros((1, 1, ops.MAX_WIDTH + 1), dtype=torch.int32)
        ops.zns_alloc_rows(big, big, one[:1, None], one[:1], one[:1],
                           one[:1], take=1)
    before = dict(ops.counts)
    ops.zns_alloc_rows(wear, avail, elig, one, one, one * 8, take=2)
    assert ops.counts == before        # the plain version is no launch


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """Run on a card only: the Hopper kernel equals its plain version bit
    for bit, at ragged shapes and the main path's zn540 shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    for L, G, W, take in [(2, 4, 1056, 22), (3, 4, 48, 1), (5, 3, 300, 7),
                          (1, 1, 2048, 64), (7, 5, 33, 33)]:
        wear, avail, elig = random_rows(rng, L, G, W)
        args = [torch.from_numpy(a).cuda() for a in (
            wear, avail, elig, (np.arange(L) % 2).astype(np.int32),
            rng.integers(0, take + 1, L).astype(np.int32),
            rng.integers(1, W + 1, L).astype(np.int32))]
        got = ops.zns_alloc_rows(*args, take=take, with_sel=True)
        want = ref.zns_alloc_rows_ref(*args, take=take)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# the engine's fused selections (one launch per ALLOC, one per grow)
# --------------------------------------------------------------------- #
def lane_batch(rng, L, G, W, take, ZG, P, Z, *, wear_max=5000):
    """A lane batch for the fused selections: element arrays of a G x W
    grid plus the scratch slot with wear spans from flat (every cost
    tied) to wide, availability from all free to all busy (no feasible
    group); lanes mixing the two policies, wear-aware and first fit,
    wear bounds 0 to unbounded, union lanes (fewer groups, narrower
    groups, fewer zone groups), hints 0 and up; a zone column map, zones
    and grow counts from -2 (nothing to grow) to take."""
    n = G * W + 1
    span = rng.choice([1, 4, 60, wear_max], L)
    wear = (rng.random((L, n)) * span[:, None]).astype(np.int32)
    p_free = rng.choice([0.0, 0.05, 0.5, 1.0], L)
    avail = np.where(rng.random((L, n)) < p_free[:, None],
                     rng.choice([0, 3], (L, n)),
                     rng.choice([1, 2], (L, n))).astype(np.int32)
    zg = rng.integers(1, ZG + 1, L)
    ng = np.maximum(zg, rng.integers(1, G + 1, L))
    dtake = rng.integers(1, take + 1, L)
    lanes = np.stack([
        np.where(rng.random(L) < 0.6, W, rng.integers(1, W + 1, L)),
        ng, zg, rng.integers(1, dtake + 1), rng.integers(0, 2, L),
        rng.integers(0, 2, L), rng.choice([0, 1, 3, 2**30], L),
        rng.integers(1, 300, L), dtake, P // zg], 1).astype(np.int32)
    program = np.zeros((L, 3, 4), np.int32)
    program[:, 1, 2] = np.where(rng.random(L) < 0.3, 0,
                                rng.integers(1, 4000, L))
    t = torch.from_numpy
    return dict(
        wear=t(wear), avail=t(avail), lanes=t(lanes),
        rr=t(rng.integers(0, ng).astype(np.int32)),
        hint=t(program)[:, 1, 2],           # a strided program column
        zone_cols=t(rng.integers(0, G * (P // zg.min()),
                                 (L, Z, P)).astype(np.int32)),
        zone=t(rng.integers(0, Z, L).astype(np.int32)),
        k=t(rng.integers(-2, take + 1, L).astype(np.int32)))


# the composition the fused selections replaced: the engine's
# _rr_mask / _take_lowest / _wear_bounded_avail / _cheapest_groups /
# _claim_ids, each selection a zns_alloc_rows call
def _old_take_lowest(f, w2, a2, eligible, by_wear, take_eff, take):
    cols, ok, cost, _ = ref.zns_alloc_rows_ref(
        w2, a2, eligible.to(torch.int32), by_wear, take_eff.to(torch.int32),
        f["per_group"], take=take)
    feasible = ((ok >= take_eff[:, None]) | ~eligible).all(1)
    return cols, feasible, cost


def _old_grid_ok(f, G, W):
    return ((torch.arange(G)[None, :, None] < f["n_groups"][:, None, None])
            & (torch.arange(W)[None, None, :]
               < f["per_group"][:, None, None]))


def _old_cheapest_groups(f, w2, a2, take_eff, G, W, take):
    rows = _old_grid_ok(f, G, W)[:, :, 0]
    _, _, cost = _old_take_lowest(f, w2, a2, rows, torch.ones_like(
        take_eff), take_eff, take)
    g = torch.arange(G)
    before = ((cost[:, None, :] < cost[:, :, None])
              | ((cost[:, None, :] == cost[:, :, None])
                 & (g[None, :] < g[:, None])))
    return before.sum(2) < f["zone_groups"][:, None]


def _old_wear_bounded_avail(f, w2, a2, G, W):
    free = ((a2 == 0) | (a2 == 3)) & _old_grid_ok(f, G, W)
    min_wear = torch.where(free, w2, 2**30).amin((1, 2))
    in_bound = (w2 - min_wear[:, None, None]) <= \
        f["wear_bound"][:, None, None]
    return torch.where(in_bound, a2, 1)


def _old_claim_ids(elig, cols, W, ZG):
    win = ref._first_groups(elig, ZG)
    picked = cols[torch.arange(cols.shape[0])[:, None], win.long()]
    return win, (win[:, :, None] * W + picked).to(torch.int32)


def old_alloc(b, G, W, take, ZG):
    f = ref._fields(b["lanes"])
    w2, a2 = ref._grids(b["wear"], b["avail"], G, W)
    sil = f["silent"] != 0
    take_eff = f["take_eff"]
    ones = torch.ones_like(take_eff)
    pos = torch.arange(ZG, dtype=torch.int32)
    idx = torch.where(pos < f["zone_groups"][:, None],
                      torch.remainder(b["rr"][:, None] + pos,
                                      f["n_groups"][:, None]), G)
    elig1 = (idx[:, :, None] == torch.arange(G)).any(1)
    cols1, f1, _ = _old_take_lowest(f, w2, a2, elig1, f["wear_aware"],
                                    take_eff, take)
    hint = b["hint"]
    ranks_hint = -torch.div(-hint, f["per_rank"], rounding_mode="floor")
    take_s = torch.minimum(torch.clamp(torch.where(
        hint > 0, ranks_hint, take_eff), min=1), take_eff)
    a2b = _old_wear_bounded_avail(f, w2, a2, G, W)
    a2p = torch.where(sil[:, None, None], a2b, a2)
    take_p = torch.where(sil, take_s, take_eff)
    elig2 = _old_cheapest_groups(f, w2, a2p, take_p, G, W, take)
    cols2, f2, _ = _old_take_lowest(f, w2, a2p, elig2, ones, take_p, take)
    use_rr = ~sil & f1
    cols = torch.where(use_rr[:, None, None], cols1, cols2)
    elig = torch.where(use_rr[:, None], elig1, elig2)
    feasible = torch.where(sil, f2, f1 | f2)
    rr_next = torch.where(sil, b["rr"], torch.remainder(
        b["rr"] + f["zone_groups"], f["n_groups"]))
    rank_lim = torch.where(sil, take_s, f["take"])
    win, eids = _old_claim_ids(elig, cols, W, ZG)
    return win, eids, feasible, rr_next, rank_lim


def old_grow(b, G, W, take, ZG):
    f = ref._fields(b["lanes"])
    w2, a2 = ref._grids(b["wear"], b["avail"], G, W)
    a2b = _old_wear_bounded_avail(f, w2, a2, G, W)
    L, P = b["zone_cols"].shape[0], b["zone_cols"].shape[2]
    zc = b["zone_cols"][torch.arange(L), b["zone"].long()]
    pos = torch.arange(ZG, dtype=torch.int32)[None, :]
    lpg = f["lpg"][:, None]
    at = torch.clamp(pos * lpg, 0, P - 1)
    win_g = torch.div(torch.gather(zc, 1, at.long()), lpg,
                      rounding_mode="floor")
    gidx = torch.where(pos < f["zone_groups"][:, None], win_g, G)
    elig = (gidx[:, :, None] == torch.arange(G)).any(1)
    cols, fg, _ = _old_take_lowest(f, w2, a2b, elig,
                                   torch.ones_like(b["k"]), b["k"], take)
    return _old_claim_ids(elig, cols, W, ZG)[1], fg


FUSED = [(6, 4, 48, 22, 4, 4, 6), (9, 5, 40, 7, 3, 8, 3),
         (7, 3, 33, 33, 3, 3, 2), (5, 2, 70, 64, 2, 4, 5),
         (12, 1, 9, 4, 1, 2, 2), (8, 6, 17, 5, 6, 12, 4)]


@pytest.mark.parametrize("L,G,W,take,ZG,P,Z", FUSED)
def test_fused_selection_matches_the_composition(L, G, W, take, ZG, P, Z):
    """The fused ALLOC and grow selections' plain versions equal the
    composition of helpers they replaced, output for output and bit for
    bit, on lane batches mixing both policies, cost ties, rows with no
    feasible group, wear bound 0, hint 0, ragged and union lanes."""
    rng = np.random.default_rng(L * 131 + G * 17 + W + take)
    b = lane_batch(rng, L, G, W, take, ZG, P, Z)
    kw = dict(n_groups=G, per_group=W, take=take, zone_groups=ZG)
    got = ops.alloc_select(b["wear"], b["avail"], b["lanes"], b["rr"],
                           b["hint"], **kw)
    for a, e in zip(got, old_alloc(b, G, W, take, ZG)):
        assert a.dtype == e.dtype and torch.equal(a, e)
    got = ops.grow_select(b["wear"], b["avail"], b["lanes"],
                          b["zone_cols"], b["zone"], b["k"], **kw)
    for a, e in zip(got, old_grow(b, G, W, take, ZG)):
        assert a.dtype == e.dtype and torch.equal(a, e)
    # the batch covers what it claims to
    f = ref._fields(b["lanes"])
    assert set(f["silent"].tolist()) == {0, 1} or L < 8
    assert bool((~got[1]).any()) or L < 8


@pytest.mark.parametrize("seed", range(4))
def test_cheapest_groups_one_selection_equals_two(seed):
    """The cheapest branch selects once per row: the ranking selection
    over every real group gives, on the winning groups, the same columns
    and free counts as a second selection restricted to them."""
    rng = np.random.default_rng(seed)
    L, G, W, take, ZG = 10, 5, 64, 9, 3
    b = lane_batch(rng, L, G, W, take, ZG, 6, 2, wear_max=12)
    f = ref._fields(b["lanes"])
    w2, a2 = ref._grids(b["wear"], b["avail"], G, W)
    a2 = torch.where(f["silent"][:, None, None] != 0,
                     ref._wear_bounded(w2, a2, f), a2)
    elig = _old_cheapest_groups(f, w2, a2, f["take_eff"], G, W, take)
    rows = _old_grid_ok(f, G, W)[:, :, 0]
    one = ref.zns_alloc_rows_ref(w2, a2, rows.to(torch.int32),
                                 torch.ones_like(f["take_eff"]),
                                 f["take_eff"], f["per_group"], take=take)
    two = ref.zns_alloc_rows_ref(w2, a2, elig.to(torch.int32),
                                 torch.ones_like(f["take_eff"]),
                                 f["take_eff"], f["per_group"], take=take)
    assert bool((elig & ~rows).sum() == 0)       # winners are real rows
    for a, e in zip(one[:2], two[:2]):
        assert torch.equal(a[elig], e[elig])
    assert bool(elig.any())


def _jax_lane(cfg, f, lane, w2, a2, rr, hint):
    """The JAX engine's own ALLOC selection for one lane (its
    ``_rr_mask`` / ``_take_lowest`` / ``_wear_bounded_avail`` /
    ``_cheapest_groups``, branch by branch as ``_alloc`` runs them)."""
    import types
    from repro.core import engine as E
    v = {k: int(t[lane]) for k, t in f.items()}
    dyn = types.SimpleNamespace(
        n_elements=v["n_groups"] * v["per_group"], per_group=v["per_group"],
        zone_groups=v["zone_groups"], wear_bound=v["wear_bound"])
    w2, a2 = jnp.asarray(w2[lane].numpy()), jnp.asarray(a2[lane].numpy())
    if v["silent"]:
        h = int(hint[lane])
        take_s = min(max(-(-h // v["per_rank"]) if h > 0 else v["take_eff"],
                         1), v["take_eff"])
        a2b = E._wear_bounded_avail(cfg, dyn, w2, a2)
        elig = E._cheapest_groups(cfg, dyn, w2, a2b, take_s)
        cols, feas = E._take_lowest(cfg, dyn, w2, a2b, elig, True, take_s)
        return elig, cols, feas, int(rr[lane]), take_s
    elig = E._rr_mask(cfg, dyn, int(rr[lane]))
    cols, feas = E._take_lowest(cfg, dyn, w2, a2, elig,
                                bool(v["wear_aware"]), v["take_eff"])
    if not bool(feas):
        elig = E._cheapest_groups(cfg, dyn, w2, a2, v["take_eff"])
        cols, feas = E._take_lowest(cfg, dyn, w2, a2, elig, True,
                                    v["take_eff"])
    return (elig, cols, feas,
            (int(rr[lane]) + v["zone_groups"]) % v["n_groups"], v["take"])


@pytest.mark.parametrize("L,G,W,take,ZG,P,Z", FUSED[:3])
def test_fused_selection_matches_the_jax_engine(L, G, W, take, ZG, P, Z):
    """Lane by lane, the winning groups, the claimed element ids of every
    winner, feasibility, the next window start and the committed ranks
    equal what ``repro.core.engine``'s own selection helpers give."""
    import types
    rng = np.random.default_rng(L + G + W)
    b = lane_batch(rng, L, G, W, take, ZG, P, Z, wear_max=50)
    win, eids, feas, rr, rank_lim = ops.alloc_select(
        b["wear"], b["avail"], b["lanes"], b["rr"], b["hint"], n_groups=G,
        per_group=W, take=take, zone_groups=ZG)
    cfg = types.SimpleNamespace(n_groups=G, per_group=W, take=take,
                                zone_groups=ZG)
    f = ref._fields(b["lanes"])
    w2, a2 = ref._grids(b["wear"], b["avail"], G, W)
    for lane in range(L):
        elig, cols, jfeas, jrr, jlim = _jax_lane(cfg, f, lane, w2, a2,
                                                 b["rr"], b["hint"])
        groups = np.nonzero(np.asarray(elig))[0][:ZG]
        assert win[lane, :len(groups)].tolist() == groups.tolist()
        want = groups[:, None] * W + np.asarray(cols)[groups]
        assert np.array_equal(eids[lane, :len(groups)].numpy(), want)
        assert bool(feas[lane]) == bool(jfeas)
        assert (int(rr[lane]), int(rank_lim[lane])) == (jrr, jlim)


def test_fused_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(1)
    b = lane_batch(rng, 3, 4, 16, 5, 2, 4, 3)
    kw = dict(n_groups=4, per_group=16, take=5, zone_groups=2)
    args = (b["wear"], b["avail"], b["lanes"], b["rr"], b["hint"])
    with pytest.raises(TypeError, match="int32"):
        ops.alloc_select(b["wear"].long(), *args[1:], **kw)
    with pytest.raises(ValueError, match="lanes"):
        ops.alloc_select(*args[:2], b["lanes"][:, :4].contiguous(),
                         *args[3:], **kw)
    with pytest.raises(ValueError, match="grid"):
        ops.alloc_select(*args, **dict(kw, per_group=17))
    with pytest.raises(ValueError, match="zone_groups"):
        ops.alloc_select(*args, **dict(kw, zone_groups=5))
    with pytest.raises(ValueError, match="rr_next"):
        ops.alloc_select(*args[:3], b["rr"][:2], b["hint"], **kw)
    with pytest.raises(ValueError, match="zone_cols"):
        ops.grow_select(*args[:3], b["zone_cols"][0], b["zone"], b["k"],
                        **kw)
    before = dict(ops.counts)
    ops.alloc_select(*args, **kw)
    ops.grow_select(*args[:3], b["zone_cols"], b["zone"], b["k"], **kw)
    assert ops.counts == before        # plain versions: no launch


@pytest.mark.cuda
def test_cuda_fused_kernels_match_their_plain_versions():
    """Run on a card only: both fused kernels equal their plain versions
    bit for bit, at ragged lane batches and the zn540 grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(6)
    for L, G, W, take, ZG, P, Z in FUSED + [(16, 4, 1056, 22, 4, 4, 48),
                                             (3, 32, 200, 9, 7, 8, 2)]:
        b = {k: v.cuda() for k, v in lane_batch(
            rng, L, G, W, take, ZG, P, Z).items()}
        kw = dict(n_groups=G, per_group=W, take=take, zone_groups=ZG)
        for fn, plain, extra in (
                (ops.alloc_select, ref.alloc_select_ref,
                 (b["rr"], b["hint"])),
                (ops.grow_select, ref.grow_select_ref,
                 (b["zone_cols"], b["zone"], b["k"]))):
            got = fn(b["wear"], b["avail"], b["lanes"], *extra, **kw)
            want = plain(b["wear"], b["avail"], b["lanes"], *extra, **kw)
            torch.cuda.synchronize()
            for a, e in zip(got, want):
                assert torch.equal(a, e)


@pytest.mark.cuda
def test_cuda_fused_kernels_on_two_devices():
    """Run on two cards only: the zn540 grid needs more than 48 KB of
    shared memory a CTA, an attribute set per device, so a launch on the
    second card after one on the first must be granted it too."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    L, G, W, take, ZG, P, Z = 16, 4, 1056, 22, 4, 4, 48
    assert ops._fused_smem(G, W, take) > 48 * 1024
    batch = lane_batch(np.random.default_rng(8), L, G, W, take, ZG, P, Z)
    kw = dict(n_groups=G, per_group=W, take=take, zone_groups=ZG)
    for dev in ("cuda:0", "cuda:1", "cuda:0"):
        b = {k: v.to(dev) for k, v in batch.items()}
        for fn, plain, extra in (
                (ops.alloc_select, ref.alloc_select_ref,
                 (b["rr"], b["hint"])),
                (ops.grow_select, ref.grow_select_ref,
                 (b["zone_cols"], b["zone"], b["k"]))):
            got = fn(b["wear"], b["avail"], b["lanes"], *extra, **kw)
            want = plain(b["wear"], b["avail"], b["lanes"], *extra, **kw)
            torch.cuda.synchronize(dev)
            for a, e in zip(got, want):
                assert a.device == torch.device(dev)
                assert torch.equal(a, e)
