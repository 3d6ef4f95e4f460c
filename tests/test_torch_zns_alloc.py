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
    before = ops.launches
    ops.zns_alloc_rows(wear, avail, elig, one, one, one * 8, take=2)
    assert ops.launches == before      # the plain version is no launch


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
