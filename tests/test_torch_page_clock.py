"""The page-granular busy-clock model of the port held to the JAX package.

``repro_torch.kernels.page_clock``'s plain version (the CPU path of
``timing.simulate`` / ``simulate_fleet``) against the reference's
``lax.scan`` on seeded random request streams, right-padding included,
bit for bit: the recurrence is two f32 additions and a max per request,
with no multiply to contract, so any difference is a fault.  The trace
drivers ``run_trace`` / ``run_fleet_trace`` over random IO streams equal
the reference's exactly for the same reason.  The kernel itself runs only
on a card: its test here is ``cuda``-marked and skips without one
(``chip_smoke.py`` phase 14 (h) holds it to the plain version on the
H100).
"""

import numpy as np
import pytest
import torch

from repro.core import timing as RT
from repro.core.device import IOTrace as RTrace
from repro.core.geometry import custom16 as r_custom16
from repro.core.geometry import zn540 as r_zn540
from repro_torch.core import timing as TT
from repro_torch.core.device import IOTrace as TTrace
from repro_torch.core.geometry import custom16 as t_custom16
from repro_torch.core.geometry import zn540 as t_zn540
from repro_torch.kernels.page_clock import ops, ref
from repro_torch.obs import RecompileCounter


def random_batch(seed: int, n_dev: int, n: int, n_luns: int, n_ch: int):
    """Right-padded int32 streams, their valid mask, and f32 times."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, n + 1, n_dev)
    lengths[0] = n
    return (rng.integers(0, 3, (n_dev, n), dtype=np.int32),
            rng.integers(0, n_luns, (n_dev, n), dtype=np.int32),
            rng.integers(0, n_ch, (n_dev, n), dtype=np.int32),
            np.arange(n)[None, :] < lengths[:, None],
            rng.uniform(1e-6, 5e-3, 3).astype(np.float32),
            np.float32(rng.uniform(1e-6, 1e-4)))


def torch_args(batch):
    o, l, c, v, t_op, t_x = batch
    return ([torch.from_numpy(a) for a in (o, l, c, v)]
            + [torch.from_numpy(t_op), torch.tensor(t_x)])


CASES = [(0, 1, 1, 1, 1), (1, 1, 300, 4, 4), (2, 5, 257, 16, 8),
         (3, 9, 120, 3, 7), (4, 3, 1, 2, 2), (5, 16, 64, 8, 16)]


@pytest.mark.parametrize("seed,n_dev,n,n_luns,n_ch", CASES)
def test_plain_version_equals_the_reference_scan(seed, n_dev, n, n_luns,
                                                 n_ch):
    batch = random_batch(seed, n_dev, n, n_luns, n_ch)
    want = RT.simulate_fleet(*batch, n_luns=n_luns, n_channels=n_ch)
    got = ref.simulate_fleet_ref(*torch_args(batch), n_luns, n_ch)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the timing module's entry points route CPU tensors to it
    routed = TT.simulate_fleet(*torch_args(batch), n_luns, n_ch)
    assert all(torch.equal(a, b) for a, b in zip(routed, got))
    o, l, c, _, t_op, t_x = batch
    one_want = RT.simulate(o[0], l[0], c[0], t_op, t_x, n_luns=n_luns,
                           n_channels=n_ch)
    one = TT.simulate(*[torch.from_numpy(a[0]) for a in (o, l, c)],
                      torch.from_numpy(t_op), torch.tensor(t_x), n_luns,
                      n_ch)
    for g, w in zip(one, one_want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_wrapper_routes_by_device_and_checks_its_arguments():
    args = torch_args(random_batch(7, 3, 50, 4, 4))
    want = ref.simulate_fleet_ref(*args, 4, 4)
    for impl in ("kernel", "ref"):
        got = ops.simulate_fleet(*args, 4, 4, impl=impl)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    before = ops.launches
    ops.simulate_fleet(*args, 4, 4)
    assert ops.launches == before       # the plain version is no launch
    with pytest.raises(ValueError, match="unknown page_clock impl"):
        ops.simulate_fleet(*args, 4, 4, impl="triton")
    with pytest.raises(ValueError, match="shape"):
        ops.simulate_fleet(args[0], args[1][:, :10], *args[2:], 4, 4)
    # an index out of range raises, as the kernel's error word does
    with pytest.raises(IndexError):
        ops.simulate_fleet(*args, 2, 4)


def random_traces(seed: int, flash_pair, n_traces: int):
    rng = np.random.default_rng(seed)
    r_flash, _ = flash_pair
    out = ([], [])
    for _ in range(n_traces):
        n = int(rng.integers(1, 400))
        luns = rng.integers(0, r_flash.n_luns, n)
        chans = luns % r_flash.n_channels
        op = str(rng.choice(["write", "read", "erase"]))
        out[0].append(RTrace(luns, chans, op))
        out[1].append(TTrace(luns.copy(), chans.copy(), op))
    return out


FLASHES = {"zn540": (r_zn540()[0], t_zn540()[0]),
           "custom16": (r_custom16(), t_custom16())}


@pytest.mark.parametrize("interleave", [True, False])
@pytest.mark.parametrize("flash", sorted(FLASHES))
def test_run_trace_equals_the_reference(flash, interleave):
    pair = FLASHES[flash]
    r_tr, t_tr = random_traces(11, pair, 5)
    want = RT.run_trace(pair[0], r_tr, interleave=interleave)
    got = TT.run_trace(pair[1], t_tr, interleave=interleave, device="cpu")
    assert got == want


@pytest.mark.parametrize("flash", sorted(FLASHES))
def test_run_fleet_trace_equals_the_reference(flash):
    pair = FLASHES[flash]
    bundles = ([], [])
    for d in range(4):
        r_tr, t_tr = random_traces(20 + d, pair, d)   # device 0 idles
        bundles[0].append(r_tr)
        bundles[1].append(t_tr)
    want = RT.run_fleet_trace(pair[0], bundles[0])
    got = TT.run_fleet_trace(pair[1], bundles[1], device="cpu")
    assert got == want


def test_plan_counter_watches_the_page_clock():
    """``RecompileCounter`` sees the page-granular entry points (their
    launch plans, one per stream shape on a card; none on the CPU)."""
    rc = RecompileCounter(simulate=TT.simulate,
                          simulate_fleet=TT.simulate_fleet)
    before = rc.counts()
    assert all(v >= 0 for v in before.values())
    TT.simulate_fleet(*torch_args(random_batch(3, 2, 30, 4, 4)), 4, 4)
    assert rc.delta(before) == {"simulate": 0, "simulate_fleet": 0}


@pytest.mark.cuda
def test_kernel_equals_plain_version_on_the_card():
    """The kernel against its plain version, bit for bit, on the card
    (padding, every op code, 1-16 LUNs and channels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the page_clock kernel has no "
                    "CPU mode (its plain version is tested above)")
    for seed, n_dev, n, n_luns, n_ch in CASES + [(9, 64, 5000, 16, 16)]:
        args = torch_args(random_batch(seed, n_dev, n, n_luns, n_ch))
        want = ref.simulate_fleet_ref(*args, n_luns, n_ch)
        before = ops.launches
        got = ops.simulate_fleet(*[a.cuda() for a in args], n_luns, n_ch)
        assert ops.launches == before + 1
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
