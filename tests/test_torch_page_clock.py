"""The page-granular busy-clock model of the port held to the JAX package.

``repro_torch.kernels.page_clock``'s plain version (the CPU path of
``timing.simulate`` / ``simulate_fleet``) against the reference's
``lax.scan`` on seeded random request streams, right-padding included,
bit for bit: the recurrence is two f32 additions and a max per request,
with no multiply to contract, so any difference is a fault.  The trace
drivers ``run_trace`` / ``run_fleet_trace`` over random IO streams equal
the reference's exactly for the same reason.  The kernel steps each
channel's requests as a chain of its own wherever no LUN of a row meets
two channels; :func:`channel_split` writes that partition with the plain
version, and it equals the whole-stream plain version and the
reference's scan bit for bit on zn540 and custom16 streams, on random
padded batches, and -- stepped whole, as the kernel does -- on a stream
where one LUN meets two channels.  The kernel itself runs only on a
card: its tests here are ``cuda``-marked and skip without one
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
from repro_torch.core import workloads as TW
from repro_torch.core import timing as TT
from repro_torch.core.device import IOTrace as TTrace
from repro_torch.core.elements import FIXED as T_FIXED
from repro_torch.core.geometry import ZoneGeometry as TZone
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


def channel_split(ops_, luns, channels, valid, t_op, t_xfer, n_luns: int,
                  n_channels: int):
    """The kernel's partition, written with the plain version: where no
    LUN of a row meets two channels on a valid request (and the row has
    at most ``ops.MAX_CHAINS`` channels), each channel's valid requests are
    stepped alone, in order, by ``simulate_fleet_ref`` and their
    completions put back in place; otherwise the row is stepped whole.
    The makespan is the largest LUN clock, each LUN's clock being its last
    completion (0 where it has none).  Returns (completions, makespans,
    the rows stepped whole)."""
    n_dev, n = ops_.shape
    done = torch.zeros((n_dev, n), dtype=torch.float32)
    span = torch.zeros(n_dev, dtype=torch.float32)
    whole = []
    for d in range(n_dev):
        ok = valid[d]
        seen, mixed = {}, n_channels > ops.MAX_CHAINS
        for lun, ch in zip(luns[d][ok].tolist(), channels[d][ok].tolist()):
            mixed |= seen.setdefault(lun, ch) != ch
        if mixed:
            whole.append(d)
            done[d], span[d] = (x[0] for x in ref.simulate_fleet_ref(
                ops_[d:d + 1], luns[d:d + 1], channels[d:d + 1],
                valid[d:d + 1], t_op, t_xfer, n_luns, n_channels))
            continue
        clocks = torch.zeros(n_luns, dtype=torch.float32)
        for ch in range(n_channels):
            idx = torch.nonzero(ok & (channels[d] == ch)).flatten()
            if len(idx) == 0:
                continue
            sub, _ = ref.simulate_fleet_ref(
                ops_[d, idx][None], luns[d, idx][None],
                channels[d, idx][None],
                torch.ones((1, len(idx)), dtype=torch.bool), t_op, t_xfer,
                n_luns, n_channels)
            done[d, idx] = sub[0]
            for j, lun in zip(idx.tolist(), luns[d, idx].tolist()):
                clocks[lun] = done[d, j]
        span[d] = clocks.amax()
    return done, span, whole


def assert_split_equals_whole(args, n_luns, n_ch, partitioned):
    """``channel_split`` == the whole-stream plain version == the
    reference's scan, bit for bit; ``partitioned`` lists the rows that
    must have been split by channel."""
    got_done, got_span, whole = channel_split(*args, n_luns, n_ch)
    assert [d for d in range(args[0].shape[0]) if d not in whole] == \
        partitioned
    want = ref.simulate_fleet_ref(*args, n_luns, n_ch)
    r_want = RT.simulate_fleet(*[a.numpy() for a in args],
                               n_luns=n_luns, n_channels=n_ch)
    for g, w, rw in zip((got_done, got_span), want, r_want):
        assert torch.equal(g, w)
        assert np.array_equal(g.numpy(), np.asarray(rw))


def workload_stream(flash, zone, zones: int, pages: int):
    """A merged host stream of the paper's benchmarks: ``zones`` zones of
    a FIXED shim written ``pages`` pages each, round-robin, as
    ``workloads`` merges its concurrent writers (every LUN on its
    geometry's one channel)."""
    dev = TW.make_device(flash, zone, T_FIXED, max_active=zones,
                         device="cpu")
    traces = [dev.zone_write(z, pages, trace=True) for z in range(zones)]
    o, l, c, _ = TT._merge(traces, True)
    return ([torch.from_numpy(a)[None] for a in (o, l, c)]
            + [torch.ones((1, len(o)), dtype=torch.bool),
               TT._t_op(flash, torch.device("cpu")),
               torch.tensor(flash.t_xfer, dtype=torch.float32)])


@pytest.mark.parametrize("geometry", ["zn540", "custom16"])
def test_channel_split_equals_the_whole_stream(geometry):
    """The streams the per-op benchmarks time: zn540 (4 channels, a LUN
    each) and custom16 (8 channels of 2 LUNs, the Fig. 9 geometry P16
    S1)."""
    if geometry == "zn540":
        flash, zone = t_zn540()
    else:
        flash, zone = t_custom16(), TZone(parallelism=16, n_segments=1)
    args = workload_stream(flash, zone, 3, 700)
    assert set(zip(args[1][0].tolist(), args[2][0].tolist())) == {
        (lun, lun % flash.n_channels) for lun in range(flash.n_luns)}
    assert_split_equals_whole(args, flash.n_luns, flash.n_channels, [0])


@pytest.mark.parametrize("seed,n_dev,n,n_luns,n_ch", [
    (21, 4, 300, 4, 4), (22, 3, 257, 16, 8), (23, 5, 200, 64, 4),
    (24, 2, 400, 3, 5), (25, 3, 150, 12, 32)])
def test_channel_split_on_random_padded_batches(seed, n_dev, n, n_luns,
                                                n_ch):
    """Random padded batches whose LUNs keep a channel each (one, a few or
    sixteen LUNs a channel, a channel with none), and the same batch with
    the padding's channels made random: padding steps no clock, so it
    splits all the same."""
    o, l, _, v, t_op, t_x = random_batch(seed, n_dev, n, n_luns, n_ch)
    c = (l % n_ch).astype(np.int32)
    args = torch_args((o, l, c, v, t_op, t_x))
    assert_split_equals_whole(args, n_luns, n_ch, list(range(n_dev)))
    rng = np.random.default_rng(seed)
    c_pad = np.where(v, c, rng.integers(0, n_ch, c.shape)).astype(np.int32)
    args = torch_args((o, l, c_pad, v, t_op, t_x))
    assert_split_equals_whole(args, n_luns, n_ch, list(range(n_dev)))


def test_a_lun_on_two_channels_is_stepped_whole():
    """Where one LUN meets two channels the chains share its clock: a
    split by channel would differ (so the kernel steps such a row whole),
    and the whole row equals the reference."""
    o = np.zeros((2, 4), np.int32)
    l = np.array([[0, 0, 1, 1], [0, 1, 0, 1]], np.int32)
    c = np.array([[0, 1, 1, 1], [0, 1, 0, 1]], np.int32)
    v = np.ones((2, 4), bool)
    t_op, t_x = np.float32([7e-4, 6e-5, 3.5e-3]), np.float32(2.5e-5)
    args = torch_args((o, l, c, v, t_op, t_x))
    assert_split_equals_whole(args, 2, 2, [1])
    # row 0 split anyway: its second request would start on a fresh LUN 0
    naive = ref.simulate_fleet_ref(*[a[:1, 1:] for a in args[:4]],
                                   *args[4:], 2, 2)[0]
    want = ref.simulate_fleet_ref(*[a[:1] for a in args[:4]], *args[4:],
                                  2, 2)[0]
    assert not torch.equal(naive[0, 0], want[0, 1])
    # and on random streams whose LUNs wander
    for seed in range(3):
        batch = random_batch(30 + seed, 3, 200, 4, 4)
        assert_split_equals_whole(torch_args(batch), 4, 4, [])


@pytest.mark.cuda
def test_kernel_equals_plain_version_on_the_card():
    """The kernel against its plain version, bit for bit, on the card
    (padding, every op code, 1-16 LUNs and channels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the page_clock kernel has no "
                    "CPU mode (its plain version is tested above)")
    for seed, n_dev, n, n_luns, n_ch in CASES + [(9, 64, 5000, 16, 16)]:
        batch = random_batch(seed, n_dev, n, n_luns, n_ch)
        # rows stepped whole (LUNs on random channels), then the same rows
        # partitioned (every LUN on lun % n_ch: a chain a channel)
        for c in (batch[2], (batch[1] % n_ch).astype(np.int32)):
            args = torch_args(batch[:2] + (c,) + batch[3:])
            want = ref.simulate_fleet_ref(*args, n_luns, n_ch)
            before = ops.launches
            got = ops.simulate_fleet(*[a.cuda() for a in args], n_luns,
                                     n_ch)
            assert ops.launches == before + 1
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_kernel_partitions_long_streams_on_the_card():
    """Both paths over many chunks of 2048 requests: zn540's and
    custom16's channel maps, sixteen LUNs a channel (the shared-memory
    clocks), and a row whose LUNs wander (stepped whole)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the page_clock kernel has no "
                    "CPU mode (its plain version is tested above)")
    for seed, n_luns, n_ch in ((40, 4, 4), (41, 16, 8), (42, 64, 4)):
        o, l, c, v, t_op, t_x = random_batch(seed, 2, 9001, n_luns, n_ch)
        for chans in ((l % n_ch).astype(np.int32), c):
            args = torch_args((o, l, chans, v, t_op, t_x))
            want = ref.simulate_fleet_ref(*args, n_luns, n_ch)
            got = ops.simulate_fleet(*[a.cuda() for a in args], n_luns,
                                     n_ch)
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
