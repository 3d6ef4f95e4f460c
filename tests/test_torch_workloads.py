"""The port's paper benchmarks (``repro_torch.core.workloads``) held to the
JAX package's on the CPU.

The per-op benchmarks run on the port's device shim and on its
``LegacyZNSDevice`` beside the reference's on the same parameters; the
batched engine drivers beside the reference's and beside the per-op
paths (the reference's ``tests/test_engine_diff.py`` parity, on the
port).  Every metric is compared exactly: DLWA and page counts are
integers' ratios, and the throughputs come from the page-granular model,
whose plain version equals the reference's scan bit for bit
(``tests/test_torch_page_clock.py``).  The geometry is the reference
tests' tiny device (4 LUNs x 16 blocks of 4 pages) wherever a benchmark
times page streams -- the CPU path steps a page at a time -- and zn540
where no stream is timed.
"""

import numpy as np
import pytest

import repro.core.geometry as RG
import repro_torch.core.geometry as TG
from repro.core import headline as RH
from repro.core import workloads as RW
from repro.core.device import ZNSDevice as RDevice
from repro.core.device_legacy import LegacyZNSDevice as RLegacy
from repro.core.elements import BLOCK as R_BLOCK
from repro.core.elements import FIXED as R_FIXED
from repro.core.elements import SUPERBLOCK as R_SUPERBLOCK
from repro.core.geometry import FlashGeometry as RFlash
from repro.core.geometry import ZoneGeometry as RZone
from repro_torch.core import headline as TH
from repro_torch.core import workloads as TW
from repro_torch.core.device import ZNSDevice as TDevice
from repro_torch.core.device_legacy import LegacyZNSDevice as TLegacy
from repro_torch.core.elements import BLOCK as T_BLOCK
from repro_torch.core.elements import FIXED as T_FIXED
from repro_torch.core.elements import SUPERBLOCK as T_SUPERBLOCK
from repro_torch.core.geometry import FlashGeometry as TFlash
from repro_torch.core.geometry import ZoneGeometry as TZone

#: the reference array/fleet tests' tiny device: 8 zones of 32 pages
TINY = dict(n_channels=4, ways_per_channel=1, blocks_per_lun=16,
            pages_per_block=4, page_bytes=4096)
ZONE = dict(parallelism=4, n_segments=2)
SPECS = {"superblock": (R_SUPERBLOCK, T_SUPERBLOCK),
         "fixed": (R_FIXED, T_FIXED), "block": (R_BLOCK, T_BLOCK)}


def geoms(tiny=True):
    if tiny:
        return ((RFlash(**TINY), RZone(**ZONE)),
                (TFlash(**TINY), TZone(**ZONE)))
    return RG.zn540(), TG.zn540()


def devices(kind, spec, *, tiny=True, max_active=8, **kw):
    """(reference device, port device) of ``kind`` "shim" or "legacy"."""
    (rf, rz), (tf, tz) = geoms(tiny)
    r_spec, t_spec = SPECS[spec]
    r_cls, t_cls = ((RDevice, TDevice) if kind == "shim"
                    else (RLegacy, TLegacy))
    return (r_cls(rf, rz, r_spec, max_active=max_active, **kw),
            t_cls(tf, tz, t_spec, max_active=max_active, device="cpu",
                  **kw))


def engines(spec, *, tiny=True, max_active=8):
    (rf, rz), (tf, tz) = geoms(tiny)
    r_spec, t_spec = SPECS[spec]
    return (RW.make_engine(rf, rz, r_spec, max_active=max_active),
            TW.make_engine(tf, tz, t_spec, max_active=max_active,
                           device="cpu"))


@pytest.mark.parametrize("kind", ["shim", "legacy"])
@pytest.mark.parametrize("spec", ["superblock", "fixed"])
def test_dlwa_benchmark_equals_the_reference(kind, spec):
    """At zn540: no page stream is timed."""
    for occ in (0.1, 0.5):
        r, t = devices(kind, spec, tiny=False, max_active=28)
        a = RW.dlwa_benchmark(r, occupancy=occ, n_zones=2)
        b = TW.dlwa_benchmark(t, occupancy=occ, n_zones=2)
        assert a == b, occ


@pytest.mark.parametrize("kind", ["shim", "legacy"])
@pytest.mark.parametrize("spec", ["superblock", "fixed", "block"])
def test_interference_benchmark_equals_the_reference(kind, spec):
    for c in (1, 2, 3):
        r, t = devices(kind, spec)
        a = RW.interference_benchmark(r, concurrency=c)
        b = TW.interference_benchmark(t, concurrency=c)
        assert a == b, c
    r, t = devices(kind, spec)
    assert (RW.interference_benchmark(r, concurrency=2,
                                      fill_occupancy=0.7,
                                      host_pages_per_zone=5)
            == TW.interference_benchmark(t, concurrency=2,
                                         fill_occupancy=0.7,
                                         host_pages_per_zone=5))


@pytest.mark.parametrize("kind", ["shim", "legacy"])
@pytest.mark.parametrize("spec", ["superblock", "fixed"])
def test_write_benchmark_equals_the_reference(kind, spec):
    for req, jobs in ((4, 1), (8, 3), (64, 2)):
        r, t = devices(kind, spec)
        a = RW.write_benchmark(r, request_kib=req, n_jobs=jobs,
                               mib_per_job=1)
        b = TW.write_benchmark(t, request_kib=req, n_jobs=jobs,
                               mib_per_job=1)
        assert a == b, (req, jobs)


@pytest.mark.parametrize("spec", ["superblock", "fixed", "block"])
def test_op_traces_equal_the_reference(spec):
    """The per-op IO streams rebuilt from an executed program."""
    reng, teng = engines(spec)
    prog = RW.interference_program(reng, concurrency=2)
    assert np.array_equal(prog, TW.interference_program(teng,
                                                        concurrency=2))
    _, r_trace = reng.run(reng.init_state(), prog)
    _, t_trace = teng.run(teng.init_state(), prog)
    want = RW._op_traces(reng, prog, r_trace)
    got = TW._op_traces(teng, prog, t_trace)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.op == b.op and np.array_equal(a.luns, b.luns) \
                and np.array_equal(a.channels, b.channels)


@pytest.mark.parametrize("spec", ["superblock", "fixed"])
def test_interference_engine_drivers_equal_the_reference(spec):
    """The one-dispatch driver and the padded sweep: the reference's
    numbers, the per-point driver's, and the legacy device's."""
    reng, teng = engines(spec)
    concs = [1, 2, 3]
    sweep = TW.interference_sweep_engine(teng, concs)
    assert sweep == RW.interference_sweep_engine(reng, concs)
    for c, row in zip(concs, sweep):
        assert row == TW.interference_benchmark_engine(teng, concurrency=c)
        assert row == RW.interference_benchmark_engine(reng, concurrency=c)
        _, leg = devices("legacy", spec)
        assert row == TW.interference_benchmark(leg, concurrency=c)


@pytest.mark.parametrize("spec", ["superblock", "fixed"])
def test_write_benchmark_engine_equals_the_reference(spec):
    reng, teng = engines(spec)
    for req, jobs in ((4, 1), (16, 4)):
        kw = dict(request_kib=req, n_jobs=jobs, mib_per_job=1)
        got = TW.write_benchmark_engine(teng, **kw)
        assert got == RW.write_benchmark_engine(reng, **kw)
        _, leg = devices("legacy", spec)
        assert got == TW.write_benchmark(leg, **kw)


@pytest.mark.parametrize("kind", ["shim", "legacy"])
@pytest.mark.parametrize("spec", ["superblock", "fixed", "block"])
def test_alloc_latency_benchmark_matches_the_reference(kind, spec):
    """Keys and sample counts (latencies are this host's clock); the
    device is left as the reference's."""
    r, t = devices(kind, spec)
    a = RW.alloc_latency_benchmark(r, n_allocs=8)
    b = TW.alloc_latency_benchmark(t, n_allocs=8)
    assert sorted(a) == sorted(b) == ["mean_us", "median_us", "n_allocs"]
    assert a["n_allocs"] == b["n_allocs"] == 8.0
    assert len(t.alloc_latencies_us) == 8
    assert np.array_equal(r.elem_wear, t.elem_wear)
    assert r.block_erases == t.block_erases


def test_engine_vs_legacy_speedup_on_a_tiny_device(monkeypatch):
    """The comparator end to end with zn540 swapped for the tiny device
    (its asserts hold the two paths' DLWA and dummy pages to each other
    inside): the reference's counts and keys, no plan growth."""
    tiny = lambda: (TFlash(**TINY), TZone(**ZONE))       # noqa: E731
    r_tiny = lambda: (RFlash(**TINY), RZone(**ZONE))     # noqa: E731
    monkeypatch.setattr(TG, "zn540", tiny)
    monkeypatch.setattr(RG, "zn540", r_tiny)
    kw = dict(occupancies=(0.1, 0.5, 0.9), n_zones=3,
              concurrencies=(1, 2), repeats=1)
    got = TW.engine_vs_legacy_speedup(device="cpu", **kw)
    want = RW.engine_vs_legacy_speedup(**kw)
    assert sorted(got) == sorted(want)
    for k in ("dlwa_ops", "interference_ops", "interference_dispatches",
              "interference_recompiles"):
        assert got[k] == want[k], k
    assert got["interference_recompiles"] == 0.0
    assert all(v > 0 for k, v in got.items() if k.endswith("_s"))


@pytest.mark.parametrize("spec", ["superblock", "fixed"])
def test_program_drivers_equal_the_legacy_metrics(spec):
    """The reference's program-vs-legacy parity on the port: the DLWA
    program (wear histogram too) at zn540, the interference and write
    programs on the tiny device, and the shims' trace streams."""
    (_, _), (flash, zone) = geoms(tiny=False)
    t_spec = SPECS[spec][1]
    eng = TW.make_engine(flash, zone, t_spec, max_active=28, device="cpu")
    for occ in (0.1, 0.9):
        leg = TLegacy(flash, zone, t_spec, max_active=28, device="cpu")
        assert (TW.dlwa_benchmark(leg, occupancy=occ, n_zones=3)
                == TW.dlwa_benchmark_engine(eng, occupancy=occ, n_zones=3))
        state, _ = eng.run(eng.init_state(),
                           TW.dlwa_program(eng, occupancy=occ, n_zones=3))
        assert np.array_equal(eng.block_wear(state), leg.block_wear())
    assert (TW.dlwa_sweep_engine(eng, (0.1, 0.9), n_zones=3)
            == [TW.dlwa_benchmark_engine(eng, occupancy=o, n_zones=3)
                for o in (0.1, 0.9)])
    _, shim = devices("shim", spec)
    _, leg = devices("legacy", spec)
    for z in range(3):
        fill = max(1, int(shim.zone_pages * (0.2 + 0.3 * z)))
        t1 = shim.zone_write(z, fill, trace=True)
        t2 = leg.zone_write(z, fill, trace=True)
        assert np.array_equal(t1.luns, t2.luns)
        assert np.array_equal(t1.channels, t2.channels)
        f1, f2 = shim.zone_finish(z, trace=True), leg.zone_finish(z,
                                                                  trace=True)
        assert (f1 is None) == (f2 is None)
        if f1 is not None:
            assert np.array_equal(f1.luns, f2.luns)
            assert np.array_equal(f1.channels, f2.channels)


def test_headline_dlwa_matches_the_legacy_oracle():
    """The paired traditional/silent headline figure per occupancy point
    against per-op legacy oracles (the whole-zone hchunk spec and
    BLOCK), as the reference's test holds its own."""
    flash = TFlash(n_channels=4, ways_per_channel=1, blocks_per_lun=8,
                   pages_per_block=4, page_bytes=4096)
    zone = TZone(**ZONE)
    eng = TH.build_headline_engine(flash, zone, max_active=3, device="cpu")
    occs = (0.1, 0.5, 0.9)
    fig = TH.dlwa_figure(eng, occs, n_zones=2)
    r_eng = RH.build_headline_engine(
        RFlash(n_channels=4, ways_per_channel=1, blocks_per_lun=8,
               pages_per_block=4, page_bytes=4096), RZone(**ZONE),
        max_active=3)
    assert fig == RH.dlwa_figure(r_eng, occs, n_zones=2)
    for key, spec in (("traditional_dlwa", TH.traditional_spec(zone)),
                      ("silent_dlwa", T_BLOCK)):
        for i, occ in enumerate(occs):
            leg = TLegacy(flash, zone, spec, max_active=3, device="cpu")
            ref = TW.dlwa_benchmark(leg, occupancy=occ, n_zones=2)
            assert fig[key][i] == ref["dlwa"], (key, occ)


def test_make_device_builds_the_shim_on_the_given_device():
    (_, _), (flash, zone) = geoms()
    dev = TW.make_device(flash, zone, T_SUPERBLOCK, max_active=5,
                         device="cpu")
    assert isinstance(dev, TDevice) and dev.max_active == 5
    assert str(dev.device) == "cpu"
