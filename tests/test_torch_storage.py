"""The port's storage front ends, traffic generators and RAID array held
to the JAX package on the CPU.

* ``storage/traffic.py``: identical streams for the same seeds and
  parameters, and the same validation errors;
* ``ZoneFS`` + ``LSMSimulator``, checkpoint schedules and ``FlashCache``
  over each package's ``ZNSDevice`` give identical ``report()``\\ s and
  device counters, and the same traffic on each package's
  ``RecordingBackend`` records identical programs;
* ``array/raid.py``'s ``ZNSArray`` over the port's devices: a small
  striped stream with parity, degraded reads and a rebuild gives the
  reference's reports and tagged IO streams, and ``run_fleet_trace``
  over them agrees at rel 1e-5.
"""

import numpy as np
import pytest

import repro.storage as RS
import repro_torch.storage as TS
from repro.array import ArrayGeometry as RGeom
from repro.array import ZNSArray as RArray
from repro.array import raid as RRaid
from repro.core import timing as RT
from repro.core.device import ZNSDevice as RDevice
from repro.core.elements import BLOCK as R_BLOCK
from repro.core.elements import FIXED as R_FIXED
from repro.core.elements import SUPERBLOCK as R_SUPERBLOCK
from repro.core.geometry import FlashGeometry as RFlash
from repro.core.geometry import ZoneGeometry as RZone
from repro.core.geometry import zn540 as r_zn540
from repro_torch.array import ArrayGeometry as TGeom
from repro_torch.array import ZNSArray as TArray
from repro_torch.array import raid as TRaid
from repro_torch.core import timing as TT
from repro_torch.core.device import ZNSDevice as TDevice
from repro_torch.core.elements import BLOCK as T_BLOCK
from repro_torch.core.elements import FIXED as T_FIXED
from repro_torch.core.elements import SUPERBLOCK as T_SUPERBLOCK
from repro_torch.core.geometry import FlashGeometry as TFlash
from repro_torch.core.geometry import ZoneGeometry as TZone
from repro_torch.core.geometry import zn540 as t_zn540

SPECS = {"block": (R_BLOCK, T_BLOCK), "superblock": (R_SUPERBLOCK,
                                                     T_SUPERBLOCK),
         "fixed": (R_FIXED, T_FIXED)}
#: ``tests/test_trace_compile.py``'s mid device: 8 zones of 32 pages
MID = dict(n_channels=4, ways_per_channel=1, blocks_per_lun=16,
           pages_per_block=4, page_bytes=4096)
TIME_REL = 1e-5


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except (ValueError, RuntimeError, IndexError) as e:
        return type(e).__name__, str(e)


# --------------------------------------------------------------------- #
# traffic
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_traffic_streams_are_the_reference_streams(seed):
    cases = [
        ("zipf_weights", (50, 1.2), {}),
        ("zipfian_keys", (500, 64), {"skew": 1.1, "seed": seed}),
        ("zipfian_keys", (300, 7), {"skew": 0.0, "seed": seed}),
        ("zipfian_tenants", (400, 3), {"skew": 1.0, "seed": seed}),
        ("diurnal_load", (50,), {"base": 3, "peak": 40, "period": 12,
                                 "phase": 0.25}),
        ("diurnal_load", (50,), {"base": 3, "peak": 40, "seed": seed,
                                 "jitter": 0.3}),
        ("burst_arrivals", (60,), {"rate": 2, "burst_prob": 0.3,
                                   "burst_len": 4, "burst_mult": 6,
                                   "seed": seed}),
    ]
    for name, args, kw in cases:
        want = getattr(RS, name)(*args, **kw)
        got = getattr(TS, name)(*args, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert np.array_equal(TS.kvbench_mix(5000, seed), RS.kvbench_mix(5000,
                                                                    seed))


@pytest.mark.parametrize("name,args,kw", [
    ("zipf_weights", (0, 1.0), {}), ("zipf_weights", (5, -1.0), {}),
    ("diurnal_load", (5,), {"base": 9, "peak": 2}),
    ("diurnal_load", (5,), {"base": 1, "peak": 2, "jitter": 0.1}),
    ("burst_arrivals", (5,), {"rate": 1, "burst_prob": 1.5}),
])
def test_traffic_validation_matches_the_reference(name, args, kw):
    want = _outcome(getattr(RS, name), *args, **kw)
    assert want[0] == "ValueError"
    assert _outcome(getattr(TS, name), *args, **kw) == want


# --------------------------------------------------------------------- #
# front ends over each package's device
# --------------------------------------------------------------------- #
def mid_devices(spec, max_active=6):
    r_spec, t_spec = SPECS[spec]
    zg = dict(parallelism=4, n_segments=2)
    return (RDevice(RFlash(**MID), RZone(**zg), r_spec,
                    max_active=max_active),
            TDevice(TFlash(**MID), TZone(**zg), t_spec,
                    max_active=max_active, device="cpu"))


def assert_same_counters(r, t):
    for name in ("host_pages", "dummy_pages", "block_erases", "alloc_calls",
                 "dlwa", "n_active"):
        assert getattr(t, name) == getattr(r, name), name
    assert np.array_equal(t.elem_wear, r.elem_wear)
    assert np.array_equal(t.elem_avail, r.elem_avail)


@pytest.mark.parametrize("spec", ["block", "superblock", "fixed"])
@pytest.mark.parametrize("thresh", [0.1, 0.6])
def test_lsm_over_zonefs_reports_like_the_reference(spec, thresh):
    reports = []
    for dev in mid_devices(spec):
        cfg = (RS if isinstance(dev, RDevice) else TS).scaled_kv_config(
            dev.zone_pages, dev.flash.page_bytes, seed=3, n_flushes=6,
            max_jobs=2)
        S = RS if isinstance(dev, RDevice) else TS
        sim = S.LSMSimulator(S.ZoneFS(dev, finish_threshold=thresh), cfg)
        reports.append((sim.run(), sim.fs.stats, dev))
    (want, r_stats, r), (got, t_stats, t) = reports
    assert got == want
    assert want["failed"] == 0.0 and want["host_pages"] > 0
    assert t_stats.__dict__ == r_stats.__dict__
    assert_same_counters(r, t)


def test_lsm_over_zonefs_at_zn540_reports_like_the_reference():
    reports = []
    for S, geo, spec, Dev in ((RS, r_zn540, R_BLOCK, RDevice),
                              (TS, t_zn540, T_BLOCK, TDevice)):
        kw = {} if Dev is RDevice else {"device": "cpu"}
        dev = Dev(*geo(), spec, max_active=14, **kw)
        cfg = S.scaled_kv_config(dev.zone_pages, dev.flash.page_bytes,
                                 seed=0, n_flushes=4, max_jobs=2)
        reports.append((S.LSMSimulator(S.ZoneFS(dev), cfg).run(), dev))
    assert reports[1][0] == reports[0][0]
    assert_same_counters(reports[0][1], reports[1][1])


@pytest.mark.parametrize("spec", ["block", "superblock"])
def test_checkpoints_and_cache_over_the_device_match_the_reference(spec):
    out = []
    for dev in mid_devices(spec):
        S = RS if isinstance(dev, RDevice) else TS
        fs = S.record_checkpoints(dev, S.CheckpointSchedule(
            n_steps=6, shards=2, keep=2, seed=1))
        out.append((fs.report(), fs.stats.__dict__))
    assert out[1] == out[0]
    out = []
    for dev in mid_devices(spec):
        S = RS if isinstance(dev, RDevice) else TS
        cache = S.record_cache(dev, n_accesses=300, n_keys=40, skew=1.2,
                               seed=2, capacity_zones=5, obj_pages=4)
        out.append((cache.report(), dev))
    assert out[1][0] == out[0][0]
    assert_same_counters(out[0][1], out[1][1])


@pytest.mark.parametrize("seed", [0, 5])
def test_recorders_record_the_reference_programs(seed):
    """The same front-end traffic on each package's recorder: the same
    rows, the same control-plane view, the same stream-class tags."""
    for name in ("lsm", "ckpt", "cache"):
        progs = []
        for S in (RS, TS):
            rec = S.RecordingBackend(
                S.compile._mix_flash(4096), zone_pages=32, n_zones=8,
                max_active=6,
                class_tenants={c: i for i, c in
                               enumerate(S.WORKLOADS[name])})
            S.compile._drive(name, rec, seed % 2)
            progs.append((rec.program(), rec.host_pages, rec.n_active,
                          rec.dlwa, rec.dummy_pages))
        assert np.array_equal(progs[1][0], progs[0][0]), name
        assert progs[1][1:] == progs[0][1:], name


def test_recorder_raises_the_device_errors():
    for S in (RS, TS):
        rec = S.RecordingBackend(S.compile._mix_flash(4096), zone_pages=8,
                                 n_zones=3, max_active=1)
        rec.zone_write(0, 8)
        got = [_outcome(rec.zone_write, 0, 1), _outcome(rec.zone_write, 1, 9),
               _outcome(rec.zone_write, 2, 1),
               _outcome(rec.zone_read, 2, np.arange(2)),
               _outcome(rec.zone_write, 5, 1),
               _outcome(S.RecordingBackend, rec.flash, zone_pages=0,
                        n_zones=1),
               _outcome(rec.result)]
        if S is RS:
            want = got
    assert got == want
    assert [g[0] for g in got] == ["RuntimeError", "RuntimeError",
                                   "RuntimeError", "RuntimeError",
                                   "IndexError", "ValueError",
                                   "RuntimeError"]


# --------------------------------------------------------------------- #
# the RAID array over the port's devices
# --------------------------------------------------------------------- #
def arrays(n_devices=3, parity=True, chunk_pages=8):
    zg = dict(parallelism=4, n_segments=2)
    return (RArray.build(RFlash(**MID), RZone(**zg), R_SUPERBLOCK,
                         n_devices=n_devices, chunk_pages=chunk_pages,
                         parity=parity, max_active=6),
            TArray.build(TFlash(**MID), TZone(**zg), T_SUPERBLOCK,
                         n_devices=n_devices, chunk_pages=chunk_pages,
                         parity=parity, max_active=6, device="cpu"))


def same_tagged(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return len(a) == len(b) and all(
        i == j and x.op == y.op and np.array_equal(x.luns, y.luns)
        and np.array_equal(x.channels, y.channels)
        for (i, x), (j, y) in zip(a, b))


def test_striped_array_matches_the_reference():
    r, t = arrays()
    assert t.zone_pages == r.zone_pages == 64
    script = [("zone_write", (0, 20), {"trace": True}),
              ("zone_write", (1, 64), {"trace": True}),
              ("zone_write", (0, 7), {"trace": True, "host": False}),
              ("zone_read", (0, np.arange(0, 27, 3)), {}),
              ("zone_finish", (0,), {"trace": True}),
              ("zone_write", (2, 65), {}),
              ("zone_write", (1, 1), {}),
              ("fail_device", (1,), {}),
              ("zone_read", (0, np.arange(0, 27, 2)), {}),
              ("zone_read", (1, np.arange(0, 64, 5)), {}),
              ("zone_write", (3, 10), {}),
              ("zone_read", (3, np.arange(10)), {}),
              ("rebuild_device", (1,), {}),
              ("zone_read", (1, np.arange(0, 64, 7)), {}),
              ("zone_reset", (0,), {}),
              ("zone_write", (0, 16), {"trace": True})]
    tagged = {"r": [], "t": []}
    for name, args, kw in script:
        a = _outcome(getattr(r, name), *args, **kw)
        b = _outcome(getattr(t, name), *args, **kw)
        assert a[0] == b[0], name
        if a[0] != "ok":
            assert a[1] == b[1], name
        else:
            assert same_tagged(a[1], b[1]), name
            if isinstance(a[1], list):
                tagged["r"] += a[1]
                tagged["t"] += b[1]
    assert t.report() == r.report()
    assert t.device_reports() == r.device_reports()
    assert t.n_active == r.n_active and t.failed == r.failed
    for z in range(r.n_zones):
        assert t.zones[z].__dict__.keys() == r.zones[z].__dict__.keys()
        assert (t.zones[z].state.name, t.zones[z].wp, t.zones[z].host_wp,
                t.zones[z].parity_emitted) == (
            r.zones[z].state.name, r.zones[z].wp, r.zones[z].host_wp,
            r.zones[z].parity_emitted)
    want = RT.run_fleet_trace(r.flash, RT.group_tagged(tagged["r"], 3))
    got = TT.run_fleet_trace(t.flash, TT.group_tagged(tagged["t"], 3),
                             device="cpu")
    assert sorted(got) == sorted(want) and want["n"] > 0
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=TIME_REL, abs=0), k


def test_array_stripe_math_and_validation_match_the_reference():
    for args in [(0, 0, 8, 2, 3, True), (1, 37, 8, 2, 3, True),
                 (2, 95, 4, 3, 3, False), (5, 200, 16, 4, 5, True)]:
        assert TRaid.locate_page(*args) == RRaid.locate_page(*args)
    for z, s, n in [(0, 0, 3), (4, 7, 5), (9, 2, 2)]:
        assert TRaid.parity_device_of(z, s, n) == \
            RRaid.parity_device_of(z, s, n)
        for slot in range(n - 1):
            assert TRaid.data_device_of(z, s, slot, n, True) == \
                RRaid.data_device_of(z, s, slot, n, True)
    for kw in ({"n_devices": 0, "chunk_pages": 4},
               {"n_devices": 1, "chunk_pages": 4, "parity": True},
               {"n_devices": 2, "chunk_pages": 0}):
        assert _outcome(TGeom, **kw) == _outcome(RGeom, **kw)
    zg = dict(parallelism=4, n_segments=2)
    want = _outcome(RArray.build, RFlash(**MID), RZone(**zg), R_SUPERBLOCK,
                    n_devices=2, chunk_pages=7)
    assert want[0] == "ValueError"
    assert _outcome(TArray.build, TFlash(**MID), TZone(**zg), T_SUPERBLOCK,
                    n_devices=2, chunk_pages=7, device="cpu") == want
    r, t = arrays(n_devices=2, parity=False)
    r.zone_write(0, 16)
    t.zone_write(0, 16)
    assert _outcome(t.rebuild_device, 0) == _outcome(r.rebuild_device, 0)
    r.fail_device(1)
    t.fail_device(1)
    assert _outcome(t.zone_read, 0, np.arange(16)) == _outcome(
        r.zone_read, 0, np.arange(16))
