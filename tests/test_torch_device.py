"""The port's device shim, metrics and trace timing held to the JAX
package on the CPU.

The command streams of ``tests/test_engine_diff.py`` (random WRITE /
FINISH / RESET sequences with overflowing and dummy writes, reads of
mapped and unmapped zones) go through ``repro.core.device.ZNSDevice`` and
``repro_torch.core.device.ZNSDevice(device="cpu")`` side by side: every
command must succeed or raise the same ``RuntimeError`` string, and the
data plane, the ``ZoneInfo`` mirror, the counters and every
``trace=True`` IO stream must be identical.  ``SATracker`` /
``wear_report`` agree exactly; ``run_trace`` / ``run_fleet_trace`` over
the shims' streams at rel 1e-5 (f32 clocks).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import engine as RE
from repro.core import metrics as RM
from repro.core import timing as RT
from repro.core.device import ZNSDevice as RDevice
from repro.core.elements import BLOCK as R_BLOCK
from repro.core.elements import FIXED as R_FIXED
from repro.core.elements import SUPERBLOCK as R_SUPERBLOCK
from repro.core.elements import hchunk as r_hchunk
from repro.core.elements import vchunk as r_vchunk
from repro.core.geometry import FlashGeometry as RFlash
from repro.core.geometry import ZoneGeometry as RZone
from repro_torch.core import engine as TE
from repro_torch.core import metrics as TM
from repro_torch.core import timing as TT
from repro_torch.core.device import ZNSDevice as TDevice
from repro_torch.core.elements import BLOCK as T_BLOCK
from repro_torch.core.elements import FIXED as T_FIXED
from repro_torch.core.elements import SUPERBLOCK as T_SUPERBLOCK
from repro_torch.core.elements import hchunk as t_hchunk
from repro_torch.core.elements import vchunk as t_vchunk
from repro_torch.core.geometry import FlashGeometry as TFlash
from repro_torch.core.geometry import ZoneGeometry as TZone

SPECS = [(R_BLOCK, T_BLOCK), (r_vchunk(2), t_vchunk(2)),
         (r_hchunk(2), t_hchunk(2)), (R_SUPERBLOCK, T_SUPERBLOCK),
         (R_FIXED, T_FIXED)]
TIME_REL = 1e-5
FLASH = dict(n_channels=4, ways_per_channel=1, blocks_per_lun=8,
             pages_per_block=4, page_bytes=4096)


def devices(spec_i, max_active=3, **kw):
    """The reference shim and the port's, on ``tests/test_engine_diff``'s
    tiny device (4 LUNs x 8 blocks, 2-segment zones of 32 pages)."""
    r_spec, t_spec = SPECS[spec_i]
    zone = dict(parallelism=4, n_segments=2)
    return (RDevice(RFlash(**FLASH), RZone(**zone), r_spec,
                    max_active=max_active, **kw),
            TDevice(TFlash(**FLASH), TZone(**zone), t_spec,
                    max_active=max_active, device="cpu", **kw))


def outcome(fn, *args, **kw):
    """``("ok", result)`` or ``("err", message)``."""
    try:
        return "ok", fn(*args, **kw)
    except RuntimeError as e:
        return "err", str(e)


def same_iotrace(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return (a.op == b.op and np.array_equal(a.luns, b.luns)
            and np.array_equal(a.channels, b.channels)
            and a.luns.dtype == b.luns.dtype)


def assert_same_device(r, t, ctx=""):
    for name in ("elem_wear", "elem_avail", "elem_pages", "elem_zone"):
        a, b = getattr(r, name), getattr(t, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{name} {ctx}"
    for name, leaf in zip(RE.DeviceState._fields, r.state):
        assert np.array_equal(np.asarray(leaf),
                              getattr(t.state, name).numpy()), \
            f"state.{name} {ctx}"
    for name in ("host_pages", "dummy_pages", "block_erases", "alloc_calls",
                 "dlwa", "n_active"):
        assert getattr(r, name) == getattr(t, name), f"{name} {ctx}"
    assert r.pending_erases() == t.pending_erases(), ctx
    assert np.array_equal(r.block_wear(), t.block_wear()), ctx
    for z in range(r.n_zones):
        a, b = r.zones[z], t.zones[z]
        assert (a.state.name, a.wp, a.host_wp) == \
            (b.state.name, b.wp, b.host_wp), f"zone {z} {ctx}"
        for field in ("elements", "column_luns"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None), f"zone {z} {field} {ctx}"
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), \
                    f"zone {z} {field} {ctx}"


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, len(SPECS) - 1))
def test_random_command_streams_match_the_reference(seed, spec_i):
    """``test_differential_random_op_sequences``' streams, plus dummy
    writes and reads, with ``trace=True`` on every command that has it:
    the same outcome (error strings included), the same IO streams, and
    the same device after every command."""
    r, t = devices(spec_i)
    rng = np.random.default_rng(seed)
    for i in range(24):
        op = int(rng.integers(0, 4))
        z = int(rng.integers(0, 4))
        n = int(rng.integers(1, r.zone_pages + 2))   # may overflow
        host = bool(rng.random() < 0.8)
        pages = rng.integers(0, r.zone_pages, 3)
        got = []
        for d in (r, t):
            if op == 0:
                got.append(outcome(d.zone_write, z, n, host=host,
                                   trace=True))
            elif op == 1:
                got.append(outcome(d.zone_finish, z, trace=True))
            elif op == 2:
                got.append(outcome(d.zone_reset, z))
            else:
                got.append(outcome(d.zone_read, z, pages))
        ctx = f"seed={seed} spec={SPECS[spec_i][0].name} i={i} op={op}"
        assert got[0][0] == got[1][0], ctx
        if got[0][0] == "err":
            assert got[0][1] == got[1][1], ctx
        else:
            assert same_iotrace(got[0][1], got[1][1]), ctx
        assert_same_device(r, t, ctx)


@pytest.mark.parametrize("spec_i", range(len(SPECS)),
                         ids=[s.name for s, _ in SPECS])
def test_shim_errors_match_the_reference_string_for_string(spec_i):
    """FULL, overflow, the active-zone limit and an unmapped read, in
    that order, then writes to every zone."""
    r, t = devices(spec_i, max_active=1)
    zp = r.zone_pages
    script = [("zone_write", (0, zp)), ("zone_write", (0, 1)),
              ("zone_write", (1, zp + 1)), ("zone_write", (2, 1)),
              ("zone_read", (3, np.arange(2))), ("zone_reset", (0,)),
              ("zone_finish", (2,)), ("zone_write", (1, 4)),
              ("zone_finish", (1,)), ("zone_finish", (1,))]
    n_err = 0
    for name, args in script:
        a = outcome(getattr(r, name), *args)
        b = outcome(getattr(t, name), *args)
        assert a[0] == b[0], name
        if a[0] == "err":
            n_err += 1
            assert a[1] == b[1], name
    assert n_err >= 3
    assert_same_device(r, t)
    # every zone open at once, then a write past the first one's end
    r, t = devices(spec_i, max_active=r.n_zones)
    msgs = []
    for d in (r, t):
        for z in range(d.n_zones):
            d.zone_write(z, 1)
        msgs.append(outcome(d.zone_write, 0, d.zone_pages))
    assert msgs[0] == msgs[1]


def test_shim_state_equals_the_replay_of_its_recorded_commands():
    """The shim's per-command path and one ``run_program`` dispatch of
    the same commands, recorded, leave the same state -- the reference's
    claim that replay is bit-identical to the per-op path."""
    from repro_torch.storage import RecordingBackend
    _, t = devices(3)
    rec = RecordingBackend(t.flash, zone_pages=t.zone_pages,
                           n_zones=t.n_zones, max_active=t.max_active)
    for d in (t, rec):
        d.zone_write(0, 5)
        d.zone_write(1, 32)
        d.zone_finish(0)
        d.zone_reset(1)
        d.zone_write(1, 7, host=False)
        d.zone_write(2, 3)
        d.zone_read(2, np.arange(2))
        d.zone_finish(3)
    eng = t.engine
    state, trace = eng.run(eng.init_state(), rec.program())
    assert bool(trace.ok.all())
    for a, b, name in zip(state, t.state, TE.DeviceState._fields):
        assert torch.equal(a, b), name


def test_apply_op_steps_lanes_like_run_programs():
    """``apply_op`` on lane-batched rows (one row per lane, per-lane
    dyns) equals ``run_programs`` step by step, and on one device's row
    equals the reference's ``apply_op``."""
    _, t = devices(0)
    eng = t.engine
    rng = np.random.default_rng(4)
    programs = np.zeros((3, 10, 4), np.int32)
    programs[:, :, 0] = rng.integers(1, 5, (3, 10))
    programs[:, :, 1] = rng.integers(0, 4, (3, 10))
    programs[:, :, 2] = rng.integers(0, 20, (3, 10))
    programs[:, :, 3] = 1
    dyn = TE.stack_dyn([eng.dyn(), eng.dyn(alloc_policy="silent"),
                        eng.dyn(zone_pages=16)])
    want, want_trace = eng.run_batch(eng.init_state(), programs, dyn)
    state = TE.DeviceState(*[x.expand((3,) + x.shape).contiguous()
                             for x in eng.init_state()])
    for i in range(programs.shape[1]):
        state, tr = TE.apply_op(eng.cfg, state, programs[:, i], dyn)
        for a, b in zip(tr, want_trace):
            assert torch.equal(a, b[:, i])
    for a, b in zip(state, want):
        assert torch.equal(a, b)
    r, _ = devices(0)
    r_state, t_state = r.engine.init_state(), eng.init_state()
    for row in programs[1]:
        r_state, r_tr = RE.apply_op(r.engine.cfg, r_state, row,
                                    r.engine.dyn(alloc_policy="silent"))
        t_state, t_tr = eng.apply(t_state, row,
                                  eng.dyn(alloc_policy="silent"))
        for a, b in zip(r_tr, t_tr):
            assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(r_state, t_state):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("spec_i", range(len(SPECS)),
                         ids=[s.name for s, _ in SPECS])
def test_op_stream_rebuilds_the_reference_streams(spec_i):
    r, t = devices(spec_i)
    rows = TE.encode_program([(TE.OP_WRITE, 0, 9, 1), (TE.OP_FINISH, 0, 0, 0),
                              (TE.OP_WRITE, 1, 32, 1), (TE.OP_WRITE, 2, 3, 1),
                              (TE.OP_FINISH, 2, 0, 0), (TE.OP_RESET, 0, 0, 0)])
    _, r_tr = r.engine.run(r.engine.init_state(), rows)
    _, t_tr = t.engine.run(t.engine.init_state(), rows)
    n = 0
    for i in range(len(rows)):
        args = [(int(tr.op[i]), int(tr.wp_before[i]), int(tr.wp_after[i]),
                 int(tr.dummy_delta[i]), np.asarray(tr.elems[i]),
                 np.asarray(tr.cols[i])) for tr in (r_tr, t_tr)]
        a = r.engine.op_stream(*args[0])
        b = t.engine.op_stream(*args[1])
        assert (a is None) == (b is None), i
        if a is not None:
            n += 1
            assert a[2] == b[2]
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert n >= 3


def test_warmup_leaves_the_device_untouched():
    _, t = devices(0)
    t.zone_write(0, 3)
    before = [x.clone() for x in t.state]
    t.warmup_alloc()
    for a, b in zip(before, t.state):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# metrics
# --------------------------------------------------------------------- #
def test_wear_report_and_sa_tracker_match_the_reference():
    r, t = devices(1, max_active=4)
    for d in (r, t):
        for cycle in range(3):
            for z in range(4):
                d.zone_write(z, 5 + 3 * z + cycle)
                d.zone_finish(z)
            for z in range(4):
                d.zone_reset(z)
        d.zone_write(1, 7)
    assert TM.wear_report(t) == RM.wear_report(r)
    assert RM.wear_report(r)["total_block_erases"] > 0
    trackers = (RM.SATracker(), TM.SATracker())
    for s in trackers:
        s.on_host_write(4096.0 * 10)
        s.sample()
        s.on_invalidate(4096.0 * 3)
        s.sample()
        s.on_reclaim(4096.0 * 2)
        s.on_invalidate(1e9)
        s.sample()
    assert trackers[1].sa == trackers[0].sa
    assert TM.dlwa(100, 25) == RM.dlwa(100, 25) and TM.dlwa(0, 5) == 1.0
    assert TM.interference_factor(3.0, 2.0) == RM.interference_factor(3.0,
                                                                       2.0)
    assert TM.interference_factor(3.0, 0.0) == float("inf")


# --------------------------------------------------------------------- #
# page-granular timing over the shims' IO streams
# --------------------------------------------------------------------- #
def _streams(d, zone0: int):
    """A host write, a read and FINISH padding of one zone: three
    concurrent streams."""
    w = d.zone_write(zone0, 13, trace=True)
    rd = d.zone_read(zone0, np.arange(0, 13, 2))
    pad = d.zone_finish(zone0, trace=True)
    return [w, rd, pad]


@pytest.mark.parametrize("interleave", [True, False])
def test_run_trace_matches_the_reference(interleave):
    r, t = devices(0)
    r_tr, t_tr = _streams(r, 0), _streams(t, 0)
    want = RT.run_trace(r.flash, r_tr, interleave=interleave)
    got = TT.run_trace(t.flash, t_tr, interleave=interleave, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=TIME_REL, abs=0), k
    assert got["n"] == want["n"] > 0
    assert TT.write_bandwidth_mib_s(t.flash, got, owner=0) == pytest.approx(
        RT.write_bandwidth_mib_s(r.flash, want, owner=0), rel=TIME_REL)
    assert TT.run_trace(t.flash, [], device="cpu") == RT.run_trace(r.flash,
                                                                   [])


def test_run_fleet_trace_matches_the_reference():
    r0, t0 = devices(0)
    r1, t1 = devices(3)
    tagged_r = [(0, x) for x in _streams(r0, 1)] + \
        [(1, x) for x in _streams(r1, 2)]
    tagged_t = [(0, x) for x in _streams(t0, 1)] + \
        [(1, x) for x in _streams(t1, 2)]
    want = RT.run_fleet_trace(r0.flash,
                              RT.group_tagged(tagged_r, 3))
    got = TT.run_fleet_trace(t0.flash, TT.group_tagged(tagged_t, 3),
                             device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=TIME_REL, abs=0), k
    assert want["dev2_n"] == 0 and want["n"] > 0
    assert TT.run_fleet_trace(t0.flash, [], device="cpu") == \
        RT.run_fleet_trace(r0.flash, [])


def test_cuda_shim_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDevice(TFlash(**FLASH), TZone(parallelism=4, n_segments=2),
                T_BLOCK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.run_trace(TFlash(**FLASH), [TT.IOTrace(np.zeros(1, np.int64),
                                                  np.zeros(1, np.int64),
                                                  "write")])
