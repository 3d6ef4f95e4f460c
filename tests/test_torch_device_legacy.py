"""The port's per-op legacy device held to the JAX package's on the CPU.

``repro_torch.core.device_legacy.LegacyZNSDevice(device="cpu")`` and
``repro.core.device_legacy.LegacyZNSDevice`` take the same command
streams (``tests/test_engine_diff.py``'s random WRITE / FINISH / RESET
sequences with overflowing and dummy writes, reads, and ``trace=True``
on every command that has it) over BLOCK, vchunk(2), hchunk(2),
SUPERBLOCK and FIXED: every command succeeds or raises the same
``RuntimeError`` string, and the element state (wear, availability,
pages, zone map), the counters, the zone tables and every IO stream are
identical, exactly.  On the port alone, the reference's three-way
differential holds: the legacy device, the engine-backed shim and one
``run_program`` leave the same device.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.device_legacy import LegacyZNSDevice as RLegacy
from repro.core.elements import BLOCK as R_BLOCK
from repro.core.elements import FIXED as R_FIXED
from repro.core.elements import SUPERBLOCK as R_SUPERBLOCK
from repro.core.elements import hchunk as r_hchunk
from repro.core.elements import vchunk as r_vchunk
from repro.core.geometry import FlashGeometry as RFlash
from repro.core.geometry import ZoneGeometry as RZone
from repro_torch.core import engine as TE
from repro_torch.core.device import ZNSDevice as TDevice
from repro_torch.core.device_legacy import LegacyZNSDevice as TLegacy
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
#: ``tests/test_engine_diff.py``'s tiny device: 4 LUNs x 8 blocks of 4
#: pages, 2-segment zones of 32 pages
FLASH = dict(n_channels=4, ways_per_channel=1, blocks_per_lun=8,
             pages_per_block=4, page_bytes=4096)
ZONE = dict(parallelism=4, n_segments=2)


def legacies(spec_i, max_active=3, **kw):
    r_spec, t_spec = SPECS[spec_i]
    return (RLegacy(RFlash(**FLASH), RZone(**ZONE), r_spec,
                    max_active=max_active, **kw),
            TLegacy(TFlash(**FLASH), TZone(**ZONE), t_spec,
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
    return (a.op == b.op and a.luns.dtype == b.luns.dtype
            and np.array_equal(a.luns, b.luns)
            and np.array_equal(a.channels, b.channels))


def assert_same_legacy(r, t, ctx=""):
    """Element state, counters and zone tables identical (dtypes too)."""
    for name in ("elem_wear", "elem_avail", "elem_pages", "elem_zone"):
        a, b = getattr(r, name), getattr(t, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{name} {ctx}"
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


def run_command(d, op, z, n, host, pages):
    if op == 0:
        return outcome(d.zone_write, z, n, host=host, trace=True)
    if op == 1:
        return outcome(d.zone_finish, z, trace=True)
    if op == 2:
        return outcome(d.zone_reset, z)
    return outcome(d.zone_read, z, pages)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, len(SPECS) - 1))
def test_random_command_streams_match_the_reference(seed, spec_i):
    """Random commands, illegal ones included: the same outcome (error
    strings too), the same IO streams, the same device after each."""
    r, t = legacies(spec_i)
    rng = np.random.default_rng(seed)
    for i in range(30):
        op = int(rng.integers(0, 4))
        z = int(rng.integers(0, 4))
        n = int(rng.integers(1, r.zone_pages + 2))   # may overflow
        host = bool(rng.random() < 0.8)
        pages = rng.integers(0, r.zone_pages, 3)
        got = [run_command(d, op, z, n, host, pages) for d in (r, t)]
        ctx = f"seed={seed} spec={SPECS[spec_i][0].name} i={i} op={op}"
        assert got[0][0] == got[1][0], ctx
        if got[0][0] == "err":
            assert got[0][1] == got[1][1], ctx
        else:
            assert same_iotrace(got[0][1], got[1][1]), ctx
        assert_same_legacy(r, t, ctx)


@pytest.mark.parametrize("spec_i", range(len(SPECS)),
                         ids=[s.name for s, _ in SPECS])
def test_errors_match_the_reference_string_for_string(spec_i):
    """Every illegal command the legacy device refuses: a FULL zone, an
    overflowing write, the active-zone limit, an unmapped read."""
    r, t = legacies(spec_i, max_active=1)
    cmds = [(0, 0, 40, True), (0, 0, 8, True), (0, 1, 1, True),
            (1, 0, 0, True), (0, 0, 1, True), (3, 2, 0, True),
            (0, 1, 32, True), (0, 1, 1, False), (2, 1, 0, True),
            (0, 2, 5, False), (1, 2, 0, True)]
    for i, (op, z, n, host) in enumerate(cmds):
        got = [run_command(d, op, z, n, host, np.arange(2)) for d in (r, t)]
        assert got[0][0] == got[1][0], i
        if got[0][0] == "err":
            assert got[0][1] == got[1][1], i
        else:
            assert same_iotrace(got[0][1], got[1][1]), i
        assert_same_legacy(r, t, f"cmd {i}")
    assert run_command(t, 0, 0, 1, True, None)[0] == "err"   # zone 0 FULL


_FUZZ_ROW = st.tuples(
    st.sampled_from([TE.OP_WRITE, TE.OP_FINISH, TE.OP_RESET]),
    st.integers(0, 3),
    st.integers(1, 34),
    st.booleans(),
)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, len(SPECS) - 1), st.integers(1, 4),
       st.lists(_FUZZ_ROW, min_size=1, max_size=30))
def test_legacy_shim_and_program_agree_on_the_port(spec_i, max_active,
                                                   rows):
    """The reference's three-way differential on the port alone: the
    legacy device, the engine-backed shim and one ``run_program`` leave
    the same element state, counters and zone tables, and the program's
    ``ok`` flags are where the legacy device raised."""
    spec = SPECS[spec_i][1]
    flash, zone = TFlash(**FLASH), TZone(**ZONE)
    leg = TLegacy(flash, zone, spec, max_active=max_active, device="cpu")
    dev = TDevice(flash, zone, spec, max_active=max_active, device="cpu")
    legal = []
    for i, (op, z, n, host) in enumerate(rows):
        outcomes = []
        for d in (dev, leg):
            try:
                if op == TE.OP_WRITE:
                    d.zone_write(z, n, host=host)
                elif op == TE.OP_FINISH:
                    d.zone_finish(z)
                else:
                    d.zone_reset(z)
                outcomes.append(True)
            except RuntimeError:
                outcomes.append(False)
        assert outcomes[0] == outcomes[1], (i, rows[i])
        legal.append(outcomes[1])
        for name in ("elem_wear", "elem_avail", "elem_pages", "elem_zone"):
            assert np.array_equal(getattr(dev, name), getattr(leg, name)), \
                (name, i)
        for name in ("host_pages", "dummy_pages", "block_erases",
                     "alloc_calls", "n_active"):
            assert getattr(dev, name) == getattr(leg, name), (name, i)
    eng = dev.engine
    state, trace = eng.run(eng.init_state(), TE.encode_program(
        [(op, z, n, TE.F_HOST if host else 0) for op, z, n, host in rows]))
    n_el = eng.cfg.n_elements
    for name in ("elem_wear", "elem_avail", "elem_pages", "elem_zone"):
        assert np.array_equal(getattr(state, name)[:n_el].numpy(),
                              getattr(leg, name)), name
    for name in ("host_pages", "dummy_pages", "block_erases", "n_active"):
        assert int(getattr(state, name)) == getattr(leg, name), name
    zs, wp = state.zone_state.numpy(), state.zone_wp.numpy()
    hwp = state.zone_host_wp.numpy()
    for z in range(eng.cfg.n_zones):
        info = leg.zones[z]
        assert (zs[z], wp[z], hwp[z]) == (info.state.value, info.wp,
                                          info.host_wp), z
    assert np.array_equal(eng.block_wear(state), leg.block_wear())
    assert trace.ok.tolist() == legal


@pytest.mark.parametrize("spec_i", [0, 1, 3, 4],
                         ids=["block", "vchunk2", "superblock", "fixed"])
def test_wear_oblivious_allocation_matches_the_reference(spec_i):
    """``wear_aware=False`` (first fit by column, slots still ranked by
    wear) under wear-divergent churn: identical to the reference, and no
    call of the wear-aware selection."""
    r, t = legacies(spec_i, max_active=14, wear_aware=False)
    for i in range(12):
        z = i % 3
        for d in (r, t):
            d.zone_write(z, 3 + i)        # partial fill: uneven wear
            d.zone_finish(z)
            d.zone_reset(z)
        assert_same_legacy(r, t, f"i={i}")
    assert t.allocate_calls == 0


def test_cheapest_groups_fallback_selects_twice():
    """A round-robin window without enough free elements falls back to
    the cheapest groups: a second selection call, counted, with the
    reference's result.  BLOCK zones over 2 of the 4 LUNs: the windows
    alternate between LUNs 0-1 and 2-3; full zones exhaust LUNs 0-1
    while one-page zones, FINISHed, hand LUNs 2-3 back, so the ninth
    allocation's window (LUNs 0-1) is infeasible."""
    flash, zone = dict(FLASH), dict(parallelism=2, n_segments=2)
    r = RLegacy(RFlash(**flash), RZone(**zone), R_BLOCK, max_active=8)
    t = TLegacy(TFlash(**flash), TZone(**zone), T_BLOCK, max_active=8,
                device="cpu")
    cheapest = []
    inner = t._cheapest_groups

    def spy():
        cheapest.append(inner())
        return cheapest[-1]
    t._cheapest_groups = spy
    for z in range(8):
        for d in (r, t):
            if z % 2:
                d.zone_write(z, 1)
                d.zone_finish(z)
            else:
                d.zone_write(z, d.zone_pages)
        assert_same_legacy(r, t, f"z={z}")
    assert not cheapest
    for d in (r, t):
        d.zone_reset(1)
        d.zone_write(1, 3)
    assert_same_legacy(r, t, "after the fallback")
    assert len(cheapest) == 1
    assert t.allocate_calls == t.alloc_calls + 1 == 10


@pytest.mark.parametrize("spec_i", [0, 3, 4],
                         ids=["block", "superblock", "fixed"])
def test_warmup_alloc_leaves_the_state_unchanged(spec_i):
    """``warmup_alloc`` runs the selection paths on copies: state and
    counters untouched; its selections are counted as calls."""
    _, t = legacies(spec_i)
    before = (t.elem_wear.copy(), t.elem_avail.copy(), t.elem_pages.copy(),
              t.elem_zone.copy())
    t.warmup_alloc()
    for a, b in zip(before, (t.elem_wear, t.elem_avail, t.elem_pages,
                             t.elem_zone)):
        assert np.array_equal(a, b)
    assert t.host_pages == 0 and t.alloc_calls == 0
    assert t.allocate_calls == (0 if spec_i == 4 else 2)


def test_wear_stays_int64_on_the_host():
    _, t = legacies(3)
    t.zone_write(0, 9)
    assert t.elem_wear.dtype == np.int64 and t.elem_pages.dtype == np.int64
    assert t.device == torch.device("cpu")


def test_cuda_without_a_card_raises():
    """``device="cuda"`` (the default) never drops to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLegacy(TFlash(**FLASH), TZone(**ZONE), T_BLOCK)
