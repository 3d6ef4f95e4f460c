"""Differential tests: the PyTorch engine port vs the JAX engine.

The same op programs run through ``repro.core.engine.run_programs`` and
``repro_torch.core.engine.run_programs`` (on the CPU), and every
``DeviceState`` and ``OpTrace`` field must be identical, dtype and
scratch slot included.  Programs are fuzzed with the row strategies of
the reference's own property tests, plus wild rows (out-of-range zones
and opcodes); lanes mix policies, capacity shrinks, wear bounds and the
allocator axis.  Every JAX dispatch of one config has one shape, so it
compiles once per module.
"""

import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import alloc_exact as j_alloc_exact
from repro.core import elements as j_elements
from repro.core import engine as E
from repro.core import geometry as j_geometry
from repro.core import timing as j_timing
from repro.core import workloads as j_workloads
from repro.core import zns as j_zns
from repro.core.elements import BLOCK, FIXED, SUPERBLOCK, hchunk, vchunk
from repro.core.geometry import FlashGeometry, ZoneGeometry
from repro_torch.core import alloc_exact as t_alloc_exact
from repro_torch.core import elements as t_elements
from repro_torch.core import engine as T
from repro_torch.core import geometry as t_geometry
from repro_torch.core import timing as t_timing
from repro_torch.core import workloads as t_workloads
from repro_torch.core import zns as t_zns
from repro_torch.obs import ObsConfig
from test_engine_diff import _FUZZ_ROW
from test_silentzns_property import _ROW
from test_union_spec import _FUZZ_ROW as _UNION_ROW

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPECS = [BLOCK, vchunk(2), hchunk(2), SUPERBLOCK, FIXED]
FLASH = FlashGeometry(4, 1, 8, 4, 4096)
ZGEOM = ZoneGeometry(4, 2)
N_OPS = 32
N_LANES = 6

#: out-of-range opcodes and zones, zero and oversized page counts, any
#: flag bits: the engine clamps, never rejects
_WILD_ROW = st.tuples(st.integers(-2, 8), st.integers(-3, 7),
                      st.integers(0, 40), st.integers(0, 3))


def tspec(spec):
    return t_elements.ElementSpec(t_elements.ElementKind[spec.kind.name],
                                  spec.chunk)


def tflash(flash):
    return t_geometry.FlashGeometry(**dataclasses.asdict(flash))


def tzone(zone):
    return t_geometry.ZoneGeometry(**dataclasses.asdict(zone))


def engines(spec, *, max_active=3, flash=FLASH, zone=ZGEOM):
    specs = spec if isinstance(spec, tuple) else None
    jeng = E.ZoneEngine(flash, zone, spec, max_active=max_active)
    teng = T.ZoneEngine(tflash(flash), tzone(zone),
                        tuple(map(tspec, specs)) if specs else tspec(spec),
                        max_active=max_active, device="cpu")
    return jeng, teng


def assert_identical(j_pair, t_pair, ctx=""):
    for kind, j, t in (("state", j_pair[0], t_pair[0]),
                       ("trace", j_pair[1], t_pair[1])):
        for name in type(t)._fields:
            a = np.asarray(getattr(j, name))
            b = getattr(t, name).numpy()
            assert a.dtype == b.dtype, f"{kind}.{name} dtype {ctx}"
            assert a.shape == b.shape, f"{kind}.{name} shape {ctx}"
            assert np.array_equal(a, b), f"{kind}.{name} {ctx}"


def pad(rows, n_ops=N_OPS):
    prog = np.zeros((n_ops, 4), dtype=np.int32)
    enc = E.encode_program(rows)[:n_ops]
    prog[: len(enc)] = enc
    return prog


def host_rows(rows):
    return [(op, z, n, E.F_HOST if host else 0) for op, z, n, host in rows]


def lane_kwargs(spec, k, zone_pages):
    """Lane ``k``'s DynConfig overrides: both policies, two capacity
    shrinks (one not a whole number of element ranks), wear bounds and
    the first-fit allocator, as far as ``spec`` admits them."""
    fixed = spec.kind is j_elements.ElementKind.FIXED
    kw = {"wear_aware": bool(k % 2)}
    if not fixed:
        kw["alloc_policy"] = "silent" if k % 3 else "traditional"
        kw["wear_bound"] = [None, 0, 1, 3][k % 4]
        if k % 4 == 1:
            kw["zone_pages"] = zone_pages // 2
        elif k % 4 == 2:
            kw["zone_pages"] = zone_pages // 4
    else:
        kw["max_active"] = 1 + k % 3
    return kw


def run_both(jeng, teng, programs, kws):
    jd = E.stack_dyn([jeng.dyn(**kw) for kw in kws])
    td = T.stack_dyn([teng.dyn(**kw) for kw in kws])
    return (jeng.run_batch(jeng.init_state(), programs, jd),
            teng.run_batch(teng.init_state(), programs, td))


_ENGINES = {}


def cached_engines(key):
    if key not in _ENGINES:
        _ENGINES[key] = engines(key)
    return _ENGINES[key]


# --------------------------------------------------------------------- #
# the differential: every spec, both policies, dyn overrides
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("spec_i", range(len(SPECS)),
                         ids=[s.name for s in SPECS])
@settings(max_examples=4, deadline=None, derandomize=True)
@given(st.lists(_FUZZ_ROW, min_size=1, max_size=12),
       st.lists(_ROW, min_size=1, max_size=12),
       st.lists(_WILD_ROW, min_size=0, max_size=8))
def test_engine_bit_identical_fuzz(spec_i, diff_rows, silent_rows,
                                   wild_rows):
    spec = SPECS[spec_i]
    jeng, teng = cached_engines(spec)
    rows = host_rows(diff_rows) + host_rows(silent_rows) + wild_rows
    rng = np.random.default_rng(len(rows) * 7919 + spec_i)
    order = rng.permutation(len(rows))
    prog = pad([rows[i] for i in order])
    kws = [lane_kwargs(spec, k, jeng.cfg.zone_pages)
           for k in range(N_LANES)]
    j, t = run_both(jeng, teng, np.stack([prog] * N_LANES), kws)
    assert_identical(j, t, f"spec={spec.name} prog={prog.tolist()}")


UNION_SPECS = (BLOCK, vchunk(2), hchunk(2))


@settings(max_examples=4, deadline=None, derandomize=True)
@given(st.lists(_UNION_ROW, min_size=1, max_size=24),
       st.lists(st.tuples(st.integers(0, 2), st.integers(0, 7)),
                min_size=N_LANES, max_size=N_LANES))
def test_union_engine_mixed_lane_specs(rows, lanes):
    """A BLOCK + vchunk(2) + hchunk(2) union engine with a different
    member spec, policy and override set per lane in one dispatch."""
    jeng, teng = cached_engines(UNION_SPECS)
    prog = pad(host_rows(rows))
    kws = []
    for spec_i, k in lanes:
        kw = lane_kwargs(UNION_SPECS[spec_i], k, jeng.cfg.zone_pages)
        kws.append({"spec": UNION_SPECS[spec_i], **kw})
    t_kws = [{**kw, "spec": tspec(kw["spec"])} for kw in kws]
    jd = E.stack_dyn([jeng.dyn(**kw) for kw in kws])
    td = T.stack_dyn([teng.dyn(**kw) for kw in t_kws])
    progs = np.stack([prog] * N_LANES)
    assert_identical(jeng.run_batch(jeng.init_state(), progs, jd),
                     teng.run_batch(teng.init_state(), progs, td),
                     f"lanes={lanes}")


def test_silent_slot_collision_keeps_last_writer():
    """docs/CHECKING.md's collision: a silent lane shrunk below one
    element per LUN group claims a partial rank, miscounts it as zero
    committed ranks, and re-claims the same slots on the next write --
    the slot row keeps the last claim and the loser is orphaned
    ALLOCATED.  The port must resolve the repeated slots the same way."""
    jeng, teng = engines(BLOCK)
    cfg = jeng.cfg
    zp = 2 * cfg.pages_per_element          # 2 slots < one rank of 4
    rows = [(E.OP_WRITE, 0, 1, E.F_HOST), (E.OP_WRITE, 0, 1, E.F_HOST),
            (E.OP_WRITE, 1, 3, E.F_HOST), (E.OP_FINISH, 0, 0, 0),
            (E.OP_WRITE, 1, 2, 0), (E.OP_RESET, 0, 0, 0),
            (E.OP_WRITE, 0, 5, E.F_HOST)]
    kws = [dict(alloc_policy="silent", zone_pages=zp, wear_bound=b)
           for b in (None, 0)]
    progs = np.stack([pad(rows)] * 2)
    j, t = run_both(jeng, teng, progs, kws)
    assert_identical(j, t, "collision")
    # the collision happened: an element claimed by zone 1 is missing
    # from its slot row
    zone = np.asarray(j[0].elem_zone)[0, :cfg.n_elements]
    in_row = set(np.asarray(j[0].zone_elems)[0, 1].tolist())
    orphans = [e for e in np.nonzero(zone == 1)[0] if e not in in_row]
    assert orphans


def test_mid_program_state_continues_identically():
    """A state taken from the JAX engine mid-program is handed to the
    port through numpy; both continue the program and agree."""
    jeng, teng = engines(BLOCK)
    rng = np.random.default_rng(7)
    rows = [(int(rng.choice([E.OP_WRITE, E.OP_WRITE, E.OP_FINISH,
                             E.OP_RESET, E.OP_ALLOC])),
             int(rng.integers(0, 4)), int(rng.integers(1, 20)), 1)
            for _ in range(2 * N_OPS)]
    first, second = pad(rows[:N_OPS]), pad(rows[N_OPS:])
    dyn = jeng.dyn(alloc_policy="silent", wear_bound=1)
    mid, _ = jeng.run(jeng.init_state(), first, dyn)
    leaves = T.state_to_numpy(T.state_from_numpy(
        teng.cfg, jax.tree_util.tree_leaves(mid), device="cpu"))
    tmid = T.state_from_numpy(teng.cfg, leaves, device="cpu")
    tdyn = T.dyn_from_numpy([np.asarray(x) for x in dyn])
    assert T.dyn_values(teng.cfg, tdyn) == E.dyn_values(jeng.cfg, dyn)
    assert all(np.array_equal(a, b) for a, b in
               zip(T.dyn_to_numpy(tdyn), [np.asarray(x) for x in dyn]))
    assert_identical(jeng.run(mid, second, dyn),
                     teng.run(tmid, second, tdyn), "continued")


def test_state_from_numpy_checks_shapes():
    _, teng = engines(BLOCK)
    leaves = list(T.state_to_numpy(teng.init_state()))
    leaves[7] = leaves[7][:, :-1]
    with pytest.raises(ValueError, match="zone_elems"):
        T.state_from_numpy(teng.cfg, leaves, device="cpu")
    with pytest.raises(ValueError, match="fields"):
        T.state_from_numpy(teng.cfg, leaves[:3], device="cpu")


# --------------------------------------------------------------------- #
# config errors, devices, engine surface
# --------------------------------------------------------------------- #
_BAD_DYNS = [
    (BLOCK, dict(zone_pages=0)), (BLOCK, dict(zone_pages=10**6)),
    (FIXED, dict(zone_pages=8)), (BLOCK, dict(n_zones=0)),
    (BLOCK, dict(n_zones=99)), (BLOCK, dict(max_active=0)),
    (BLOCK, dict(max_active=99)), (BLOCK, dict(alloc_policy="greedy")),
    (BLOCK, dict(alloc_policy=7)), (FIXED, dict(alloc_policy="silent")),
    (BLOCK, dict(wear_bound=-1)), (BLOCK, dict(wear_bound=2**31 - 1)),
    (BLOCK, dict(spec=SUPERBLOCK)),
]


@pytest.mark.parametrize(
    "spec,kw", _BAD_DYNS,
    ids=[f"{s.name}-" + "-".join(f"{k}={v}" for k, v in kw.items())
         for s, kw in _BAD_DYNS])
def test_make_dyn_raises_reference_errors(spec, kw):
    jeng, teng = cached_engines(spec)
    with pytest.raises(ValueError) as jerr:
        jeng.dyn(**kw)
    tkw = {k: tspec(v) if k == "spec" else v for k, v in kw.items()}
    with pytest.raises(ValueError) as terr:
        teng.dyn(**tkw)
    assert str(terr.value) == str(jerr.value)


def test_union_config_and_stack_errors_match():
    t_flash, t_zone = tflash(FLASH), tzone(ZGEOM)
    for specs in ((), (BLOCK, BLOCK), (BLOCK, FIXED)):
        with pytest.raises(ValueError) as jerr:
            E.make_union_config(FLASH, ZGEOM, specs)
        with pytest.raises(ValueError) as terr:
            T.make_union_config(t_flash, t_zone, tuple(map(tspec, specs)))
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="at least one"):
        T.stack_dyn([])
    jeng, teng = cached_engines(UNION_SPECS)
    for f in dataclasses.fields(jeng.cfg):
        a, b = getattr(jeng.cfg, f.name), getattr(teng.cfg, f.name)
        if f.name == "members":
            assert [(s.name, dataclasses.astuple(v)) for s, v in a] == \
                [(s.name, dataclasses.astuple(v)) for s, v in b]
        elif f.name == "kind":
            assert a.name == b.name
        else:
            assert a == b, f.name


def test_dtypes_and_device_defaults():
    _, teng = engines(BLOCK)
    state = teng.init_state()
    assert all(t.dtype == torch.int32 for t in state)
    assert all(t.dtype == torch.int32 for t in teng.dyn()
               if t.dtype != torch.bool)
    _, _, tel = teng.run(state, pad([]), obs=ObsConfig(n_buckets=2))
    assert all(t.dtype == torch.int32 and t.device == state.elem_wear.device
               for t in tel)
    if torch.cuda.is_available():
        assert T.init_state(teng.cfg).elem_wear.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.init_state(teng.cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.ZoneEngine(tflash(FLASH), tzone(ZGEOM), tspec(BLOCK))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.run_programs(teng.cfg, state, pad([])[None])


def test_engine_metrics_and_wear_views_match():
    jeng, teng = cached_engines(UNION_SPECS)
    rows = [(E.OP_WRITE, z, 5 + 3 * z, E.F_HOST) for z in range(4)]
    rows += [(E.OP_FINISH, z, 0, 0) for z in range(4)]
    rows += [(E.OP_RESET, z, 0, 0) for z in range(2)]
    rows += [(E.OP_WRITE, z, 9, E.F_HOST) for z in range(2)]
    prog = pad(rows)
    for spec in UNION_SPECS:
        js, _ = jeng.run(jeng.init_state(), prog, jeng.dyn(spec=spec))
        ts, _ = teng.run(teng.init_state(), prog,
                         teng.dyn(spec=tspec(spec)))
        assert teng.metrics(ts) == jeng.metrics(js)
        assert np.array_equal(teng.elem_wear(ts, tspec(spec)),
                              jeng.elem_wear(js, spec))
        assert np.array_equal(teng.block_wear(ts, tspec(spec)),
                              jeng.block_wear(js, spec))
        assert np.array_equal(teng.member_element_ids(tspec(spec)),
                              jeng.member_element_ids(spec))


# --------------------------------------------------------------------- #
# timing, workloads, zns closed forms
# --------------------------------------------------------------------- #
def test_simulate_fleet_ops_matches_reference():
    rng = np.random.default_rng(3)
    lanes, n_ops, P, n_luns, n_ten = 5, 40, 4, 8, 3
    cols = rng.integers(0, n_luns, (lanes, n_ops, P)).astype(np.int32)
    pages = rng.integers(0, 300, (lanes, n_ops)).astype(np.int32)
    pages[rng.random((lanes, n_ops)) < 0.2] = 0
    tenants = rng.integers(0, n_ten, (lanes, n_ops)).astype(np.int32)
    t_page = rng.uniform(1e-4, 1e-3, (lanes, n_ops)).astype(np.float32)
    for tp in (7.5e-4, t_page):
        ref = j_timing.simulate_fleet_ops(cols, pages, tenants, tp,
                                          n_luns, n_ten)
        got = t_timing.simulate_fleet_ops(
            torch.from_numpy(cols), torch.from_numpy(pages),
            torch.from_numpy(tenants), torch.as_tensor(tp), n_luns, n_ten)
        (r_done, r_lat, r_span), (g_done, g_lat, g_span) = ref, got
        assert all(g.dtype == torch.float32 for g in got)
        # clocks agree to f32 rounding (XLA may contract the
        # multiply-add); a latency is a difference of two clocks, so its
        # error is bounded by theirs, not by its own size
        np.testing.assert_allclose(g_done.numpy(), np.asarray(r_done),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(g_span.numpy(), np.asarray(r_span),
                                   rtol=1e-6, atol=0)
        scale = float(np.asarray(r_done).max())
        np.testing.assert_allclose(g_lat.numpy(), np.asarray(r_lat),
                                   rtol=0, atol=1e-6 * scale)


def test_simulate_fleet_matches_reference():
    rng = np.random.default_rng(4)
    n_dev, n, n_luns, n_ch = 3, 60, 8, 4
    ops = rng.integers(0, 3, (n_dev, n)).astype(np.int32)
    luns = rng.integers(0, n_luns, (n_dev, n)).astype(np.int32)
    chans = (luns % n_ch).astype(np.int32)
    valid = rng.random((n_dev, n)) < 0.9
    t_op = np.asarray([5e-4, 5e-5, 3e-3], np.float32)
    ref = j_timing.simulate_fleet(ops, luns, chans, valid, t_op,
                                  np.float32(4e-5), n_luns, n_ch)
    got = t_timing.simulate_fleet(
        *map(torch.from_numpy, (ops, luns, chans, valid, t_op)),
        torch.tensor(4e-5), n_luns, n_ch)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    ref1 = j_timing.simulate(ops[0], luns[0], chans[0], t_op,
                             np.float32(4e-5), n_luns, n_ch)
    got1 = t_timing.simulate(*map(torch.from_numpy,
                                  (ops[0], luns[0], chans[0], t_op)),
                             4e-5, n_luns, n_ch)
    for r, g in zip(ref1, got1):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


def test_workload_programs_and_sweep_match():
    jeng, teng = cached_engines(BLOCK)
    for fn, kw in (("dlwa_program", dict(occupancy=0.3, n_zones=3)),
                   ("dlwa_program", dict(occupancy=0.6, zone_base=1,
                                         zone_pages=20)),
                   ("interference_program", dict(concurrency=2)),
                   ("write_program", dict(request_kib=8, n_jobs=3,
                                          mib_per_job=1))):
        a = getattr(j_workloads, fn)(jeng, **kw)
        b = getattr(t_workloads, fn)(teng, **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b), fn
    occ = (0.1, 0.4, 0.9)
    assert t_workloads.dlwa_sweep_engine(teng, occ, n_zones=3) == \
        j_workloads.dlwa_sweep_engine(jeng, occ, n_zones=3)
    assert t_workloads.dlwa_benchmark_engine(teng, occupancy=0.3) == \
        j_workloads.dlwa_benchmark_engine(jeng, occupancy=0.3)
    assert t_workloads.make_engine(
        tflash(FLASH), tzone(ZGEOM), tspec(BLOCK), max_active=3,
        device="cpu").cfg \
        == teng.cfg


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_zns_tensor_forms_match_reference(spec):
    P, nseg, ppb = 4, 4, 8
    wps = np.arange(0, P * nseg * ppb + 3, 3, dtype=np.int32)
    tw = torch.from_numpy(wps)
    got_b = t_zns.pages_per_block_t(tw, P, nseg, ppb)
    got_e = t_zns.element_pages_t(tw, tspec(spec), P, nseg, ppb)
    for i, wp in enumerate(wps.tolist()):
        ref_b = np.asarray(j_zns.pages_per_block_jnp(wp, P, nseg, ppb))
        ref_e = np.asarray(j_zns.element_pages_jnp(wp, spec, P, nseg, ppb))
        assert got_b.dtype == got_e.dtype == torch.int32
        assert np.array_equal(got_b[i].numpy(), ref_b)
        assert np.array_equal(got_e[i].numpy(), ref_e)
        assert np.array_equal(
            t_zns.element_pages(wp, tspec(spec), P, nseg, ppb),
            j_zns.element_pages(wp, spec, P, nseg, ppb))
    stride = j_zns.n_slots(spec, P, nseg) // max(1, nseg)
    for params in ((P, 1, 1), (max(1, stride), 2, 1), (1, P, nseg),
                   (P, 1, 2)):
        ref = np.asarray(j_zns.slot_map_jnp(*params, P, nseg))
        got = t_zns.slot_map_t(*(torch.tensor([v], dtype=torch.int32)
                                 for v in params), P, nseg)
        assert np.array_equal(got[0].numpy(), ref)


# --------------------------------------------------------------------- #
# copied foundations and package independence
# --------------------------------------------------------------------- #
def _geometry_pairs():
    jf, jz = j_geometry.zn540()
    tf, tz = t_geometry.zn540()
    yield jf, jz, tf, tz
    for jz, tz in zip(j_geometry.PAPER_GEOMETRIES,
                      t_geometry.PAPER_GEOMETRIES):
        yield j_geometry.custom16(), jz, t_geometry.custom16(), tz


def test_copied_foundations_match():
    for jf, jz, tf, tz in _geometry_pairs():
        assert dataclasses.asdict(jf) == dataclasses.asdict(tf)
        assert dataclasses.asdict(jz) == dataclasses.asdict(tz)
        assert jz.zone_pages(jf) == tz.zone_pages(tf)
        assert jz.describe(jf) == tz.describe(tf)
        for spec in j_elements.PAPER_ELEMENTS:
            ts = tspec(spec)
            assert j_elements.is_applicable(spec, jz, jf) == \
                t_elements.is_applicable(ts, tz, tf)
            if not j_elements.is_applicable(spec, jz, jf):
                continue
            a = j_elements.build_layout(jf, spec, jz)
            b = t_elements.build_layout(tf, ts, tz)
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(x, np.ndarray):
                    assert np.array_equal(x, y), f.name
                elif f.name != "spec":
                    assert x == y, f.name
            assert j_elements.elements_per_zone(a, jz) == \
                t_elements.elements_per_zone(b, tz)
            assert j_elements.groups_per_zone(a, jz) == \
                t_elements.groups_per_zone(b, tz)
    assert np.array_equal(j_elements.union_grid_ids(12, 3, 5),
                          t_elements.union_grid_ids(12, 3, 5))
    rng = np.random.default_rng(11)
    for _ in range(20):
        g, w, take = 3, 6, 2
        wear = rng.integers(0, 9, g * w)
        avail = rng.choice([0, 1, 2, 3], g * w)
        groups = np.repeat(np.arange(g), w)
        kw = dict(z=take * g, k_max=take, l_min=g,
                  eligible_groups=list(range(g)))
        a = j_alloc_exact.solve(wear, avail, groups, **kw)
        b = t_alloc_exact.solve(wear, avail, groups, **kw)
        assert (a.feasible, a.cost) == (b.feasible, b.cost)
        if a.feasible:
            assert np.array_equal(a.selected, b.selected)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(ROOT)} imports {mod}"
