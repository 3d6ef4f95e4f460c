"""The port's flight recorder held to the JAX package on the CPU.

* **effect-freeness**: the same programs with and without an
  ``ObsConfig`` give bit-identical ``DeviceState`` / ``OpTrace``, single
  lane and batched;
* the telemetry equals the reference's, histogram for histogram (single
  lane, batched lanes and a fleet dispatch with tenants and parity);
* histogram totals reconcile with the end state; bucket and tenant
  binning, the lane / fleet / tenant / zone decoders and the pooled
  rollup agree with re-aggregation of the trace and with the
  reference's decoders;
* the Perfetto export equals the reference's event for event and
  validates against the checked-in schema, the metrics registry and the
  sidecar agree with the reference's, and ``tools/obs_report.py``
  renders the port's sidecar;
* the profiler's sections, ``profile_dispatch``, the build record of
  ``kernels/_build`` and the launch-plan counter: plans are per lane
  count, so repeated same-size ``Evaluator`` generations keep them flat.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.fleet as RFL
import repro.obs as RO
import repro_torch.fleet as TFL
import repro_torch.obs as TO
from repro.core import engine as RE
from repro.core.elements import BLOCK as R_BLOCK
from repro.core.elements import FIXED as R_FIXED
from repro.core.elements import SUPERBLOCK as R_SUPERBLOCK
from repro.core.elements import hchunk as r_hchunk
from repro.core.elements import vchunk as r_vchunk
from repro.core.geometry import FlashGeometry as RFlash
from repro.core.geometry import ZoneGeometry as RZone
from repro.obs.export import fleet_metrics as r_fleet_metrics
from repro_torch.core import engine as TE
from repro_torch.core import timing as TT
from repro_torch.core.elements import BLOCK as T_BLOCK
from repro_torch.core.elements import FIXED as T_FIXED
from repro_torch.core.elements import SUPERBLOCK as T_SUPERBLOCK
from repro_torch.core.elements import hchunk as t_hchunk
from repro_torch.core.elements import vchunk as t_vchunk
from repro_torch.core.geometry import FlashGeometry as TFlash
from repro_torch.core.geometry import ZoneGeometry as TZone
from repro_torch.kernels import _build
from repro_torch.obs.export import fleet_metrics as t_fleet_metrics

REPO = pathlib.Path(__file__).resolve().parent.parent
SPECS = {"block": (R_BLOCK, T_BLOCK), "vchunk2": (r_vchunk(2), t_vchunk(2)),
         "hchunk2": (r_hchunk(2), t_hchunk(2)),
         "superblock": (R_SUPERBLOCK, T_SUPERBLOCK),
         "fixed": (R_FIXED, T_FIXED)}
#: ``tests/test_obs.py``'s tiny device and its fleet device
TINY = dict(n_channels=4, ways_per_channel=1, blocks_per_lun=8,
            pages_per_block=4, page_bytes=4096)
FLEET = dict(n_channels=4, ways_per_channel=2, blocks_per_lun=64,
             pages_per_block=16, page_bytes=4096)


def tiny_engines(spec="superblock", max_active=3):
    r, t = SPECS[spec]
    return (RE.ZoneEngine(RFlash(**TINY), RZone(4, 2), r,
                          max_active=max_active),
            TE.ZoneEngine(TFlash(**TINY), TZone(4, 2), t,
                          max_active=max_active, device="cpu"))


def tiny_engine(spec="superblock"):
    return tiny_engines(spec)[1]


_FUZZ_ROW = st.tuples(
    st.sampled_from([TE.OP_WRITE, TE.OP_FINISH, TE.OP_RESET]),
    st.integers(0, 3),
    st.integers(1, 34),
    st.booleans(),
)


def mixed_program(eng, n=24, seed=0):
    """``tests/test_obs.py``'s seeded mixed program."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        op = [TE.OP_WRITE, TE.OP_FINISH, TE.OP_RESET][int(rng.integers(3))]
        rows.append((op, int(rng.integers(4)),
                     int(rng.integers(1, eng.cfg.zone_pages + 3)),
                     TE.F_HOST if rng.integers(2) else 0))
    return TE.encode_program(rows)


def assert_same_fields(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def assert_telemetry_is_the_references(got, want):
    for f in RO.TelemetryState._fields:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f


# --------------------------------------------------------------------- #
# effect-freeness and the reference's histograms
# --------------------------------------------------------------------- #
@settings(max_examples=10, deadline=None)
@given(st.sampled_from(sorted(SPECS)),
       st.lists(_FUZZ_ROW, min_size=1, max_size=40))
def test_telemetry_is_effect_free(spec, rows):
    eng = tiny_engine(spec)
    prog = TE.encode_program([(op, z, n, TE.F_HOST if host else 0)
                              for op, z, n, host in rows])
    state_off, trace_off = eng.run(eng.init_state(), prog)
    state_on, trace_on, tel = eng.run(eng.init_state(), prog,
                                      obs=TO.ObsConfig(n_buckets=7))
    assert_same_fields(state_off, state_on)
    assert_same_fields(trace_off, trace_on)
    assert int(tel.step) == len(prog)


def test_batched_telemetry_is_effect_free():
    eng = tiny_engine()
    progs = np.stack([mixed_program(eng, seed=s) for s in range(3)])
    state_off, trace_off = eng.run_batch(eng.init_state(), progs)
    state_on, trace_on, tel = eng.run_batch(
        eng.init_state(), progs, obs=TO.ObsConfig(n_buckets=5))
    assert_same_fields(state_off, state_on)
    assert_same_fields(trace_off, trace_on)
    assert tuple(tel.host.shape) == (3, 5)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_telemetry_is_the_references(spec):
    r_eng, t_eng = tiny_engines(spec)
    prog = mixed_program(t_eng, n=30, seed=3)
    _, _, want = r_eng.run(r_eng.init_state(), prog,
                           obs=RO.ObsConfig(n_buckets=4))
    _, _, got = t_eng.run(t_eng.init_state(), prog,
                          obs=TO.ObsConfig(n_buckets=4))
    assert_telemetry_is_the_references(got, want)
    progs = np.stack([mixed_program(t_eng, seed=s) for s in range(3)])
    _, _, want = r_eng.run_batch(r_eng.init_state(), progs,
                                 obs=RO.ObsConfig(n_buckets=6))
    _, _, got = t_eng.run_batch(t_eng.init_state(), progs,
                                obs=TO.ObsConfig(n_buckets=6))
    assert_telemetry_is_the_references(got, want)
    assert TO.fleet_timelines(TO.ObsConfig(6), got) == \
        RO.fleet_timelines(RO.ObsConfig(6), want)


@pytest.mark.parametrize("spec", ["block", "superblock", "fixed"])
def test_histogram_totals_match_end_state(spec):
    eng = tiny_engine(spec)
    prog = mixed_program(eng, n=30, seed=3)
    obs = TO.ObsConfig(n_buckets=4)
    state, trace, tel = eng.run(eng.init_state(), prog, obs=obs)
    tl = TO.lane_timeline(obs, tel)
    assert sum(tl["host"]) == int(state.host_pages)
    assert sum(tl["dummy"]) == int(state.dummy_pages)
    assert sum(tl["erases"]) == int(state.block_erases)
    assert sum(tl["allocs"]) == int(state.alloc_calls)
    ok = trace.ok.numpy()
    assert sum(tl["ok_ops"]) == int(ok.sum())
    assert sum(tl["illegal_ops"]) == len(prog) - int(ok.sum())
    h, d = int(state.host_pages), int(state.dummy_pages)
    assert tl["dlwa"][-1] == pytest.approx((h + d) / h if h else 1.0)
    assert max(tl["active_max"]) <= eng.cfg.max_active
    assert max(tl["wear_max"]) <= int(state.elem_wear.max())


def test_bucket_binning_is_progress_ordered():
    eng = tiny_engine()
    prog = TE.encode_program([(TE.OP_WRITE, z, 2, TE.F_HOST)
                              for z in (0, 1, 2)] * 4)
    _, trace, tel = eng.run(eng.init_state(), prog,
                            obs=TO.ObsConfig(n_buckets=3))
    host = trace.host_delta.numpy().astype(np.int64)
    want = [0, 0, 0]
    for i in range(len(prog)):
        want[min(i * 3 // len(prog), 2)] += int(host[i])
    assert tel.host.tolist() == want


def test_tenant_binning_width5_is_the_references():
    """Tags clip into ``[0, n_tenants - 1]`` (7 lands in class 2) and
    width-4 programs bin into class 0."""
    r_eng, t_eng = tiny_engines()
    rows = np.array([
        [TE.OP_WRITE, 0, 3, TE.F_HOST, 0],
        [TE.OP_WRITE, 1, 5, TE.F_HOST, 1],
        [TE.OP_WRITE, 0, 2, TE.F_HOST, 0],
        [TE.OP_FINISH, 1, 0, 0, 7],
    ], dtype=np.int32)
    obs = TO.ObsConfig(n_buckets=2, n_tenants=3)
    state, _, tel = t_eng.run(t_eng.init_state(), rows, obs=obs)
    th = tel.tenant_host.numpy().sum(axis=0)
    td = tel.tenant_dummy.numpy().sum(axis=0)
    assert th.tolist() == [5, 5, 0]
    assert td.sum() == int(state.dummy_pages) and td[0] == td[1] == 0
    tls = TO.tenant_timelines(obs, tel)
    assert sorted(tls) == [0, 1, 2] and sum(tls[1]["host"]) == 5
    _, _, want = r_eng.run(r_eng.init_state(), rows,
                           obs=RO.ObsConfig(n_buckets=2, n_tenants=3))
    assert_telemetry_is_the_references(tel, want)
    _, _, narrow = t_eng.run(t_eng.init_state(), rows[:, :4], obs=obs)
    assert narrow.tenant_host.numpy()[:, 0].sum() == 10


# --------------------------------------------------------------------- #
# decoders
# --------------------------------------------------------------------- #
def test_fleet_timelines_and_rollup():
    eng = tiny_engine()
    progs = np.stack([mixed_program(eng, seed=s) for s in range(4)])
    obs = TO.ObsConfig(n_buckets=6)
    states, _, tel = eng.run_batch(eng.init_state(), progs, obs=obs)
    with pytest.raises(ValueError, match="lane"):
        TO.lane_timeline(obs, tel)
    tls = TO.fleet_timelines(obs, tel)
    host = states.host_pages.numpy()
    assert [sum(tl["host"]) for tl in tls] == host.tolist()
    pooled = TO.device_rollup(tls)
    assert sum(pooled["host"]) == int(host.sum())
    for i in range(6):
        assert pooled["wear_max"][i] == max(tl["wear_max"][i]
                                            for tl in tls)
    assert TO.device_rollup([]) == {}


def test_zone_timelines_match_trace_and_the_reference():
    r_eng, t_eng = tiny_engines()
    prog = mixed_program(t_eng, n=30, seed=5)
    _, trace = t_eng.run(t_eng.init_state(), prog)
    per_zone = TO.zone_timelines(prog, trace, n_buckets=5)
    zone = trace.zone.numpy()
    host = trace.host_delta.numpy().astype(np.int64)
    wp = trace.wp_after.numpy().astype(np.int64)
    assert sorted(per_zone) == sorted({int(z) for z in prog[:, 1]})
    for z, tl in per_zone.items():
        mask = zone == z
        assert sum(tl["host"]) == int(host[mask].sum())
        assert tl["wp"][-1] == int(wp[np.nonzero(mask)[0][-1]])
        assert all(v >= 0 for v in tl["wp"])
    _, r_trace = r_eng.run(r_eng.init_state(), prog)
    assert per_zone == RO.zone_timelines(prog, r_trace, n_buckets=5)


def test_obsconfig_rejects_degenerate_shapes():
    for kw in ({"n_buckets": 0}, {"n_tenants": 0}, {"n_buckets": -3}):
        with pytest.raises(ValueError):
            TO.ObsConfig(**kw)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_op_stream_reconstruction_is_the_references(spec):
    r_eng, t_eng = tiny_engines(spec)
    rows = []
    for z in range(3):
        rows += [(TE.OP_WRITE, z, 3 + 2 * z, TE.F_HOST),
                 (TE.OP_FINISH, z, 0, 0)]
    prog = TE.encode_program(rows)
    _, tr = t_eng.run(t_eng.init_state(), prog)
    _, rt = r_eng.run(r_eng.init_state(), prog)
    for i, (op, _z, _n, _f) in enumerate(prog):
        got = t_eng.op_stream(
            int(op), int(tr.wp_before[i]), int(tr.wp_after[i]),
            int(tr.dummy_delta[i]), tr.elems[i].numpy(),
            tr.cols[i].numpy())
        want = r_eng.op_stream(
            int(op), int(rt.wp_before[i]), int(rt.wp_after[i]),
            int(rt.dummy_delta[i]), np.asarray(rt.elems[i]),
            np.asarray(rt.cols[i]))
        assert (got is None) == (want is None), i
        if got is not None:
            for a, b in zip(got, want):
                assert np.array_equal(a, b), i


# --------------------------------------------------------------------- #
# export: Perfetto trace, registry, sidecar
# --------------------------------------------------------------------- #
def tiny_fleets(n_configs=2, n_devices=2, profiler=None):
    """``tests/test_obs.py``'s observed fleet dispatch through both
    packages: (port engine, configs, port result, obs, reference
    engine, reference result)."""
    r_eng = RE.ZoneEngine(RFlash(**FLEET), RZone(8, 4), R_SUPERBLOCK,
                          max_active=6)
    t_eng = TE.ZoneEngine(TFlash(**FLEET), TZone(8, 4), T_SUPERBLOCK,
                          max_active=6, device="cpu")
    axes = dict(segments=(4,), chunks=(64,), parities=(False, True),
                wear=(True,))
    r_cfg = RFL.grid_space(**axes)[:n_configs]
    t_cfg = TFL.grid_space(**axes)[:n_configs]
    r_prog, r_dyn, _ = RFL.build_fleet_batch(r_eng, r_cfg,
                                             n_devices=n_devices)
    t_prog, t_dyn, _ = TFL.build_fleet_batch(t_eng, t_cfg,
                                             n_devices=n_devices)
    assert np.array_equal(t_prog, r_prog)
    obs = TO.ObsConfig(n_buckets=8, n_tenants=TFL.N_TENANTS + 1)
    r_res = RFL.run_fleet(r_eng, r_prog, dyn=r_dyn, n_tenants=2,
                          obs=RO.ObsConfig(8, RFL.N_TENANTS + 1))
    t_res = TFL.run_fleet(t_eng, t_prog, dyn=t_dyn,
                          n_tenants=TFL.N_TENANTS, obs=obs,
                          profiler=profiler)
    return t_eng, t_cfg, t_res, obs, r_eng, r_res


def test_fleet_telemetry_and_trace_events_are_the_references(tmp_path):
    eng, _, res, _, r_eng, r_res = tiny_fleets()
    assert_telemetry_is_the_references(res.telemetry, r_res.telemetry)
    events = TO.fleet_trace_events(res, eng)
    assert events == RO.fleet_trace_events(r_res, r_eng)
    assert {e["ph"] for e in events} == {"M", "X", "C"}
    t_page = (eng.flash.t_prog + eng.flash.t_xfer) * 1e6
    for e in events:
        if e["ph"] == "X" and e["args"]["pages"]:
            want = -(-e["args"]["pages"] // int(eng.cfg.parallelism)) \
                * t_page
            assert e["dur"] == pytest.approx(want, rel=1e-6)
            assert e["ts"] >= -1e-9
    obj = TO.write_trace(tmp_path / "t_trace.json", events,
                         meta={"run": "test"})
    TO.validate_trace(obj)
    back = json.loads((tmp_path / "t_trace.json").read_text())
    assert back["otherData"] == {"run": "test"}
    assert len(back["traceEvents"]) == len(events)


def test_trace_validation_rejects_malformed():
    TO.validate_trace({"traceEvents": [
        {"ph": "X", "name": "WRITE z0", "pid": 0, "ts": 0.0, "dur": 1.0}]})
    with pytest.raises(ValueError, match="traceEvents"):
        TO.validate_trace({"displayTimeUnit": "ms"})
    with pytest.raises(ValueError, match="ph"):
        TO.validate_trace({"traceEvents": [{"name": "x", "pid": 0}]})
    with pytest.raises(ValueError):
        TO.validate_trace({"traceEvents": [
            {"ph": "Q", "name": "x", "pid": 0}]})
    with pytest.raises(ValueError):
        TO.validate_trace({"traceEvents": [
            {"ph": "X", "name": "x", "pid": 0, "ts": "late"}]})
    assert TO.load_trace_schema() == RO.load_trace_schema()


def test_fleet_metrics_registry_is_the_references():
    eng, _, res, _, r_eng, r_res = tiny_fleets()
    m = t_fleet_metrics(res, eng).as_dict()
    want = r_fleet_metrics(r_res, r_eng).as_dict()
    assert m["counters"] == want["counters"]
    assert sorted(m["gauges"]) == sorted(want["gauges"])
    for k, v in want["gauges"].items():
        assert m["gauges"][k] == pytest.approx(v, rel=1e-5, abs=0), k
    real = res.programs[:, :, 0] != 0
    assert m["counters"]["ops_ok"] + m["counters"]["ops_illegal"] \
        == int(real.sum())
    reg = TO.MetricsRegistry()
    reg.counter("a")
    reg.counter("a", 2)
    reg.gauge("g", 3)
    assert reg.as_dict() == {"counters": {"a": 3.0}, "gauges": {"g": 3.0}}


def emit(tmp_path, name):
    prof = TO.Profiler()
    eng, configs, res, obs, _, _ = tiny_fleets(profiler=prof)
    labels = [f"{fc.describe()}/dev{d}" for fc in configs
              for d in range(2)]
    return TO.emit_fleet_obs(
        res, eng, obs=obs, out_prefix=str(tmp_path / name),
        lane_labels=labels, profiler=prof,
        recompiles=TO.RecompileCounter.engine_default(),
        meta={"suite": "test"})


def test_emit_fleet_obs_end_to_end(tmp_path):
    out = emit(tmp_path, "t")
    trace = json.loads(pathlib.Path(out["trace"]).read_text())
    TO.validate_trace(trace)
    assert out["n_events"] == len(trace["traceEvents"]) > 0
    obs = json.loads(pathlib.Path(out["obs"]).read_text())
    assert obs["schema_version"] == 1 and obs["meta"]["suite"] == "test"
    assert len(obs["lane_labels"]) == len(obs["timelines"]["lanes"]) == 4
    assert set(obs["jit_cache"]) == {"apply_op", "run_program",
                                     "run_programs", "simulate_fleet_ops"}
    assert obs["jit_cache"]["simulate_fleet_ops"] == 0
    assert obs["jit_cache"]["run_programs"] >= 2   # ALLOC + grow plans
    assert {"fleet.engine", "fleet.timing", "fleet.decode"} <= \
        set(obs["profile"])
    c = obs["metrics"]["counters"]
    h, p, d = (c["host_pages"], c["parity_pages"], c["superfluous_pages"])
    assert obs["metrics"]["gauges"]["dlwa"] == pytest.approx(
        (h + p + d) / h)
    assert obs["timelines"]["fleet"]["dlwa"][-1] == pytest.approx(
        (h + p + d) / (h + p))


def test_emit_fleet_obs_requires_telemetry(tmp_path):
    eng, configs, _, obs, _, _ = tiny_fleets()
    programs, dyn, _ = TFL.build_fleet_batch(eng, configs, n_devices=2)
    bare = TFL.run_fleet(eng, programs, dyn=dyn, n_tenants=TFL.N_TENANTS)
    assert bare.telemetry is None
    with pytest.raises(ValueError, match="telemetry"):
        TO.emit_fleet_obs(bare, eng, obs=obs,
                          out_prefix=str(tmp_path / "x"))


def test_obs_report_renders_the_ports_sidecar(tmp_path):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import obs_report
    finally:
        sys.path.pop(0)
    out = emit(tmp_path, "r")
    report = obs_report.render(
        json.loads(pathlib.Path(out["obs"]).read_text()), max_lanes=2)
    for section in ("# Flight-recorder report", "## DLWA vs time",
                    "## Wear frontier vs time",
                    "## p99 latency per tenant class",
                    "## Recompile table", "## Dispatch profile"):
        assert section in report, section
    assert "lanes omitted" in report


# --------------------------------------------------------------------- #
# profiling: sections, builds, launch plans
# --------------------------------------------------------------------- #
def test_profiler_sections_accumulate():
    prof = TO.Profiler()
    with prof.section("a"):
        pass
    with prof.section("a"):
        with prof.section("b"):
            pass
    snap = prof.snapshot()
    assert snap["a"]["calls"] == 2.0 and snap["b"]["calls"] == 1.0
    assert snap["a"]["wall_s"] >= snap["a"]["execute_s"] >= 0.0
    assert snap["a"]["trace_s"] == snap["a"]["lower_s"] == 0.0
    snap["a"]["calls"] = 99.0
    assert prof.sections["a"]["calls"] == 2.0
    assert sorted(snap["a"]) == sorted(
        ("calls", "wall_s", "trace_s", "lower_s", "compile_s",
         "execute_s", "n_compiles"))


def test_compile_time_is_the_build_record(monkeypatch):
    """``compile_s`` / ``n_compiles`` read the nvcc builds
    ``kernels/_build.build`` ran inside the section."""
    prof = TO.Profiler()
    monkeypatch.setitem(_build.BUILDS, "count", 3)
    monkeypatch.setitem(_build.BUILDS, "seconds", 1.5)
    with prof.section("build"):
        _build.BUILDS["count"] += 2
        _build.BUILDS["seconds"] += 4.25
    sec = prof.sections["build"]
    assert sec["n_compiles"] == 2.0 and sec["compile_s"] == 4.25
    assert sec["execute_s"] == 0.0


def test_profile_dispatch_counts():
    eng = tiny_engine()
    prof = TO.Profiler()
    (state, _trace), sec = TO.profile_dispatch(
        eng.run, eng.init_state(), mixed_program(eng, n=8), profiler=prof,
        name="run")
    assert int(state.host_pages) >= 0
    assert sec["calls"] == 1.0 and sec["wall_s"] > 0.0
    assert prof.sections["run"] is sec


def test_recompile_counter_counts_plans_per_lane_count():
    """One launch plan per argument signature of the two selections:
    another program length reuses them, another lane count adds one
    each."""
    eng = tiny_engine()
    rc = TO.RecompileCounter(run_programs=TE.run_programs,
                             simulate_fleet_ops=TT.simulate_fleet_ops)
    eng.run_batch(eng.init_state(), np.stack([mixed_program(eng, n=10)]
                                             * 5))
    base = rc.counts()
    eng.run_batch(eng.init_state(), np.stack([mixed_program(eng, n=11,
                                                            seed=9)] * 5))
    assert rc.delta(base) == {"run_programs": 0, "simulate_fleet_ops": 0}
    eng.run_batch(eng.init_state(), np.stack([mixed_program(eng, n=10)]
                                             * 7))
    assert rc.delta(base)["run_programs"] == 2
    assert TO.jit_cache_size(len) == -1
    with pytest.raises(ValueError):
        TO.RecompileCounter()


def test_evaluator_plans_stable_across_generations():
    eng, _, _, _, _, _ = tiny_fleets()
    configs = TFL.grid_space(segments=(4,), chunks=(64,),
                             parities=(False, True), wear=(True, False))[:4]
    ev = TFL.Evaluator(eng, n_devices=2, profiler=TO.Profiler())
    counts = []
    for _ in range(3):
        assert len(ev.evaluate(configs)) == len(configs)
        counts.append(ev.jit_cache()["run_programs"])
    assert counts[0] == counts[1] == counts[2] >= 2
    assert ev.profiler.sections["evaluator.build"]["calls"] == 3.0
    assert ev.profiler.sections["fleet.engine"]["calls"] == 3.0


def test_evolve_history_carries_profile_when_instrumented():
    eng, _, _, _, _, _ = tiny_fleets()
    space = TFL.SearchSpace(segments=(4,), chunks=(64,),
                            parities=(False, True))
    params = TFL.EvolveParams(population=2, generations=2)
    plain = TFL.evolve(eng, space=space, params=params, seed=0,
                       n_devices=2)
    assert all("jit_cache" not in row for row in plain.history)
    ev = TFL.Evaluator(eng, n_devices=2, profiler=TO.Profiler())
    inst = TFL.evolve(eng, space=space, params=params, seed=0,
                      n_devices=2, evaluator=ev)
    assert inst.history
    for row in inst.history:
        assert row["jit_cache"]["run_programs"] >= 1
        assert "fleet.engine" in row["profile"]
    assert [r["best_so_far"] for r in inst.history] == \
        [r["best_so_far"] for r in plain.history]
