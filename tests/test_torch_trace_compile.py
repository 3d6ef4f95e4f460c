"""The port's trace compiler, fleet runner and tenant encoding held to the
JAX package on the CPU.

For all three recorded workloads (lsm, ckpt, cache), at the 4-channel
toy geometry of ``tools/bench.py``'s trace comparator and at the zn540
device with a short LSM, under both allocation policies: the recorded
programs are identical, and ``replay_recorders`` / ``run_workload`` /
``tenant_class_report`` agree with the reference's -- every integer
field exactly, the op-granular clocks at rel 1e-5 (XLA may fuse a
multiply-add the port rounds twice).  The pre-dispatch row checks and
``assert_all_ok`` raise the reference's messages.

:func:`kv_zn540_golden` builds the card's KV storage dispatch -- six
zn540 lanes, 0.28 of a drive-write of LSM traffic -- with the reference and
summarises it; ``python tests/test_torch_trace_compile.py`` writes that
summary to ``tests/data/torch_kv_zn540.json``, which ``chip_smoke.py``
holds the port's dispatch on the card to.
"""

import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import repro.storage as RS
import repro_torch.storage as TS
from repro.check import validate_rows as r_validate_rows
from repro.core import engine as RE
from repro.core import headline as RH
from repro.core.elements import BLOCK as R_BLOCK
from repro.core.elements import SUPERBLOCK as R_SUPERBLOCK
from repro.core.geometry import FlashGeometry as RFlash
from repro.core.geometry import ZoneGeometry as RZone
from repro.fleet import runner as RR
from repro_torch.check import validate_rows as t_validate_rows
from repro_torch.core import engine as TE
from repro_torch.core import headline as TH
from repro_torch.core.elements import BLOCK as T_BLOCK
from repro_torch.core.elements import SUPERBLOCK as T_SUPERBLOCK
from repro_torch.core.geometry import FlashGeometry as TFlash
from repro_torch.core.geometry import ZoneGeometry as TZone
from repro_torch.fleet import runner as TR

GOLDEN = pathlib.Path(__file__).with_name("data") / "torch_kv_zn540.json"
#: the card's KV storage dispatch: the zn540 window and the workloads'
#: parameters -- those of tools/bench.py's _trace_recorders (full mode),
#: with the LSM raised from 10 flushes to 70 (0.28 of a drive-write, the
#: LSM lane as long as the cache lane: 2,048 op steps)
KV = {"n_zones": 48, "max_active": 14, "n_tenants": 3, "pad_quantum": 64,
      "lsm": {"seed": 0, "n_flushes": 70},
      "ckpt": {"n_steps": 24, "shards": 3, "seed": 0},
      "cache": {"n_accesses": 2000, "n_keys": 64, "seed": 0,
                "capacity_zones": 6, "obj_pages": 4}}
#: _trace_recorders' quick mode, for its own toy device (16 zones, 8
#: active)
TOY = dict(KV, n_zones=16, max_active=8,
           lsm={"seed": 0, "n_flushes": 6},
           ckpt={"n_steps": 10, "shards": 3, "seed": 0},
           cache=dict(KV["cache"], n_accesses=600))
POLICIES = ("traditional", "silent")
TIME_REL = 1e-5
TIME_FIELDS = ("completions", "latencies", "makespans")
INT_FIELDS = ("programs", "ok", "host_delta", "dummy_delta", "erase_delta",
              "pages")


# --------------------------------------------------------------------- #
# the KV dispatch, on either package
# --------------------------------------------------------------------- #
def kv_recorders(S, eng, p=KV, workloads=("lsm", "ckpt", "cache")):
    """One class-tagged recorder per workload of the KV dispatch (its
    parameters ``p``: :data:`KV` or :data:`TOY`), built with storage
    package ``S`` (``repro.storage`` or ``repro_torch.storage``) over
    ``eng``'s zone capacity."""
    recs = {}
    for name in workloads:
        classes = S.WORKLOADS[name]
        rec = S.RecordingBackend(
            eng.flash, zone_pages=eng.cfg.zone_pages, n_zones=p["n_zones"],
            max_active=p["max_active"],
            class_tenants={c: i for i, c in enumerate(classes)})
        if name == "lsm":
            cfg = S.scaled_kv_config(
                rec.zone_pages, eng.flash.page_bytes, seed=p["lsm"]["seed"],
                n_flushes=p["lsm"]["n_flushes"],
                max_jobs=S.compile._lsm_jobs(rec))
            sim = S.LSMSimulator(S.ZoneFS(rec), cfg)
            sim.run()
            assert not sim.failed
        elif name == "ckpt":
            S.record_checkpoints(rec, S.CheckpointSchedule(**p["ckpt"]))
        else:
            S.record_cache(rec, **p["cache"])
        recs[name] = rec
    return recs


def kv_lanes(S, H, block, eng, recs):
    """(recorders, dyns, labels): each workload on a traditional
    whole-zone lane and a silent BLOCK lane."""
    trad = eng.dyn(spec=H.traditional_spec(eng.zone_geom))
    silent = eng.dyn(spec=block, alloc_policy="silent")
    lanes = [(name, policy, rec) for name, rec in recs.items()
             for policy in POLICIES]
    return ([rec for _, _, rec in lanes],
            [trad if policy == "traditional" else silent
             for _, policy, _ in lanes],
            [(name, policy) for name, policy, _ in lanes])


def sha256(a) -> str:
    """sha256 of an integer array's int32 (bool: uint8) C-order bytes."""
    a = np.asarray(a)
    a = a.astype(np.uint8 if a.dtype == np.bool_ else np.int32)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def capture_run_batch(eng) -> list:
    """Record what ``eng.run_batch`` returns (the dispatch's states and
    op traces), for the runner that calls it."""
    out = []
    run_batch = eng.run_batch

    def wrapped(*args, **kw):
        out.append(run_batch(*args, **kw))
        return out[-1]
    eng.run_batch = wrapped
    return out


def kv_summary(S, eng, res, states, trace, recs, labels, to_numpy) -> dict:
    """The dispatch's per-lane record: program, state and trace hashes,
    metrics, makespan and per-class latency report."""
    lanes = []
    for k, (name, policy) in enumerate(labels):
        lanes.append({
            "workload": name,
            "policy": policy,
            "n_ops": len(recs[k]),
            "program_sha256": sha256(recs[k].program()),
            "state_sha256": {f: sha256(to_numpy(getattr(states, f))[k])
                             for f in type(states)._fields},
            "trace_sha256": {f: sha256(to_numpy(getattr(trace, f))[k])
                             for f in type(trace)._fields},
            "metrics": S.lane_metrics(eng, res, k),
            "makespan_s": float(res.makespans[k]),
            "classes": res.tenant_class_report(
                lanes=[k], names=list(S.WORKLOADS[name])),
        })
    return {"op_steps": int(res.programs.shape[1]), "lanes": lanes}


def kv_zn540_golden() -> dict:
    """The KV dispatch at zn540 through the reference: its parameters
    and :func:`kv_summary`."""
    eng = RH.build_headline_engine()
    recs, dyns, labels = kv_lanes(RS, RH, R_BLOCK, eng,
                                  kv_recorders(RS, eng))
    got = capture_run_batch(eng)
    res = RS.replay_recorders(eng, recs, dyns=dyns,
                              n_tenants=KV["n_tenants"],
                              pad_quantum=KV["pad_quantum"], check=True,
                              sanitize=True)
    states, trace = got[-1]
    return dict(params=KV, **kv_summary(RS, eng, res, states, trace, recs,
                                        labels, np.asarray))


#: the report keys that are times (or their ratio): held at TIME_REL
TIME_KEYS = {"makespan_s", "mean_latency_s", "p50_latency_s",
             "p99_latency_s", "max_latency_s", "p99_over_p50"}


def assert_same_floats(got, want, where: str, key: str = "") -> None:
    """Nested dicts/lists equal: the values under :data:`TIME_KEYS` at
    rel :data:`TIME_REL`, everything else (counts, DLWA, hashes)
    exactly."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same_floats(got[k], want[k], f"{where}.{k}", k)
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_floats(a, b, f"{where}[{i}]", key)
    elif key in TIME_KEYS:
        assert got == pytest.approx(want, rel=TIME_REL, abs=0), where
    else:
        assert got == want, where


def test_kv_zn540_golden_file_is_current():
    """Regenerating the card's reference summary on the CPU gives the
    committed file: parameters, hashes, counts and DLWA exactly, times
    at rel 1e-5 (the committed file may come from another CPU)."""
    want = json.loads(GOLDEN.read_text())
    got = json.loads(json.dumps(kv_zn540_golden()))
    assert got["op_steps"] == want["op_steps"] == 2048
    assert [lane["n_ops"] for lane in want["lanes"]][0] == 2021
    assert_same_floats(got, want, "golden")


# --------------------------------------------------------------------- #
# replay on both packages
# --------------------------------------------------------------------- #
def toy_engines(spec_r, spec_t):
    """``tools/bench.py``'s trace-comparator device on both packages."""
    kw = dict(n_channels=4, ways_per_channel=1, blocks_per_lun=32,
              pages_per_block=4, page_bytes=4096)
    zg = dict(parallelism=4, n_segments=2)
    return (RE.ZoneEngine(RFlash(**kw), RZone(**zg), spec_r, max_active=8),
            TE.ZoneEngine(TFlash(**kw), TZone(**zg), spec_t, max_active=8,
                          device="cpu"))


def assert_same_result(r, t, where: str) -> None:
    for f in INT_FIELDS:
        a, b = getattr(r, f), getattr(t, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{where}: {f}"
    for f in TIME_FIELDS:
        a, b = getattr(r, f), getattr(t, f)
        assert a.dtype == b.dtype == np.float32, f"{where}: {f}"
        np.testing.assert_allclose(b, a, rtol=TIME_REL, atol=0,
                                   err_msg=f"{where}: {f}")
    for rs, ts, name in zip(r.states, t.states, type(r.states)._fields):
        assert np.array_equal(np.asarray(rs), ts.numpy()), \
            f"{where}: state.{name}"
    assert (r.n_tenants, r.parity_tenant) == (t.n_tenants, t.parity_tenant)
    assert np.array_equal(r.elem_mask, t.elem_mask), where


def replay_both(r_eng, t_eng, p, workloads):
    """The KV recipe's lanes for ``workloads`` (parameters ``p``),
    recorded and replayed on each package; returns both results and
    summaries."""
    out = []
    for S, H, block, eng, to_numpy in (
            (RS, RH, R_BLOCK, r_eng, np.asarray),
            (TS, TH, T_BLOCK, t_eng, lambda t: t.numpy())):
        recs, dyns, labels = kv_lanes(S, H, block, eng,
                                      kv_recorders(S, eng, p, workloads))
        got = capture_run_batch(eng)
        res = S.replay_recorders(eng, recs, dyns=dyns,
                                 n_tenants=p["n_tenants"],
                                 pad_quantum=p["pad_quantum"],
                                 sanitize=True)
        states, trace = got[-1]
        out.append((res, kv_summary(S, eng, res, states, trace, recs,
                                    labels, to_numpy)))
    return out


@pytest.mark.parametrize("name", ["lsm", "ckpt", "cache"])
def test_kv_lanes_replay_like_the_reference_at_the_toy_geometry(name):
    """Each workload on a traditional and a silent lane of the toy
    union engine, at ``_trace_recorders``' quick-mode sizes: the
    recorded programs, every state and trace field of both lanes, the
    metrics, clocks and class reports."""
    flash_kw = dict(n_channels=4, ways_per_channel=1, blocks_per_lun=32,
                    pages_per_block=4, page_bytes=4096)
    zg = dict(parallelism=4, n_segments=2)
    r_eng = RH.build_headline_engine(RFlash(**flash_kw), RZone(**zg),
                                     max_active=8)
    t_eng = TH.build_headline_engine(TFlash(**flash_kw), TZone(**zg),
                                     max_active=8, device="cpu")
    assert t_eng.cfg.n_zones == TOY["n_zones"]
    (r_res, r_sum), (t_res, t_sum) = replay_both(r_eng, t_eng, TOY, [name])
    assert_same_result(r_res, t_res, name)
    assert_same_floats(t_sum, r_sum, name)


def test_kv_lanes_replay_like_the_reference_at_zn540():
    """The KV recipe's LSM lanes at the zn540 device with a short LSM
    (8 flushes), both policies: the port's replay equals the
    reference's."""
    p = dict(KV, lsm=dict(KV["lsm"], n_flushes=8))
    (r_res, r_sum), (t_res, t_sum) = replay_both(
        RH.build_headline_engine(), TH.build_headline_engine(device="cpu"),
        p, ["lsm"])
    assert r_sum["lanes"][0]["n_ops"] > 200
    assert_same_result(r_res, t_res, "zn540")
    assert_same_floats(t_sum, r_sum, "zn540")


@pytest.mark.parametrize("name", ["lsm", "ckpt", "cache"])
def test_run_workload_matches_the_reference(name):
    """``run_workload``'s two class-tagged lanes and its report."""
    r_eng, t_eng = toy_engines(R_SUPERBLOCK, T_SUPERBLOCK)
    r_res, r_rep = RS.run_workload(r_eng, name, pad_quantum=32,
                                   sanitize=True)
    t_res, t_rep = TS.run_workload(t_eng, name, pad_quantum=32,
                                   sanitize=True)
    assert_same_result(r_res, t_res, name)
    assert_same_floats(t_rep, r_rep, name)
    lanes = np.arange(len(r_res.programs))
    assert_same_floats(TR.config_report(t_res, t_eng, lanes),
                       RR.config_report(r_res, r_eng, lanes), name)
    assert TR.dispatch_cost(t_res) == RR.dispatch_cost(r_res)
    assert TR.real_op_count(t_res) == RR.real_op_count(r_res)


@pytest.mark.parametrize("name", ["lsm", "ckpt", "cache"])
def test_workload_mix_programs_match_the_reference(name):
    """The tenant-mix builder records the reference's programs (the
    reference registers it in its search's mix table)."""
    from repro.fleet.search import MIXES
    r_eng, t_eng = toy_engines(R_SUPERBLOCK, T_SUPERBLOCK)
    want = MIXES[name](r_eng, r_eng.cfg.zone_pages)
    got = TS.compile._workload_mix(name)(t_eng, t_eng.cfg.zone_pages)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert np.array_equal(a, b), name


def test_for_engine_recorder_reports_like_the_reference():
    r_eng, t_eng = toy_engines(R_SUPERBLOCK, T_SUPERBLOCK)
    reps = []
    for S, eng in ((RS, r_eng), (TS, t_eng)):
        rec = S.RecordingBackend.for_engine(eng, max_active=6)
        fs = S.ZoneFS(rec)
        fs.create(1, 10, 0)
        fs.create(2, 40, 1)
        fs.delete(1)
        reps.append((fs.report(), rec.program(), rec.dummy_pages))
    assert reps[1][0] == reps[0][0]
    assert np.array_equal(reps[1][1], reps[0][1])
    assert reps[1][2] == reps[0][2]


# --------------------------------------------------------------------- #
# the checks before and after a dispatch
# --------------------------------------------------------------------- #
def _message(fn, *args, **kw) -> tuple:
    try:
        fn(*args, **kw)
    except (ValueError, AssertionError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("col,value,kw", [
    (0, 9, {}), (1, -3, {"where": "wl"}), (2, -1, {}),
    (4, 5, {"n_tenants": 2}), (4, 3, {"n_tenants": 2, "parity_tenant": 2}),
])
def test_validate_rows_raises_the_reference_messages(col, value, kw):
    rows = np.asarray([[RE.OP_WRITE, 0, 4, 1, 0],
                       [RE.OP_READ, 1, 2, 0, 1]], np.int32)
    rows[1, col] = value
    want = _message(r_validate_rows, rows[None], **kw)
    assert want is not None
    assert _message(t_validate_rows, rows[None], **kw) == want
    assert _message(t_validate_rows, rows[:, :3]) == _message(
        r_validate_rows, rows[:, :3])


def test_replay_recorders_rejects_rows_and_divergence_as_the_reference():
    r_eng, t_eng = toy_engines(R_SUPERBLOCK, T_SUPERBLOCK)
    msgs = []
    for S, eng in ((RS, r_eng), (TS, t_eng)):
        bad = S.RecordingBackend(eng.flash, zone_pages=eng.cfg.zone_pages,
                                 n_zones=4, max_active=3)
        bad._rows.append((RE.OP_WRITE, -1, 4, 1, 0))
        rec = S.RecordingBackend(eng.flash, zone_pages=eng.cfg.zone_pages,
                                 n_zones=4, max_active=3)
        rec.zone_write(0, 4)
        # this write overflows the zone
        rec._rows.append((RE.OP_WRITE, 0, eng.cfg.zone_pages, RE.F_HOST, 0))
        msgs.append((_message(S.replay_recorders, eng, [bad]),
                     _message(S.replay_recorders, eng, [rec])))
    assert msgs[0][0][0] is ValueError and "negative zone" in msgs[0][0][1]
    assert "error class 'overflow'" in msgs[0][1][1]
    assert msgs[1] == msgs[0]


def test_assert_all_ok_names_the_reference_error_class():
    r_eng, t_eng = toy_engines(R_BLOCK, T_BLOCK)
    zp = r_eng.cfg.zone_pages
    rows = np.zeros((3, 4, 5), np.int32)
    rows[0, 0] = (RE.OP_WRITE, 0, zp, RE.F_HOST, 0)
    rows[1, 0] = (RE.OP_WRITE, 0, zp + 1, RE.F_HOST, 0)   # overflow
    rows[2, :2] = [(RE.OP_WRITE, 1, zp, RE.F_HOST, 0),
                   (RE.OP_WRITE, 1, 1, RE.F_HOST, 0)]     # FULL
    for lanes in (None, np.asarray([2])):
        want = _message(RR.assert_all_ok, RR.run_fleet(r_eng, rows), lanes)
        got = _message(TR.assert_all_ok, TR.run_fleet(t_eng, rows), lanes)
        assert want is not None and "predicted error class" in want[1]
        assert got == want
    dyn_r = RE.stack_dyn([r_eng.dyn(alloc_policy="silent")] * 3)
    dyn_t = TE.stack_dyn([t_eng.dyn(alloc_policy="silent")] * 3)
    assert _message(TR.assert_all_ok, TR.run_fleet(t_eng, rows, dyn=dyn_t)
                    ) == _message(RR.assert_all_ok,
                                  RR.run_fleet(r_eng, rows, dyn=dyn_r))


def test_cuda_engine_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TH.build_headline_engine()


if __name__ == "__main__":
    GOLDEN.parent.mkdir(exist_ok=True)
    GOLDEN.write_text(json.dumps(kv_zn540_golden(), indent=1,
                                 sort_keys=True) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
