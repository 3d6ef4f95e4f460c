"""Chrome/Perfetto ``trace_event`` export + metrics-registry sidecar (the
port of ``repro.obs.export``).

A fleet dispatch already computes everything a trace viewer needs: the
op-granular completion times and latencies of
:func:`repro_torch.core.timing.simulate_fleet_ops` plus the per-op page
deltas of the :class:`OpTrace`.  :func:`fleet_trace_events` maps them
onto the Chrome ``trace_event`` JSON the Perfetto UI
(https://ui.perfetto.dev) loads directly:

* process (pid)  = fleet *lane* (one emulated member device);
* thread  (tid)  = *tenant class* (real tenants + the parity tag), so
  each tenant is its own named track;
* ``X`` duration events = executed zone ops, ``ts``/``dur`` in
  microseconds on the simulated clock (service time
  ``ceil(pages / P) * t_page``; closed-loop latency incl. queueing in
  ``args``);
* ``C`` counter events = cumulative host/superfluous pages per lane
  (the DLWA numerator/denominator as a live counter track).

:func:`validate_trace` checks an exported object against the
checked-in JSON schema (``docs/schema/perfetto_trace.schema.json``)
with a dependency-free subset validator -- and with the real
``jsonschema`` package too when it is importable (it is optional).

:class:`MetricsRegistry` is the sidecar: monotonically accumulating
counters + last-value gauges, serialized next to the trace so a run's
scalars travel with its timeline (:func:`emit_fleet_obs` writes both).
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional, Sequence

import numpy as np

#: opcode names (index = repro_torch.core.engine opcode)
OP_NAMES = ("NOP", "ALLOC", "WRITE", "FINISH", "RESET", "READ")

_SCHEMA_PATH = (pathlib.Path(__file__).resolve().parents[3]
                / "docs" / "schema" / "perfetto_trace.schema.json")


# --------------------------------------------------------------------- #
# trace_event generation
# --------------------------------------------------------------------- #
def _tenant_label(t: int, res) -> str:
    return "parity" if t == res.parity_tenant else f"tenant {t}"


def fleet_trace_events(res, eng, *,
                       lane_labels: Optional[Sequence[str]] = None,
                       counters: bool = True) -> List[dict]:
    """``FleetResult`` -> Chrome ``trace_event`` list.

    ``lane_labels`` names the process tracks (default
    ``lane L``; a ``build_fleet_batch`` caller passes
    ``f"{config}/dev{d}"``).  Zero-page ops (FINISH of an exactly-full
    zone, RESET, illegal rejects) are emitted as zero-duration events
    at their completion time so legality problems stay visible on the
    timeline.
    """
    t_page = float(eng.flash.t_prog + eng.flash.t_xfer)
    par = int(eng.cfg.parallelism)
    programs = np.asarray(res.programs)
    pages = np.asarray(res.pages)
    done = np.asarray(res.completions, dtype=np.float64)
    lat = np.asarray(res.latencies, dtype=np.float64)
    ok = np.asarray(res.ok)
    host = np.asarray(res.host_delta, dtype=np.int64)
    dummy = np.asarray(res.dummy_delta, dtype=np.int64)
    n_lanes, n_ops = programs.shape[0], programs.shape[1]
    n_classes = res.parity_tenant + 1

    events: List[dict] = []
    for lane in range(n_lanes):
        label = (lane_labels[lane] if lane_labels is not None
                 else f"lane {lane}")
        events.append({"ph": "M", "name": "process_name", "pid": lane,
                       "args": {"name": label}})
        for t in range(n_classes):
            events.append({"ph": "M", "name": "thread_name",
                           "pid": lane, "tid": t,
                           "args": {"name": _tenant_label(t, res)}})
        cum_h = 0
        cum_d = 0
        for i in range(n_ops):
            op = int(programs[lane, i, 0])
            if op == 0:                       # NOP padding: invisible
                continue
            pg = int(pages[lane, i])
            dur = (-(-pg // par)) * t_page if pg > 0 else 0.0
            ts = done[lane, i] - dur
            tenant = int(programs[lane, i, -1]) if \
                programs.shape[2] > 4 else 0
            name = (OP_NAMES[op] if op < len(OP_NAMES)
                    else f"OP{op}") + f" z{int(programs[lane, i, 1])}"
            events.append({
                "ph": "X", "name": name, "cat": "zns_op",
                "pid": lane, "tid": min(tenant, n_classes - 1),
                "ts": round(ts * 1e6, 3),
                "dur": round(dur * 1e6, 3),
                "args": {
                    "zone": int(programs[lane, i, 1]),
                    "pages": pg,
                    "host_pages": int(host[lane, i]),
                    "dummy_pages": int(dummy[lane, i]),
                    "ok": bool(ok[lane, i]),
                    "latency_us": round(float(lat[lane, i]) * 1e6, 3),
                }})
            if counters and (host[lane, i] or dummy[lane, i]):
                cum_h += int(host[lane, i])
                cum_d += int(dummy[lane, i])
                events.append({
                    "ph": "C", "name": "pages", "pid": lane,
                    "ts": round(done[lane, i] * 1e6, 3),
                    "args": {"host": cum_h, "superfluous": cum_d}})
    return events


def write_trace(path, events: List[dict],
                meta: Optional[dict] = None) -> dict:
    """Wrap events in the JSON-object trace format, write, and return
    the object (Perfetto/chrome://tracing load the file as-is)."""
    obj = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": dict(meta or {})}
    pathlib.Path(path).write_text(json.dumps(obj, indent=1) + "\n")
    return obj


# --------------------------------------------------------------------- #
# schema validation (stdlib subset + real jsonschema when importable)
# --------------------------------------------------------------------- #
def load_trace_schema(path=None) -> dict:
    """The checked-in trace_event schema (docs/schema/)."""
    return json.loads(pathlib.Path(path or _SCHEMA_PATH).read_text())


_TYPES = {"object": dict, "array": list, "string": str,
          "boolean": bool, "integer": int, "number": (int, float)}


def _check(obj, schema: dict, where: str) -> None:
    t = schema.get("type")
    if t is not None:
        want = _TYPES[t]
        if not isinstance(obj, want) or (t in ("integer", "number")
                                         and isinstance(obj, bool)):
            raise ValueError(f"{where}: expected {t}, "
                             f"got {type(obj).__name__}")
    if "enum" in schema and obj not in schema["enum"]:
        raise ValueError(f"{where}: {obj!r} not in {schema['enum']}")
    if isinstance(obj, dict):
        for req in schema.get("required", ()):
            if req not in obj:
                raise ValueError(f"{where}: missing required key "
                                 f"{req!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in obj:
                _check(obj[key], sub, f"{where}.{key}")
    if isinstance(obj, list) and "items" in schema:
        for i, item in enumerate(obj):
            _check(item, schema["items"], f"{where}[{i}]")


def validate_trace(obj: dict, schema: Optional[dict] = None) -> None:
    """Raise ``ValueError`` unless ``obj`` conforms to the trace
    schema.  Always runs the dependency-free subset validator; also
    runs the full ``jsonschema`` validator when the package exists."""
    schema = schema or load_trace_schema()
    _check(obj, schema, "$")
    try:
        import jsonschema
    except ImportError:
        return
    try:
        jsonschema.validate(obj, schema)
    except jsonschema.ValidationError as exc:
        raise ValueError(f"jsonschema: {exc.message}") from exc


# --------------------------------------------------------------------- #
# metrics registry sidecar
# --------------------------------------------------------------------- #
class MetricsRegistry:
    """Counters (monotonic sums) + gauges (last value), JSON-ready."""

    def __init__(self) -> None:
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}

    def counter(self, name: str, inc: float = 1.0) -> None:
        self._counters[name] = self._counters.get(name, 0.0) + float(inc)

    def gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {"counters": dict(self._counters),
                "gauges": dict(self._gauges)}


def fleet_metrics(res, eng) -> MetricsRegistry:
    """The standard fleet scalars as a registry: page counters split by
    class, legality counts, DLWA / p99 / makespan gauges."""
    reg = MetricsRegistry()
    t = np.asarray(res.tenants)
    h = np.asarray(res.host_delta, dtype=np.int64)
    par = int(h[t == res.parity_tenant].sum())
    host = int(h.sum()) - par
    dummy = int(np.asarray(res.dummy_delta, dtype=np.int64).sum())
    reg.counter("host_pages", host)
    reg.counter("parity_pages", par)
    reg.counter("superfluous_pages", dummy)
    reg.counter("block_erases",
                int(np.asarray(res.erase_delta, dtype=np.int64).sum()))
    real = np.asarray(res.programs)[:, :, 0] != 0
    okc = int((real & np.asarray(res.ok)).sum())
    reg.counter("ops_ok", okc)
    reg.counter("ops_illegal", int(real.sum()) - okc)
    reg.gauge("dlwa", (host + par + dummy) / host if host else 1.0)
    lanes = np.arange(res.programs.shape[0])
    for k, v in res.tenant_p99_latency(lanes).items():
        reg.gauge(f"tenant{k}_p99_latency_s", v)
    reg.gauge("makespan_s", float(np.asarray(res.makespans).max()))
    return reg


def emit_fleet_obs(res, eng, *, obs, out_prefix,
                   lane_labels: Optional[Sequence[str]] = None,
                   profiler=None, recompiles=None,
                   meta: Optional[dict] = None) -> dict:
    """Write the two artifacts of one observed fleet dispatch.

    * ``<out_prefix>_trace.json`` -- the Perfetto trace (validated
      against the checked-in schema before returning);
    * ``<out_prefix>_obs.json``   -- telemetry timelines (per lane +
      per tenant + pooled), the metrics registry, and (when given) the
      profiler sections and recompile-counter readings.

    ``res`` must come from ``run_fleet(..., obs=obs)`` so it carries
    the telemetry stack.  Returns ``{"trace": path, "obs": path,
    "n_events": int}``.
    """
    from repro_torch.obs import recorder

    if res.telemetry is None:
        raise ValueError("FleetResult has no telemetry; run the fleet "
                         "with obs=ObsConfig(...)")
    events = fleet_trace_events(res, eng, lane_labels=lane_labels)
    trace_path = f"{out_prefix}_trace.json"
    validate_trace(write_trace(trace_path, events, meta=meta))

    lanes = recorder.fleet_timelines(obs, res.telemetry)
    obs_obj = {
        "schema_version": 1,
        "meta": dict(meta or {}),
        "n_tenants": int(res.n_tenants),
        "parity_tenant": int(res.parity_tenant),
        "lane_labels": (list(lane_labels) if lane_labels is not None
                        else [f"lane {i}" for i in range(len(lanes))]),
        "metrics": fleet_metrics(res, eng).as_dict(),
        "timelines": {
            "lanes": lanes,
            "tenants": recorder.tenant_timelines(obs, res.telemetry),
            "fleet": recorder.device_rollup(lanes),
        },
        "profile": profiler.snapshot() if profiler is not None else {},
        "jit_cache": (recompiles.counts()
                      if recompiles is not None else {}),
    }
    obs_path = f"{out_prefix}_obs.json"
    pathlib.Path(obs_path).write_text(
        json.dumps(obs_obj, indent=1) + "\n")
    return {"trace": trace_path, "obs": obs_path,
            "n_events": len(events)}
