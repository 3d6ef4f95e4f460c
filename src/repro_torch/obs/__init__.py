"""Flight recorder for the batched engine: telemetry, profiling, export
(the port of ``repro.obs``).

End-of-run scalars (``ZoneEngine.metrics``, ``runner.config_report``)
reproduce the paper's aggregates but hide the *temporal* structure: a
fleet run that writes superfluously in one occupancy band looks
identical to a healthy one.  This package makes the hidden costs visible
without giving up the one-dispatch execution model:

* :mod:`repro_torch.obs.recorder` -- an opt-in telemetry accumulator
  carried through the ``run_program(s)`` op loop (``ObsConfig``): per-op
  host/superfluous pages, wear, occupancy and legality binned into
  fixed-size time-bucketed histograms per lane on the engine's device,
  plus host-side decoding into per-tenant / per-zone / per-device
  timeline dicts (plain lists, no pandas);
* :mod:`repro_torch.obs.profile`  -- dispatch-level profiling: wall time
  split into kernel builds vs execute, a counter of the launch plans the
  kernels keep per argument signature, and per-section counters the
  fleet runner / evaluator / evolve loop thread through;
* :mod:`repro_torch.obs.export`   -- Chrome/Perfetto ``trace_event`` JSON
  export (tenants -> tracks, ops -> duration events on the
  ``timing.simulate_fleet_ops`` clock) plus a counters/gauges metrics
  registry sidecar, schema-validated against
  ``docs/schema/perfetto_trace.schema.json``.

The recorder is effect-free on device results: telemetry-on and
telemetry-off runs produce bit-identical ``DeviceState`` / ``OpTrace``
(``tests/test_torch_obs.py``).
"""

from repro_torch.obs.export import (MetricsRegistry, emit_fleet_obs,
                                    fleet_trace_events, load_trace_schema,
                                    validate_trace, write_trace)
from repro_torch.obs.profile import (COMPILE_LOG, CompileLog, Profiler,
                                     RecompileCounter, jit_cache_size,
                                     profile_dispatch)
from repro_torch.obs.recorder import (ObsConfig, TelemetryState,
                                      device_rollup, fleet_timelines,
                                      lane_timeline, telemetry_init,
                                      telemetry_update, tenant_timelines,
                                      zone_timelines)

__all__ = [
    "ObsConfig", "TelemetryState", "telemetry_init", "telemetry_update",
    "lane_timeline", "fleet_timelines", "tenant_timelines",
    "zone_timelines", "device_rollup",
    "COMPILE_LOG", "CompileLog", "Profiler", "RecompileCounter",
    "jit_cache_size", "profile_dispatch",
    "MetricsRegistry", "fleet_trace_events", "write_trace",
    "validate_trace", "load_trace_schema", "emit_fleet_obs",
]
