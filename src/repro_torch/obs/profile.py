"""Dispatch-level profiling: build-time split + launch-plan counting (the
port of ``repro.obs.profile``).

Two independent instruments, both cheap enough to leave on:

* :class:`CompileLog` -- a process-global view of the kernel builds
  ``repro_torch.kernels._build.build`` has run (each an ``nvcc`` of one
  CUDA source).  A :class:`Profiler` section snapshots it around a region
  of host code, which splits the region's wall time into build vs
  everything else -- a warm dispatch shows zero build seconds, a first
  call shows exactly where the time went.  Eager PyTorch traces and
  lowers nothing, so ``trace_s`` and ``lower_s`` stay 0.0 (the keys are
  kept so ``tools/obs_report.py`` renders the sidecar as it renders the
  reference's).
* :class:`RecompileCounter` -- counts the launch plans the kernels keep
  per argument signature (shapes, strides, dtypes, device) behind the
  functions it watches: the port's version of "one jit-cache entry per
  abstract input signature".  A stable count across repeated dispatches
  proves shape stability; a growing count is a new signature per call.

Both degrade gracefully: a function with no plan cache behind it reads
``-1`` rather than raising.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

_PHASES = ("trace_s", "lower_s", "compile_s")


class CompileLog:
    """The kernel builds of this process, as compile-phase totals.

    One process-global instance (:data:`COMPILE_LOG`); sections diff its
    :meth:`snapshot` around regions.  ``compile_s`` / its count read the
    build record of ``repro_torch.kernels._build`` (seconds and number of
    ``nvcc`` runs); the tracing and lowering phases do not exist in eager
    PyTorch and stay 0."""

    def snapshot(self) -> Dict[str, Dict]:
        from repro_torch.kernels import _build
        totals = {k: 0.0 for k in _PHASES}
        counts = {k: 0 for k in _PHASES}
        totals["compile_s"] = float(_build.BUILDS["seconds"])
        counts["compile_s"] = int(_build.BUILDS["count"])
        return {"totals": totals, "counts": counts}


#: the process-global compile log every Profiler defaults to
COMPILE_LOG = CompileLog()


class Profiler:
    """Named per-section counters with a build/execute wall split.

    ``with prof.section("fleet.engine"): ...`` accumulates, per name:
    ``calls``, ``wall_s``, the build seconds that elapsed inside
    (``compile_s``, with ``trace_s``/``lower_s`` always 0), ``n_compiles``
    (kernel builds triggered), and ``execute_s`` (wall minus builds --
    device execution plus host-side work).  Sections nest; build time
    then shows up in every enclosing section, which is the truthful
    reading (it *did* elapse there)."""

    def __init__(self, compile_log: Optional[CompileLog] = None) -> None:
        self.sections: Dict[str, Dict[str, float]] = {}
        self._log = compile_log if compile_log is not None else COMPILE_LOG

    @contextlib.contextmanager
    def section(self, name: str):
        before = self._log.snapshot()
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            wall = time.perf_counter() - t0
            after = self._log.snapshot()
            d = self.sections.setdefault(name, {
                "calls": 0.0, "wall_s": 0.0, "trace_s": 0.0,
                "lower_s": 0.0, "compile_s": 0.0, "execute_s": 0.0,
                "n_compiles": 0.0})
            d["calls"] += 1.0
            d["wall_s"] += wall
            in_compile = 0.0
            for k in _PHASES:
                dt = after["totals"][k] - before["totals"][k]
                d[k] += dt
                in_compile += dt
            d["n_compiles"] += (after["counts"]["compile_s"]
                                - before["counts"]["compile_s"])
            d["execute_s"] += max(0.0, wall - in_compile)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """JSON-ready copy of all section counters."""
        return copy.deepcopy(self.sections)


def _zns_plans() -> int:
    """Launch plans of the engine's two fused selections (the only
    kernels an op step launches)."""
    from repro_torch.kernels.zns_alloc import ops
    return sum(1 for sig in ops._plans if sig[0] in ("alloc", "grow"))


def _no_plans() -> int:
    return 0


def _page_clock_plans() -> int:
    """Launch plans of the page-granular timing kernel (one per stream
    shape, as the reference's jitted scan compiles one per shape)."""
    from repro_torch.kernels.page_clock import ops
    return len(ops._plans)


def _plan_counters() -> Dict[Callable, Callable[[], int]]:
    """The dispatch surface -> the plan caches of the kernels it runs.
    ``simulate_fleet_ops`` launches no kernel of the port's own, so it
    keeps no plan; the page-granular ``simulate`` / ``simulate_fleet``
    (behind ``run_trace`` / ``run_fleet_trace``) launch ``page_clock``."""
    from repro_torch.core import engine, timing
    return {engine.apply_op: _zns_plans, engine.run_program: _zns_plans,
            engine.run_programs: _zns_plans,
            timing.simulate_fleet_ops: _no_plans,
            timing.simulate: _page_clock_plans,
            timing.simulate_fleet: _page_clock_plans}


def jit_cache_size(fn) -> int:
    """Launch plans kept behind ``fn`` (one per argument signature its
    kernels have seen), or -1 if ``fn`` is not on the dispatch
    surface."""
    count = _plan_counters().get(fn)
    return -1 if count is None else int(count())


class RecompileCounter:
    """Watches the launch-plan caches behind named functions.

    ``RecompileCounter(run_programs=engine.run_programs).counts()``
    returns ``{name: plan entries}``; :meth:`delta` diffs two readings
    (positive = that many new argument signatures were planned in
    between).  Counts are process-global per kernel, so *stability*
    across repeated calls, not the absolute value, is the signal."""

    def __init__(self, **fns: Callable) -> None:
        if not fns:
            raise ValueError("name at least one function to watch")
        self._fns = dict(fns)

    @classmethod
    def engine_default(cls) -> "RecompileCounter":
        """The engine + fleet-timing dispatch surface."""
        from repro_torch.core import engine, timing
        return cls(apply_op=engine.apply_op,
                   run_program=engine.run_program,
                   run_programs=engine.run_programs,
                   simulate_fleet_ops=timing.simulate_fleet_ops)

    def counts(self) -> Dict[str, int]:
        return {n: jit_cache_size(f) for n, f in self._fns.items()}

    def delta(self, before: Dict[str, int]) -> Dict[str, int]:
        return {n: c - before.get(n, 0)
                for n, c in self.counts().items()}


def _synchronize(out) -> None:
    """Wait for the devices of every tensor in ``out`` (tensors in
    nested tuples, lists, dicts and dataclasses)."""
    devices = set()

    def walk(x) -> None:
        if isinstance(x, torch.Tensor):
            devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    walk(out)
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def profile_dispatch(fn: Callable, *args,
                     profiler: Optional[Profiler] = None,
                     name: Optional[str] = None, **kwargs):
    """Call ``fn`` under a profiler section, waiting for its outputs'
    devices so the section's wall time covers device execution.  Returns
    ``(result, section counters)``; pass ``profiler`` to accumulate into
    an existing one."""
    prof = profiler if profiler is not None else Profiler()
    label = name or getattr(fn, "__name__", "dispatch")
    with prof.section(label):
        out = fn(*args, **kwargs)
        _synchronize(out)
    return out, prof.sections[label]
