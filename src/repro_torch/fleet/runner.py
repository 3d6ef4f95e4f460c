"""Batched fleet execution: T tenants x N devices x K configs, one dispatch
(the port of ``repro.fleet.runner``).

A fleet *lane* is one (config, member-device) pair: a width-5 op program
(see :mod:`repro_torch.fleet.tenants`) plus a per-lane
:class:`repro_torch.core.engine.DynConfig` selecting the member's
effective zone geometry / allocator on the shared padded static
:class:`~repro_torch.core.engine.EngineConfig`.  :func:`run_fleet` stacks
all lanes and executes them through ONE ``run_programs`` dispatch (every
lane stepped at once on the engine's device), then scores latency with
ONE :func:`repro_torch.core.timing.simulate_fleet_ops` pass on the same
device -- no per-config or per-device Python loops on the hot path.
The per-op results come back as numpy arrays, as in the reference; the
final states stay on the engine's device.

Metric units: page counters count flash pages, ``erase_delta`` counts
erase-block erasures, times are seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import engine as zengine
from repro_torch.core import timing
from repro_torch.core.elements import union_grid_mask
from repro_torch.core.engine import DeviceState, DynConfig, ZoneEngine
from repro_torch.fleet.tenants import TENANT_COL


@dataclasses.dataclass
class FleetResult:
    """Per-lane outputs of one batched fleet dispatch (numpy, apart from
    ``states``).

    Lane axis ``L`` = flattened (config, device); op axis is the padded
    program length.  ``tenants`` holds the width-5 tenant column;
    parity appends carry ``parity_tenant``; NOP padding moves 0 pages
    and is ignored by every rollup.
    """

    programs: np.ndarray     # (L, n_ops, 5) i32
    states: DeviceState      # stacked tensors on the engine's device,
                             #   leading axis L
    ok: np.ndarray           # (L, n_ops) bool  per-op legality
    host_delta: np.ndarray   # (L, n_ops) host pages moved by each op
    dummy_delta: np.ndarray  # (L, n_ops) dummy (FINISH-pad) pages
    erase_delta: np.ndarray  # (L, n_ops) block erasures
    pages: np.ndarray        # (L, n_ops) pages the op physically moved
                             #   (writes + FINISH padding + READ xfers)
    completions: np.ndarray  # (L, n_ops) op completion time (s)
    latencies: np.ndarray    # (L, n_ops) closed-loop op latency (s)
    makespans: np.ndarray    # (L,) lane makespan (s)
    n_tenants: int           # real tenants (parity tag excluded)
    parity_tenant: int
    elem_mask: Optional[np.ndarray] = None  # (L, n_elements) real elements
    #: per-lane telemetry stack (repro_torch.obs TelemetryState with
    #: (L, ...) fields) when the dispatch ran with obs=ObsConfig(...),
    #: else None
    telemetry: Optional[object] = None
    #: the dispatch's static config + per-lane DynConfig (when known):
    #: what lets assert_all_ok replay a failing lane through the
    #: repro_torch.check verifier and name the predicted error class
    cfg: Optional[zengine.EngineConfig] = None
    dyn: Optional[DynConfig] = None

    @property
    def tenants(self) -> np.ndarray:
        return self.programs[:, :, TENANT_COL]

    def lane_wear(self, eng: ZoneEngine) -> np.ndarray:
        """(L, n_elements) element wear (erase counts) per lane, over
        the full padded static element axis (see ``elem_mask`` /
        :meth:`pooled_wear` for the per-lane real subset)."""
        n = eng.cfg.n_elements
        return self.states.elem_wear[:, :n].cpu().numpy().astype(np.int64)

    def pooled_wear(self, eng: ZoneEngine, lanes: np.ndarray
                    ) -> np.ndarray:
        """1-D element wear pooled over ``lanes``, restricted to each
        lane's *real* elements.  A union-config lane only populates its
        member spec's cells of the padded element grid; ``elem_mask``
        (derived from the dispatch's per-lane ``DynConfig``) excludes
        the never-allocated padding so wear statistics match a device
        built with the member spec outright."""
        w = self.lane_wear(eng)[lanes]
        if self.elem_mask is None:
            return w.reshape(-1)
        return w[self.elem_mask[lanes]]

    def tenant_pages(self, lanes: np.ndarray) -> Dict[int, int]:
        """Host pages per tenant summed over ``lanes`` (parity under
        ``parity_tenant``)."""
        t = self.tenants[lanes].reshape(-1)
        h = self.host_delta[lanes].reshape(-1)
        return {int(k): int(h[t == k].sum())
                for k in range(self.n_tenants)} | {
                    self.parity_tenant:
                    int(h[t == self.parity_tenant].sum())}

    def tenant_p99_latency(self, lanes: np.ndarray) -> Dict[int, float]:
        """p99 closed-loop op latency per real tenant over ``lanes``
        (0.0 for a tenant with no executed ops there)."""
        t = self.tenants[lanes].reshape(-1)
        lat = self.latencies[lanes].reshape(-1)
        act = self.pages[lanes].reshape(-1) > 0
        out = {}
        for k in range(self.n_tenants):
            sel = act & (t == k)
            out[k] = float(np.percentile(lat[sel], 99)) if sel.any() else 0.0
        return out

    def tenant_class_report(self, lanes: Optional[np.ndarray] = None,
                            names: Optional[List[str]] = None
                            ) -> Dict[str, Dict[str, float]]:
        """Per-tenant-class latency predictability over ``lanes`` (all
        lanes by default).

        When the tenant column carries *traffic classes* (the trace
        compiler's class-tagged dispatches: wal/flush/compact,
        ckpt/log, admit/hit), this is the paper-style per-stream
        rollup: op and page counts, closed-loop latency p50/p99/max,
        and ``p99_over_p50`` -- the predictability ratio a
        well-isolated class keeps near 1.  ``names`` labels classes in
        tag order; unnamed tags keep their number."""
        lanes = (np.arange(len(self.programs)) if lanes is None
                 else np.asarray(lanes))
        t = self.tenants[lanes].reshape(-1)
        lat = self.latencies[lanes].reshape(-1)
        pages = self.pages[lanes].reshape(-1)
        host = self.host_delta[lanes].reshape(-1)
        act = (self.programs[lanes][:, :, 0].reshape(-1) != zengine.OP_NOP
               ) & self.ok[lanes].reshape(-1)
        out: Dict[str, Dict[str, float]] = {}
        for k in range(self.n_tenants):
            name = (names[k] if names is not None and k < len(names)
                    else str(k))
            sel = act & (t == k)
            if not sel.any():
                out[name] = {"ops": 0.0, "pages": 0.0, "host_pages": 0.0,
                             "mean_latency_s": 0.0, "p50_latency_s": 0.0,
                             "p99_latency_s": 0.0, "max_latency_s": 0.0,
                             "p99_over_p50": 0.0}
                continue
            l_k = lat[sel]
            p50 = float(np.percentile(l_k, 50))
            p99 = float(np.percentile(l_k, 99))
            out[name] = {
                "ops": float(sel.sum()),
                "pages": float(pages[sel].sum()),
                "host_pages": float(host[sel].sum()),
                "mean_latency_s": float(l_k.mean()),
                "p50_latency_s": p50,
                "p99_latency_s": p99,
                "max_latency_s": float(l_k.max()),
                "p99_over_p50": p99 / p50 if p50 > 0 else 0.0,
            }
        return out


def run_fleet(eng: ZoneEngine, programs: np.ndarray, *,
              dyn: Optional[DynConfig] = None, n_tenants: int = 1,
              parity_tenant: Optional[int] = None, obs=None,
              profiler=None) -> FleetResult:
    """Execute ``(L, n_ops, 5)`` fleet lanes in one batched dispatch on
    the engine's device.

    ``dyn`` (optional) must hold ``(L,)`` leaves (``engine.stack_dyn``)
    -- the heterogeneous-geometry / allocator axis.  Timing is the
    op-granular :func:`~repro_torch.core.timing.simulate_fleet_ops`
    model, on the same device: each executed op occupies its zone's LUN
    columns for ``ceil(pages / P) * (t_prog + t_xfer)`` seconds (READ
    rows at ``t_read + t_xfer``); deferred-erase latency is not modeled
    (it is tracked as ``erase_delta`` instead).

    ``obs`` (a ``repro_torch.obs.ObsConfig``) threads the telemetry
    recorder through the dispatch; the result then carries per-lane
    histogram stacks in ``telemetry``.  ``profiler`` (a
    ``repro_torch.obs.Profiler``) splits the call into ``fleet.engine``
    / ``fleet.timing`` / ``fleet.decode`` sections (the device is
    synchronised inside each section so the wall times are honest).
    """
    programs = np.asarray(programs, dtype=np.int32)
    if programs.ndim != 3 or programs.shape[-1] <= TENANT_COL:
        raise ValueError(f"want (L, n_ops, 5) programs, got "
                         f"{programs.shape}")
    if parity_tenant is None:
        parity_tenant = n_tenants
    sec = (profiler.section if profiler is not None
           else (lambda _name: contextlib.nullcontext()))
    dev = eng.device

    def sync() -> None:
        if profiler is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
    with sec("fleet.engine"):
        out = eng.run_batch(eng.init_state(), programs, dyn, obs=obs)
        states, trace = out[0], out[1]
        telemetry = out[2] if obs is not None else None
        sync()

    elem_mask = None
    if dyn is not None:
        # each lane's real elements on the (possibly union-padded)
        # static grid -- union lanes must exclude the padding cells
        # from the wear rollups
        elem_mask = union_grid_mask(eng.cfg.n_elements, eng.cfg.per_group,
                                    np.asarray(dyn.n_elements),
                                    np.asarray(dyn.per_group))

    with sec("fleet.timing"):
        wp_b = trace.wp_before.cpu().numpy()
        wp_a = trace.wp_after.cpu().numpy()
        dummy = trace.dummy_delta.cpu().numpy()
        op = programs[:, :, 0]
        # pages the op physically moved: write advance, FINISH padding
        # (RESET rewinds wp without moving pages -> clip), READ
        # transfers (the n_pages column; reads never advance wp)
        pages = (np.maximum(wp_a - wp_b, 0)
                 + np.where(op == zengine.OP_FINISH, dummy, 0)
                 + np.where(op == zengine.OP_READ, programs[:, :, 2], 0))
        # per-op page service time: reads pay t_read, everything
        # page-moving else programs flash
        t_page = np.where(
            op == zengine.OP_READ,
            np.float32(eng.flash.t_read + eng.flash.t_xfer),
            np.float32(eng.flash.t_prog + eng.flash.t_xfer))
        completions, latencies, makespans = timing.simulate_fleet_ops(
            trace.cols, torch.from_numpy(pages.astype(np.int32)).to(dev),
            torch.from_numpy(programs[:, :, TENANT_COL].copy()).to(dev),
            torch.from_numpy(t_page).to(dev), eng.flash.n_luns,
            parity_tenant + 1)
        sync()
    with sec("fleet.decode"):
        return FleetResult(
            programs=programs,
            states=states,
            ok=trace.ok.cpu().numpy(),
            host_delta=trace.host_delta.cpu().numpy(),
            dummy_delta=dummy,
            erase_delta=trace.erase_delta.cpu().numpy(),
            pages=pages,
            completions=completions.cpu().numpy(),
            latencies=latencies.cpu().numpy(),
            makespans=makespans.cpu().numpy(),
            n_tenants=n_tenants,
            parity_tenant=parity_tenant,
            elem_mask=elem_mask,
            telemetry=telemetry,
            cfg=eng.cfg,
            dyn=dyn,
        )


def config_report(res: FleetResult, eng: ZoneEngine,
                  lanes: np.ndarray) -> Dict[str, float]:
    """Roll one config's member lanes up to the paper's fleet metrics.

    * ``dlwa``: array-level -- every page the fleet programs (host data
      + parity + FINISH padding) per host data page;
    * ``wear_cv`` / ``max_wear``: spread of element wear pooled over
      all members (the wear-leveling objective, paper Fig. 7c);
    * ``p99_latency_s``: worst real tenant's p99 closed-loop latency;
    * ``makespan_s``: slowest member (the fleet completes a stripe only
      when every chunk is durable).
    """
    lanes = np.asarray(lanes)
    t = res.tenants[lanes]
    host = int(res.host_delta[lanes][t != res.parity_tenant].sum())
    par = int(res.host_delta[lanes][t == res.parity_tenant].sum())
    dummy = int(res.dummy_delta[lanes].sum())
    erases = int(res.erase_delta[lanes].sum())
    wear = res.pooled_wear(eng, lanes)
    mean_w = float(wear.mean()) if wear.size else 0.0
    p99 = res.tenant_p99_latency(lanes)
    return {
        "host_pages": float(host),
        "parity_pages": float(par),
        "dummy_pages": float(dummy),
        "dlwa": (host + par + dummy) / host if host else 1.0,
        "block_erases": float(erases),
        "max_wear": float(wear.max()) if wear.size else 0.0,
        "wear_cv": float(wear.std() / mean_w) if mean_w > 0 else 0.0,
        "p99_latency_s": max(p99.values()) if p99 else 0.0,
        "makespan_s": float(res.makespans[lanes].max()),
        "ops_ok": float(res.ok[lanes].sum()),
    }


def dispatch_cost(res: FleetResult) -> int:
    """Scanned ``(lane, op)`` cells of one dispatch -- lanes times the
    padded program length, NOP padding included.  This is the raw
    compute a batched evaluator invocation paid (every lane scans the
    full padded op axis), the unit the search-budget ledger in
    ``repro_torch.fleet.search.Evaluator`` accumulates."""
    return int(res.programs.shape[0] * res.programs.shape[1])


def real_op_count(res: FleetResult) -> int:
    """Non-NOP ops across all lanes (the work that moved state)."""
    return int((res.programs[:, :, 0] != zengine.OP_NOP).sum())


def assert_all_ok(res: FleetResult, lanes: Optional[np.ndarray] = None
                  ) -> None:
    """Raise if any *real* op (non-NOP) was illegal -- a mis-built
    fleet program (overflow, active-zone limit) should fail loudly in
    tests and benchmarks, not skew metrics silently.

    When the result carries its dispatch config (``res.cfg`` /
    ``res.dyn``, populated by :func:`run_fleet`), the first failing op
    is replayed through the :mod:`repro_torch.check` verifier and the
    exception names the op kind, zone, and predicted error class with
    the shim's message -- not just the raw row."""
    sel = slice(None) if lanes is None else lanes
    real = res.programs[sel, :, 0] != zengine.OP_NOP
    bad = real & ~res.ok[sel]
    if not bad.any():
        return
    lane, idx = np.argwhere(bad)[0]
    row = res.programs[sel][lane, idx]
    msg = (f"illegal op at lane {lane} index {idx}: {row.tolist()}")
    if res.cfg is not None:
        # absolute lane on the dispatch axis (``lanes`` may be a subset)
        abs_lane = int(np.arange(len(res.programs))[sel][lane])
        from repro_torch.check import explain_op
        stacked = (res.dyn is not None
                   and res.dyn.zone_pages.ndim > 0)
        v = explain_op(res.cfg, res.programs[abs_lane], int(idx),
                       res.dyn, lane=abs_lane if stacked else None)
        if not v.ok:
            msg = (f"illegal {v.op_name} at lane {lane} index {idx} "
                   f"(zone {v.zone}): predicted error class "
                   f"'{v.error}' -- {v.message}; row {row.tolist()}")
    raise AssertionError(msg)
