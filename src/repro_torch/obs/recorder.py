"""Telemetry accumulator carried through the op-program loop (the port of
``repro.obs.recorder``).

The engine's ``run_program(s)`` already emits a per-op :class:`OpTrace`;
what it cannot answer cheaply is "*when* did the superfluous writes /
wear / occupancy happen" for long programs without hauling the whole
trace to the host and re-aggregating.  :class:`TelemetryState` is a
fixed-size tuple of time-bucketed histograms updated after every op
step: op ``i`` of an ``n_ops``-row program lands in bucket
``i * n_buckets // n_ops``, so the telemetry shape is independent of
program length and rides the lane axis of ``run_programs`` (one
``(L, n_buckets, ...)`` stack per fleet dispatch).

The engine steps ops in a host loop, every lane at once, so op ``i``'s
bucket is a host integer shared by every lane: each update is a slice
add or a slice max on ``(L, B)`` / ``(L, B, T)`` tensors on the engine's
device (the tenant histograms add into their ``(L, T)`` slice along the
lane's tenant column).

Opt-in and effect-free: ``run_program(s)`` take an optional
:class:`ObsConfig`; without it nothing changes, with it the return gains
a third element.  The recorder only *reads* the device state --
telemetry-on and telemetry-off runs produce bit-identical
``DeviceState`` / ``OpTrace`` (``tests/test_torch_obs.py``).

Decoding is host-side and pandas-free: plain dicts of Python lists
(JSON-ready), per lane (:func:`lane_timeline`), per fleet lane stack
(:func:`fleet_timelines`), per tenant (:func:`tenant_timelines`), per
zone (:func:`zone_timelines`, rebuilt from the materialized ``OpTrace``
because per-zone histograms would scale with ``n_zones``), and pooled
per device (:func:`device_rollup`).

Units: page counters count flash pages; ``wear_max`` counts erase-block
erasures; buckets index program progress (op order), not wall time --
the op program *is* the device's request clock.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device

#: column a width-5 fleet op row stores its tenant tag in (kept in sync
#: with repro_torch.fleet.tenants.TENANT_COL; obs depends only on core)
_TENANT_COL = 4

#: opcodes (mirrors repro_torch.core.engine, which imports this module
#: lazily)
_OP_NOP = 0

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Static (hashable) recorder configuration.

    ``n_buckets`` fixes the telemetry resolution (histogram length);
    ``n_tenants`` sizes the per-tenant axes -- pass the number of
    tenant *classes* including the parity tag (``N_TENANTS + 1`` for a
    fleet batch; tags outside ``[0, n_tenants)`` clip into the last
    class).  Width-4 programs have no tenant column and bin everything
    into class 0.
    """

    n_buckets: int = 32
    n_tenants: int = 1

    def __post_init__(self) -> None:
        if self.n_buckets < 1 or self.n_tenants < 1:
            raise ValueError(
                f"n_buckets and n_tenants must be >= 1, got "
                f"{self.n_buckets}, {self.n_tenants}")


class TelemetryState(NamedTuple):
    """Time-bucketed per-lane histograms (all int32, ``B = n_buckets``,
    ``T = n_tenants``; a batched state has a leading lane axis on every
    field).  Sums unless marked gauge."""

    step: torch.Tensor         # () op index within the program
    host: torch.Tensor         # (B,) host pages written
    dummy: torch.Tensor        # (B,) superfluous (FINISH-pad / dummy) pages
    erases: torch.Tensor       # (B,) block erasures
    allocs: torch.Tensor       # (B,) allocator invocations
    ok_ops: torch.Tensor       # (B,) legal executed (non-NOP) ops
    illegal_ops: torch.Tensor  # (B,) illegal (rejected) ops
    active_max: torch.Tensor   # (B,) gauge: max open zones in the bucket
    wear_max: torch.Tensor     # (B,) gauge: max wear among touched elements
    tenant_host: torch.Tensor   # (B, T) host pages per tenant class
    tenant_dummy: torch.Tensor  # (B, T) dummy pages per tenant class


def telemetry_init(obs: ObsConfig, n_lanes: int, device="cuda"
                   ) -> TelemetryState:
    """Zeroed accumulator for a stack of ``n_lanes`` programs on
    ``device``."""
    dev = resolve_device(device)
    b, t = obs.n_buckets, obs.n_tenants

    def z(*shape):
        return torch.zeros((n_lanes,) + shape, dtype=_I32, device=dev)
    return TelemetryState(
        step=z(), host=z(b), dummy=z(b), erases=z(b), allocs=z(b),
        ok_ops=z(b), illegal_ops=z(b), active_max=z(b), wear_max=z(b),
        tenant_host=z(b, t), tenant_dummy=z(b, t))


def telemetry_update(obs: ObsConfig, tel: TelemetryState, before, after,
                     trace, row: torch.Tensor, n_ops: int, step: int
                     ) -> TelemetryState:
    """Fold op ``step`` of every lane into a batched accumulator, in
    place, and return it.

    ``before`` / ``after`` are the lane-stacked :class:`DeviceState`
    around the op, ``trace`` its :class:`OpTrace` (``(L, ...)``
    fields), ``row`` the ``(L, width)`` op rows (tenant tag read from
    column 4 when present).  NOP padding is excluded from the
    op-legality counters but its (zero) page deltas are folded anyway.
    """
    b = min(step * obs.n_buckets // n_ops, obs.n_buckets - 1)
    real = row[:, 0] != _OP_NOP
    ok_i = (real & trace.ok).to(_I32)
    bad_i = real.to(_I32) - ok_i
    # max wear among the elements the op's zone maps after the op: a
    # gather of n_slots per lane that tracks the wear frontier without
    # an O(n_elements) reduction per op
    elems = trace.elems
    valid = elems >= 0
    wear = torch.gather(after.elem_wear, 1,
                        torch.where(valid, elems, 0).long())
    wear_touched = torch.where(valid, wear, 0).amax(1).to(_I32)
    if row.shape[1] > _TENANT_COL:
        tenant = torch.clamp(row[:, _TENANT_COL], 0, obs.n_tenants - 1)
    else:
        tenant = torch.zeros_like(row[:, 0])
    tenant = tenant.long()[:, None]
    tel.step.add_(1)
    tel.host[:, b].add_(trace.host_delta)
    tel.dummy[:, b].add_(trace.dummy_delta)
    tel.erases[:, b].add_(trace.erase_delta)
    tel.allocs[:, b].add_(after.alloc_calls - before.alloc_calls)
    tel.ok_ops[:, b].add_(ok_i)
    tel.illegal_ops[:, b].add_(bad_i)
    active = tel.active_max[:, b]
    torch.maximum(active, after.n_active, out=active)
    wear_max = tel.wear_max[:, b]
    torch.maximum(wear_max, wear_touched, out=wear_max)
    tel.tenant_host[:, b].scatter_add_(1, tenant,
                                       trace.host_delta[:, None])
    tel.tenant_dummy[:, b].scatter_add_(1, tenant,
                                        trace.dummy_delta[:, None])
    return tel


# --------------------------------------------------------------------- #
# host-side decoding (plain dicts of lists, JSON-ready)
# --------------------------------------------------------------------- #
_SUM_KEYS = ("host", "dummy", "erases", "allocs", "ok_ops",
             "illegal_ops")
_GAUGE_KEYS = ("active_max", "wear_max")


def _np(tel: TelemetryState) -> Dict[str, np.ndarray]:
    return {k: np.asarray(getattr(tel, k).cpu())
            for k in _SUM_KEYS + _GAUGE_KEYS
            + ("tenant_host", "tenant_dummy")}


def lane_timeline(obs: ObsConfig, tel: TelemetryState,
                  lane: Optional[int] = None) -> Dict[str, list]:
    """One lane's histograms as a timeline dict.

    ``lane`` selects a row of a batched (``run_programs``) telemetry
    stack; ``None`` decodes an unbatched (``run_program``) one.  Adds
    ``dlwa``: the *cumulative* device-level write amplification up to
    each bucket boundary -- (host + dummy) pages per host page, the
    paper's DLWA as a function of program progress (1.0 before any host
    page lands).
    """
    arrs = _np(tel)
    if lane is not None:
        arrs = {k: v[lane] for k, v in arrs.items()}
    if arrs["host"].ndim != 1:
        raise ValueError("batched telemetry needs an explicit lane "
                         "(leaves have a leading lane axis)")
    out: Dict[str, list] = {k: arrs[k].astype(np.int64).tolist()
                            for k in _SUM_KEYS + _GAUGE_KEYS}
    ch = np.cumsum(arrs["host"].astype(np.int64))
    cd = np.cumsum(arrs["dummy"].astype(np.int64))
    out["dlwa"] = [float((h + d) / h) if h else 1.0
                   for h, d in zip(ch, cd)]
    out["tenant_host"] = arrs["tenant_host"].astype(np.int64).tolist()
    out["tenant_dummy"] = arrs["tenant_dummy"].astype(np.int64).tolist()
    out["n_buckets"] = int(obs.n_buckets)
    out["n_tenants"] = int(obs.n_tenants)
    return out


def fleet_timelines(obs: ObsConfig, tel: TelemetryState
                    ) -> List[Dict[str, list]]:
    """Per-lane timelines of a batched telemetry stack (lane order is
    the dispatch's lane order: config-major, device-minor for a
    ``build_fleet_batch`` batch)."""
    n_lanes = int(tel.host.shape[0])
    return [lane_timeline(obs, tel, lane) for lane in range(n_lanes)]


def tenant_timelines(obs: ObsConfig, tel: TelemetryState
                     ) -> Dict[int, Dict[str, list]]:
    """Per-tenant-class host/dummy page timelines pooled over all lanes
    of a batched telemetry stack (class ``n_tenants - 1`` also absorbs
    clipped out-of-range tags, e.g. the parity tag when the recorder
    was sized without it)."""
    th = np.asarray(tel.tenant_host.cpu(), dtype=np.int64)
    td = np.asarray(tel.tenant_dummy.cpu(), dtype=np.int64)
    if th.ndim == 3:                      # (L, B, T) -> (B, T)
        th, td = th.sum(axis=0), td.sum(axis=0)
    out = {}
    for t in range(obs.n_tenants):
        out[t] = {"host": th[:, t].tolist(), "dummy": td[:, t].tolist()}
    return out


def device_rollup(timelines: List[Dict[str, list]]) -> Dict[str, list]:
    """Pool per-lane timelines into one device/fleet-level timeline
    (sums summed, gauges maxed, DLWA recomputed from the pooled
    cumulative sums)."""
    if not timelines:
        return {}
    n = len(timelines[0]["host"])
    out: Dict[str, list] = {}
    for k in _SUM_KEYS:
        out[k] = [sum(tl[k][i] for tl in timelines) for i in range(n)]
    for k in _GAUGE_KEYS:
        out[k] = [max(tl[k][i] for tl in timelines) for i in range(n)]
    ch = np.cumsum(out["host"])
    cd = np.cumsum(out["dummy"])
    out["dlwa"] = [float((h + d) / h) if h else 1.0
                   for h, d in zip(ch, cd)]
    out["n_buckets"] = n
    return out


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def zone_timelines(program, trace, n_buckets: int
                   ) -> Dict[int, Dict[str, list]]:
    """Per-zone timelines rebuilt host-side from one lane's materialized
    :class:`OpTrace` (per-zone histograms would cost ``O(n_zones)``
    tensors per lane; the trace already holds the per-op zone, so
    post-hoc binning is free).

    Returns ``{zone: {host, dummy, erases, wp}}`` for every zone the
    program touched; ``wp`` is a gauge (the zone's write pointer after
    the bucket's last op on it, carried forward across empty buckets).
    """
    program = _host(program)
    n_ops = len(program)
    zone = _host(trace.zone)
    host = _host(trace.host_delta).astype(np.int64)
    dummy = _host(trace.dummy_delta).astype(np.int64)
    erases = _host(trace.erase_delta).astype(np.int64)
    wp = _host(trace.wp_after).astype(np.int64)
    out: Dict[int, Dict[str, list]] = {}
    for i in range(n_ops):
        if program[i, 0] == _OP_NOP:
            continue
        z = int(zone[i])
        b = min(i * n_buckets // n_ops, n_buckets - 1)
        tl = out.setdefault(z, {
            "host": [0] * n_buckets, "dummy": [0] * n_buckets,
            "erases": [0] * n_buckets, "wp": [-1] * n_buckets})
        tl["host"][b] += int(host[i])
        tl["dummy"][b] += int(dummy[i])
        tl["erases"][b] += int(erases[i])
        tl["wp"][b] = int(wp[i])
    for tl in out.values():               # carry wp across empty buckets
        last = 0
        for b in range(n_buckets):
            if tl["wp"][b] < 0:
                tl["wp"][b] = last
            last = tl["wp"][b]
    return out
