"""FEMU-style timing model over per-resource busy clocks, PyTorch port.

ConfZNS++/FEMU advance an event-driven clock per flash channel and LUN;
the model keeps those resources and latencies but runs the request
stream as a sequential pass over per-resource *busy clocks*:

    start(req)  = max(channel_free[ch], lun_free[lun])
    channel_free[ch] = start + t_xfer
    lun_free[lun]    = start + t_xfer + t_op

Clocks are float32 and every lane's requests are applied in order, with
the same operation order as ``repro.core.timing``, so the port's
makespans match the reference's to f32 rounding.

* :func:`simulate_fleet_ops` -- whole zone ops as single requests over a
  batch of lanes (the op-granular model the paper headline prices
  execution time with);
* :func:`simulate_fleet` / :func:`run_fleet_trace` -- page-granular, a
  batch of independent devices in one pass;
* :func:`simulate` / :func:`run_trace` -- page-granular, one device: the
  model behind the paper's reported figures.

The trace drivers take the shim's :class:`~repro_torch.core.device.IOTrace`
streams and run on ``device`` (the card by default).  On the card the
page-granular model is one launch of the hand-written ``page_clock``
kernel (:mod:`repro_torch.kernels.page_clock`: a CTA per device steps its
requests in order, bit for bit the reference's scan); on the CPU it is
that kernel's plain version, a Python loop of a few tensor ops a page,
which is what the CPU tests run.

Units: times in seconds, requests in flash pages (ops/luns/channels are
int32 indexes).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.device import IOTrace
from repro_torch.core.geometry import FlashGeometry
from repro_torch.kernels.page_clock import ops as page_clock

OP_WRITE, OP_READ, OP_ERASE = 0, 1, 2
_OP_CODE = {"write": OP_WRITE, "read": OP_READ, "erase": OP_ERASE}

F32 = torch.float32


def simulate_fleet(ops: torch.Tensor, luns: torch.Tensor,
                   channels: torch.Tensor, valid: torch.Tensor,
                   t_op: torch.Tensor, t_xfer, n_luns: int,
                   n_channels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Page-granular busy clocks for a batch of independent devices.

    The ``page_clock`` kernel on CUDA tensors (one launch, one CTA a
    device), its plain version
    (:func:`repro_torch.kernels.page_clock.ref.simulate_fleet_ref`) on
    CPU tensors; both equal the reference's scan bit for bit.

    Args:
      ops/luns/channels: (n_dev, n) int32, right-padded per device.
      valid:             (n_dev, n) bool, False on padding.
      t_op:              (3,) float32 [t_prog, t_read, t_erase].
      t_xfer:            () float32 channel transfer time.

    Returns:
      (completion_times (n_dev, n) with 0 on padding, makespans (n_dev,)).
    """
    return page_clock.simulate_fleet(ops, luns, channels, valid, t_op,
                                     t_xfer, n_luns, n_channels,
                                     impl="kernel")


def simulate(ops: torch.Tensor, luns: torch.Tensor, channels: torch.Tensor,
             t_op: torch.Tensor, t_xfer, n_luns: int, n_channels: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One device's request stream: ``(completion_times (n,),
    makespan ())``."""
    valid = torch.ones((1,) + ops.shape, dtype=torch.bool,
                       device=ops.device)
    done, makespan = simulate_fleet(ops[None], luns[None], channels[None],
                                    valid, t_op, t_xfer, n_luns,
                                    n_channels)
    return done[0], makespan[0]


def simulate_fleet_ops(cols: torch.Tensor, pages: torch.Tensor,
                       tenants: torch.Tensor, t_page, n_luns: int,
                       n_tenants: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Op-granular fleet timing: whole zone ops over a batch of lanes.

    Each executed op occupies all of its zone's LUN columns for
    ``ceil(pages / P) * t_page`` seconds (the round-robin stripe programs
    ``ceil(pages/P)`` pages per column back to back).  Tenant latency is
    closed-loop: a tenant issues its next op when its previous op
    completes, so ``latency = completion - previous completion of the
    same tenant``.

    Args:
      cols:    (n_lanes, n_ops, P) int32 zone column -> LUN of each op
               (from ``OpTrace.cols``).
      pages:   (n_lanes, n_ops) int32 pages the op moved (0 = skip).
      tenants: (n_lanes, n_ops) int32 tenant tag in ``[0, n_tenants)``.
      t_page:  () f32 seconds per page program+transfer, or
               (n_lanes, n_ops) f32 per-op page cost.

    Returns:
      (completions (n_lanes, n_ops) f32 with 0 on skipped ops,
       latencies (n_lanes, n_ops) f32, makespans (n_lanes,) f32).
    """
    dev = cols.device
    n_lanes, n_ops, P = cols.shape
    t_page = torch.as_tensor(t_page, dtype=F32, device=dev).expand(
        pages.shape)
    ids = torch.arange(n_lanes, device=dev)
    lun_free = torch.zeros((n_lanes, n_luns), dtype=F32, device=dev)
    ten_done = torch.zeros((n_lanes, n_tenants), dtype=F32, device=dev)
    done_all = torch.zeros((n_lanes, n_ops), dtype=F32, device=dev)
    lat_all = torch.zeros((n_lanes, n_ops), dtype=F32, device=dev)
    for i in range(n_ops):
        c = cols[:, i].long()
        pg = pages[:, i]
        t = tenants[:, i].long()
        active = pg > 0
        dur = torch.ceil(pg.to(F32) / P) * t_page[:, i]
        # an op starts when its LUN columns free up AND its tenant has
        # completed its previous op (closed-loop issue)
        busy = torch.gather(lun_free, 1, c)
        prev = ten_done[ids, t]
        start = torch.maximum(
            torch.where(active[:, None], busy, 0.0).amax(1), prev)
        done = start + dur
        lat_all[:, i] = torch.where(active, done - prev, 0.0)
        lun_free = lun_free.scatter(
            1, c, torch.where(active[:, None], done[:, None], busy))
        ten_done[ids, t] = torch.where(active, done, prev)
        done_all[:, i] = torch.where(active, done, 0.0)
    return done_all, lat_all, lun_free.amax(1)


def _t_op(flash: FlashGeometry, dev: torch.device) -> torch.Tensor:
    return torch.tensor([flash.t_prog, flash.t_read, flash.t_erase],
                        dtype=F32, device=dev)


def _i32(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def run_fleet_trace(flash: FlashGeometry,
                    device_traces: Sequence[Sequence[IOTrace]],
                    *, interleave: bool = True, device="cuda") -> dict:
    """Simulate per-device trace bundles in one batched pass.

    ``device_traces[i]`` holds device ``i``'s concurrent streams (host
    data chunks, parity appends routed to it, FINISH padding); each
    device's streams are merged round-robin exactly as :func:`run_trace`
    would, then all devices advance together under
    :func:`simulate_fleet`.

    Returns per-device makespans/throughputs plus the fleet makespan
    (the slowest member -- the array completes a stripe only when every
    chunk, parity included, is durable).
    """
    n_dev = len(device_traces)
    if n_dev == 0:
        return {"fleet_makespan_s": 0.0, "n": 0}
    dev = resolve_device(device)
    merged = []
    for trs in device_traces:
        trs = [t for t in trs if len(t.luns)]
        if trs:
            ops, luns, chans, _ = _merge(trs, interleave)
        else:
            ops = luns = chans = np.zeros(0, dtype=np.int32)
        merged.append((ops, luns, chans))
    n_max = max(1, max(len(m[0]) for m in merged))

    def pad(a: np.ndarray) -> np.ndarray:
        out = np.zeros(n_max, dtype=np.int32)
        out[: len(a)] = a
        return out

    ops = np.stack([pad(m[0]) for m in merged])
    luns = np.stack([pad(m[1]) for m in merged])
    chans = np.stack([pad(m[2]) for m in merged])
    valid = np.stack([np.arange(n_max) < len(m[0]) for m in merged])
    _, makespans = simulate_fleet(
        _i32(ops, dev), _i32(luns, dev), _i32(chans, dev),
        torch.from_numpy(valid).to(dev), _t_op(flash, dev),
        torch.tensor(flash.t_xfer, dtype=F32, device=dev),
        flash.n_luns, flash.n_channels)
    makespans = makespans.cpu().numpy()
    counts = valid.sum(axis=1)
    out = {"fleet_makespan_s": float(makespans.max()),
           "n": int(counts.sum())}
    for i in range(n_dev):
        t = float(makespans[i])
        out[f"dev{i}_makespan_s"] = t
        out[f"dev{i}_n"] = int(counts[i])
        out[f"dev{i}_throughput_pages_s"] = float(counts[i] / t) if t else 0.0
    return out


def group_tagged(tagged: Sequence[Tuple[int, IOTrace]], n_devices: int
                 ) -> list:
    """Split ``(device, trace)`` pairs (as emitted by ``ZNSArray`` trace
    mode) into the per-device bundles ``run_fleet_trace`` consumes."""
    out: list = [[] for _ in range(n_devices)]
    for idx, tr in tagged:
        out[idx].append(tr)
    return out


def run_trace(flash: FlashGeometry, traces: Sequence[IOTrace],
              *, interleave: bool = True, device="cuda") -> dict:
    """Simulate one or more IOTraces; returns timing stats.

    ``interleave=True`` merges the traces round-robin (concurrent queues);
    ``False`` concatenates them (sequential submission).
    """
    if not traces:
        return {"makespan_s": 0.0, "n": 0, "throughput_pages_s": 0.0}
    dev = resolve_device(device)
    ops, luns, chans, owner = _merge(traces, interleave)
    completions, makespan = simulate(
        _i32(ops, dev), _i32(luns, dev), _i32(chans, dev),
        _t_op(flash, dev), torch.tensor(flash.t_xfer, dtype=F32, device=dev),
        flash.n_luns, flash.n_channels)
    completions = completions.cpu().numpy()
    makespan = float(makespan)
    out = {"makespan_s": makespan, "n": int(len(ops)),
           "throughput_pages_s": len(ops) / makespan if makespan else 0.0}
    # per-owner completion (owner 0 = first trace = usually the host)
    for i in range(len(traces)):
        sel = owner == i
        if sel.any():
            t = float(completions[sel].max())
            out[f"owner{i}_makespan_s"] = t
            out[f"owner{i}_throughput_pages_s"] = int(sel.sum()) / t if t else 0.0
    return out


def _merge(traces: Sequence[IOTrace], interleave: bool
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    ops_l, luns_l, chans_l, owner_l = [], [], [], []
    for i, tr in enumerate(traces):
        n = len(tr.luns)
        ops_l.append(np.full(n, _OP_CODE[tr.op], dtype=np.int32))
        luns_l.append(np.asarray(tr.luns, dtype=np.int32))
        chans_l.append(np.asarray(tr.channels, dtype=np.int32))
        owner_l.append(np.full(n, i, dtype=np.int32))
    if not interleave or len(traces) == 1:
        return (np.concatenate(ops_l), np.concatenate(luns_l),
                np.concatenate(chans_l), np.concatenate(owner_l))
    # round-robin merge by per-stream position (models concurrent queues)
    order_keys = np.concatenate(
        [np.arange(len(t.luns), dtype=np.int64) * len(traces) + i
         for i, t in enumerate(traces)])
    perm = np.argsort(order_keys, kind="stable")
    return (np.concatenate(ops_l)[perm], np.concatenate(luns_l)[perm],
            np.concatenate(chans_l)[perm], np.concatenate(owner_l)[perm])


def write_bandwidth_mib_s(flash: FlashGeometry, stats: dict,
                          owner: Optional[int] = None) -> float:
    key = ("throughput_pages_s" if owner is None
           else f"owner{owner}_throughput_pages_s")
    return stats.get(key, 0.0) * flash.page_bytes / (1024 * 1024)
