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
* :func:`simulate_fleet` / :func:`simulate` -- page-granular, a batch of
  devices or one.

The trace-level drivers (``run_trace``, ``run_fleet_trace``) wait for
the port of the ``IOTrace`` device shim.

Units: times in seconds, requests in flash pages (ops/luns/channels are
int32 indexes).
"""

from __future__ import annotations

from typing import Tuple

import torch

OP_WRITE, OP_READ, OP_ERASE = 0, 1, 2

F32 = torch.float32


def simulate_fleet(ops: torch.Tensor, luns: torch.Tensor,
                   channels: torch.Tensor, valid: torch.Tensor,
                   t_op: torch.Tensor, t_xfer, n_luns: int,
                   n_channels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Page-granular busy clocks for a batch of independent devices.

    Args:
      ops/luns/channels: (n_dev, n) int32, right-padded per device.
      valid:             (n_dev, n) bool, False on padding.
      t_op:              (3,) float32 [t_prog, t_read, t_erase].
      t_xfer:            () float32 channel transfer time.

    Returns:
      (completion_times (n_dev, n) with 0 on padding, makespans (n_dev,)).
    """
    dev = ops.device
    n_dev, n = ops.shape
    t_op = torch.as_tensor(t_op, dtype=F32, device=dev)
    t_xfer = torch.as_tensor(t_xfer, dtype=F32, device=dev)
    ids = torch.arange(n_dev, device=dev)
    lun_free = torch.zeros((n_dev, n_luns), dtype=F32, device=dev)
    ch_free = torch.zeros((n_dev, n_channels), dtype=F32, device=dev)
    done_all = torch.zeros((n_dev, n), dtype=F32, device=dev)
    for i in range(n):
        lun = luns[:, i].long()
        ch = channels[:, i].long()
        ok = valid[:, i]
        start = torch.maximum(lun_free[ids, lun], ch_free[ids, ch])
        done_xfer = start + t_xfer
        done = done_xfer + t_op[ops[:, i].long()]
        lun_free[ids, lun] = torch.where(ok, done, lun_free[ids, lun])
        ch_free[ids, ch] = torch.where(ok, done_xfer, ch_free[ids, ch])
        done_all[:, i] = torch.where(ok, done, 0.0)
    return done_all, lun_free.amax(1)


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
