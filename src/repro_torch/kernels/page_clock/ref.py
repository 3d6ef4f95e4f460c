"""Plain PyTorch version of the page-granular busy-clock model: the
reference's ``simulate_fleet`` (``repro.core.timing``) as a Python loop
over requests, a few tensor ops a request, on any device.  It is the CPU
path of :func:`repro_torch.kernels.page_clock.ops.simulate_fleet` and what
the card's kernel is held to, bit for bit."""

from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32


def simulate_fleet_ref(ops: torch.Tensor, luns: torch.Tensor,
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
