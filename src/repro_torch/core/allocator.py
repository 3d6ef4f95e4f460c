"""Vectorized zone allocator (paper §5, Eqs. 1-6), PyTorch port.

All element layouts in :mod:`repro_torch.core.elements` are *group-major
with a fixed per-group count*, so the allocator views the device as a
dense ``(n_groups, per_group)`` wear/availability matrix and the balanced
ILP solution is a masked per-row top-G selection:

    for each eligible group g: take the ``take`` lowest-wear available
    elements of row g.

:func:`select_lowest_wear` is that selection in plain tensor ops;
:func:`allocate` is the host-facing entry point, which goes through the
``zns_alloc`` kernel wrapper (the Hopper kernel on a CUDA device, its
plain version on the CPU).  The general (unbalanced) ILP is
:mod:`repro_torch.core.alloc_exact`, the test oracle of both.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.alloc_exact import ALLOCATABLE
from repro_torch.kernels.zns_alloc import ops as zns_ops

_BIG = 2**30  # sentinel wear for unavailable slots


def select_lowest_wear(wear2d: torch.Tensor, avail2d: torch.Tensor,
                       eligible: torch.Tensor, take: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked per-group lowest-wear selection.

    Args:
      wear2d:   (n_groups, per_group) int32 erase counts.
      avail2d:  (n_groups, per_group) int32 availability codes.
      eligible: (n_groups,) bool -- groups allowed to contribute (Eq. 6).
      take:     elements to take per eligible group.

    Returns:
      sel:      (n_groups, per_group) bool selection mask.
      feasible: () bool -- every eligible group had >= take available.
    """
    eligible = eligible.bool()
    allocatable = (avail2d == ALLOCATABLE[0]) | (avail2d == ALLOCATABLE[1])
    allocatable = allocatable & eligible[:, None]
    keyed = torch.where(allocatable, wear2d.to(torch.int32), _BIG)
    # rank of each slot within its row by (wear, index) -- stable
    order = torch.argsort(keyed, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    sel = (ranks < take) & allocatable
    feasible = torch.all(torch.where(eligible,
                                     allocatable.sum(dim=1) >= take, True))
    return sel, feasible


def selection_cost(wear2d: torch.Tensor, sel: torch.Tensor,
                   take: int) -> torch.Tensor:
    del take
    return torch.sum(torch.where(sel, wear2d, 0))


def eligible_mask(n_groups: int, start: int, span: int) -> np.ndarray:
    """Round-robin eligible-group window (paper Eq. 6): ``span`` adjacent
    groups starting at ``start`` (mod n_groups)."""
    idx = (start + np.arange(span)) % n_groups
    mask = np.zeros(n_groups, dtype=bool)
    mask[idx] = True
    return mask


class RoundRobin:
    """Rotates the eligible-group window between consecutive allocations so
    consecutive zones land on disjoint LUNs where possible (paper §5)."""

    def __init__(self, n_groups: int, span: int):
        if span > n_groups:
            raise ValueError(f"span {span} > n_groups {n_groups}")
        self.n_groups = n_groups
        self.span = span
        self._next = 0

    def next_window(self) -> np.ndarray:
        mask = eligible_mask(self.n_groups, self._next, self.span)
        self._next = (self._next + self.span) % self.n_groups
        return mask

    def reset(self) -> None:
        self._next = 0


def allocate(wear2d: np.ndarray, avail2d: np.ndarray, eligible: np.ndarray,
             take: int, *, device="cuda") -> Tuple[np.ndarray, bool]:
    """Host-facing allocation entry point: the ``zns_alloc`` kernel's
    Pallas contract on ``device`` (the Hopper kernel on a CUDA device).
    Returns (selection mask (n_groups, per_group), feasible)."""
    dev = resolve_device(device)
    sel, feasible = zns_ops.zns_alloc(
        torch.as_tensor(np.asarray(wear2d), dtype=torch.int32, device=dev),
        torch.as_tensor(np.asarray(avail2d), dtype=torch.int32, device=dev),
        torch.as_tensor(np.asarray(eligible, dtype=bool), device=dev),
        take=take)
    return sel.cpu().numpy(), bool(feasible)
