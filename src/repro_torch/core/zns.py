"""Write-order striping math (paper §3 Fig. 3b, §4), PyTorch port.

A zone spans P LUN *columns* and ``n_segments`` stacked *segments*; pages
are striped round-robin across the P columns of the current segment, and a
segment is fully written before the write pointer advances to the next
(paper Fig. 3b).  These closed forms convert a zone write pointer ``wp``
(pages written so far) into per-block / per-element page counts -- the
quantity FINISH needs to decide dummy padding -- and into per-page LUN
streams for the timing model.  The numpy closed forms are copied
unchanged; the ``*_t`` forms take int32 tensors batched over a leading
lane axis (the engine's).

Element-slot ordering convention (used by the device mapping table):

* BLOCK       slot = seg * P + col
* VCHUNK(s)   slot = seg * (P//s) + col//s
* HCHUNK(s)   slot = (seg//s) * P + col
* SUPERBLOCK  slot = seg
* FIXED       slot = 0
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.elements import ElementKind, ElementSpec


def pages_per_block(wp: int, parallelism: int, n_segments: int,
                    pages_per_blk: int) -> np.ndarray:
    """Pages written in each (segment, column) erase block at pointer wp.

    Returns int64 array of shape (n_segments, parallelism).
    """
    P = parallelism
    seg_pages = P * pages_per_blk
    seg = np.arange(n_segments, dtype=np.int64)
    w_seg = np.clip(wp - seg * seg_pages, 0, seg_pages)  # pages in each seg
    col = np.arange(P, dtype=np.int64)
    # pages in column c of a segment with w pages striped round-robin:
    # ceil((w - c) / P) clipped to [0, pages_per_blk]
    cnt = (w_seg[:, None] - col[None, :] + P - 1) // P
    return np.clip(cnt, 0, pages_per_blk)


def element_pages(wp: int, spec: ElementSpec, parallelism: int,
                  n_segments: int, pages_per_blk: int) -> np.ndarray:
    """Pages written per element *slot* (see module docstring ordering)."""
    blk = pages_per_block(wp, parallelism, n_segments, pages_per_blk)
    P = parallelism
    if spec.kind is ElementKind.BLOCK:
        return blk.reshape(-1)
    if spec.kind is ElementKind.VCHUNK:
        s = spec.chunk
        return blk.reshape(n_segments, P // s, s).sum(axis=2).reshape(-1)
    if spec.kind is ElementKind.SUPERBLOCK:
        return blk.sum(axis=1)
    if spec.kind is ElementKind.HCHUNK:
        s = spec.chunk
        if n_segments % s:
            raise ValueError("hchunk span must divide n_segments")
        return blk.reshape(n_segments // s, s, P).sum(axis=1).reshape(-1)
    if spec.kind is ElementKind.FIXED:
        return np.asarray([blk.sum()], dtype=np.int64)
    raise ValueError(spec.kind)


def pages_per_block_t(wp, parallelism: int, n_segments: int,
                      pages_per_blk: int) -> torch.Tensor:
    """:func:`pages_per_block` on an int32 tensor ``wp`` of any shape
    ``(...,)`` (one pointer per lane).  Returns int32
    ``(..., n_segments, P)`` on ``wp``'s device."""
    P = parallelism
    seg_pages = P * pages_per_blk
    seg = torch.arange(n_segments, dtype=torch.int32, device=wp.device)
    w_seg = torch.clamp(wp[..., None] - seg * seg_pages, 0, seg_pages)
    col = torch.arange(P, dtype=torch.int32, device=wp.device)
    cnt = torch.div(w_seg[..., :, None] - col + (P - 1), P,
                    rounding_mode="floor")
    return torch.clamp(cnt, 0, pages_per_blk).to(torch.int32)


def element_pages_t(wp, spec: ElementSpec, parallelism: int,
                    n_segments: int, pages_per_blk: int) -> torch.Tensor:
    """:func:`element_pages` on an int32 tensor ``wp`` of shape
    ``(...,)``; returns int32 ``(..., n_slots)``."""
    blk = pages_per_block_t(wp, parallelism, n_segments, pages_per_blk)
    lead = blk.shape[:-2]
    P = parallelism
    if spec.kind is ElementKind.BLOCK:
        out = blk.reshape(*lead, -1)
    elif spec.kind is ElementKind.VCHUNK:
        s = spec.chunk
        out = blk.reshape(*lead, n_segments, P // s, s).sum(-1).reshape(
            *lead, -1)
    elif spec.kind is ElementKind.SUPERBLOCK:
        out = blk.sum(-1)
    elif spec.kind is ElementKind.HCHUNK:
        s = spec.chunk
        if n_segments % s:
            raise ValueError("hchunk span must divide n_segments")
        out = blk.reshape(*lead, n_segments // s, s, P).sum(-2).reshape(
            *lead, -1)
    elif spec.kind is ElementKind.FIXED:
        out = blk.sum((-2, -1)).reshape(*lead, 1)
    else:
        raise ValueError(spec.kind)
    return out.to(torch.int32)


def slot_map_t(slot_stride, luns_per_group, seg_span, parallelism: int,
               n_segments: int) -> torch.Tensor:
    """(..., n_segments, P) element-slot id owning each (segment, column)
    erase-block cell, from *value-level* spec parameters (int32 tensors
    of one shape ``(...,)``, one value per lane)::

        slot = (segment // seg_span) * slot_stride + column // luns_per_group

    with ``seg_span = pages_per_element / (luns_per_group *
    pages_per_block)`` (segments an element spans vertically).  This is
    how the engine keeps the element spec a per-lane *value*; the map
    reproduces the per-kind closed forms of :func:`element_pages`:

    =============  ===========  ==============  ========
    kind           slot_stride  luns_per_group  seg_span
    =============  ===========  ==============  ========
    BLOCK          P            1               1
    VCHUNK(s)      P // s       s               1
    SUPERBLOCK     1            P               1
    HCHUNK(s)      P            1               s
    FIXED          1            P               n_segments
    =============  ===========  ==============  ========
    """
    dev = slot_stride.device
    seg = torch.arange(n_segments, dtype=torch.int32, device=dev)[:, None]
    col = torch.arange(parallelism, dtype=torch.int32, device=dev)[None, :]
    e = (..., None, None)
    return (torch.div(seg, seg_span[e], rounding_mode="floor")
            * slot_stride[e]
            + torch.div(col, luns_per_group[e], rounding_mode="floor")
            ).to(torch.int32)


def n_slots(spec: ElementSpec, parallelism: int, n_segments: int) -> int:
    if spec.kind is ElementKind.BLOCK:
        return n_segments * parallelism
    if spec.kind is ElementKind.VCHUNK:
        return n_segments * (parallelism // spec.chunk)
    if spec.kind is ElementKind.SUPERBLOCK:
        return n_segments
    if spec.kind is ElementKind.HCHUNK:
        return (n_segments // spec.chunk) * parallelism
    if spec.kind is ElementKind.FIXED:
        return 1
    raise ValueError(spec.kind)


def slot_of_group_rank(spec: ElementSpec, parallelism: int, n_segments: int,
                       col_or_band: int, rank: int) -> int:
    """Map (which column/band within the zone, rank-th element taken from
    that group) -> element slot.  Rank runs over the ``take`` elements a
    group contributes, assigned to segments bottom-up."""
    P = parallelism
    if spec.kind is ElementKind.BLOCK:
        return rank * P + col_or_band          # seg=rank, col
    if spec.kind is ElementKind.VCHUNK:
        return rank * (P // spec.chunk) + col_or_band
    if spec.kind is ElementKind.SUPERBLOCK:
        return rank                             # seg=rank
    if spec.kind is ElementKind.HCHUNK:
        return rank * P + col_or_band           # seggrp=rank, col
    if spec.kind is ElementKind.FIXED:
        return 0
    raise ValueError(spec.kind)


def page_stream(wp_start: int, n_pages: int, parallelism: int,
                pages_per_blk: int, column_luns: np.ndarray,
                n_channels: int) -> tuple[np.ndarray, np.ndarray]:
    """(lun, channel) per page for a striped write of ``n_pages`` starting
    at zone pointer ``wp_start``.  ``column_luns`` maps zone column -> LUN.
    """
    p = wp_start + np.arange(n_pages, dtype=np.int64)
    seg_pages = parallelism * pages_per_blk
    col = (p % seg_pages) % parallelism
    luns = np.asarray(column_luns, dtype=np.int64)[col]
    return luns, luns % n_channels


def page_slots(pages: np.ndarray, spec: ElementSpec, parallelism: int,
               pages_per_blk: int) -> np.ndarray:
    """Element slot owning each page (vectorized page -> slot map)."""
    p = np.asarray(pages, dtype=np.int64)
    P = parallelism
    seg_pages = P * pages_per_blk
    seg = p // seg_pages
    col = (p % seg_pages) % P
    if spec.kind is ElementKind.BLOCK:
        return seg * P + col
    if spec.kind is ElementKind.VCHUNK:
        return seg * (P // spec.chunk) + col // spec.chunk
    if spec.kind is ElementKind.SUPERBLOCK:
        return seg
    if spec.kind is ElementKind.HCHUNK:
        return (seg // spec.chunk) * P + col
    if spec.kind is ElementKind.FIXED:
        return np.zeros_like(p)
    raise ValueError(spec.kind)


def pad_stream(wp: int, zone_pages: int, spec: ElementSpec,
               parallelism: int, pages_per_blk: int,
               column_luns: np.ndarray, padded_slots: np.ndarray,
               n_channels: int) -> tuple[np.ndarray, np.ndarray]:
    """(lun, channel) streams for FINISH dummy padding.

    Padding continues the zone's striped write order from ``wp`` to the end
    of the zone, restricted to pages belonging to ``padded_slots`` (the
    partially-written elements) -- released elements receive no writes.
    """
    pages = np.arange(wp, zone_pages, dtype=np.int64)
    slots = page_slots(pages, spec, parallelism, pages_per_blk)
    keep = np.isin(slots, padded_slots)
    pages = pages[keep]
    seg_pages = parallelism * pages_per_blk
    col = (pages % seg_pages) % parallelism
    luns = np.asarray(column_luns, dtype=np.int64)[col]
    return luns, luns % n_channels


def read_stream(pages: np.ndarray, parallelism: int, pages_per_blk: int,
                column_luns: np.ndarray, n_channels: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """(lun, channel) for arbitrary page reads within a zone."""
    p = np.asarray(pages, dtype=np.int64)
    seg_pages = parallelism * pages_per_blk
    col = (p % seg_pages) % parallelism
    luns = np.asarray(column_luns, dtype=np.int64)[col]
    return luns, luns % n_channels
