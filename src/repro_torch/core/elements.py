"""Storage elements: the zone-allocation granularity axis (paper §4, Table 1).

A *storage element* is the smallest unit that is FINISHed and RESET as a
whole.  The paper's five element kinds, over a device of L LUNs with B
erase blocks each:

=============  =====================================  ==================
kind           definition                             #elements
=============  =====================================  ==================
BLOCK          one erase block                        L * B
HCHUNK(s)      s consecutive blocks within one LUN    L * B / s
VCHUNK(s)      s blocks, same offset, s adjacent LUNs (L/s) * B
SUPERBLOCK     VCHUNK(L): one block per LUN           B
FIXED          the entire (static) physical zone      n_zones
=============  =====================================  ==================

Element ids are dense in ``[0, n_elements)``.  Every element knows its
*column group* (which LUN-columns it occupies) so the allocator can enforce
the paper's zone-parallelism constraints (Eqs. 3-6), and its *blocks* so
the device can account wear and dummy-pad writes per erase block.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np

from repro_torch.core.geometry import FlashGeometry, ZoneGeometry


class ElementKind(enum.Enum):
    BLOCK = "block"
    HCHUNK = "hchunk"
    VCHUNK = "vchunk"
    SUPERBLOCK = "superblock"
    FIXED = "fixed"  # ConfZNS++ baseline: static physical zones


@dataclasses.dataclass(frozen=True)
class ElementSpec:
    kind: ElementKind
    chunk: int = 1  # s for HCHUNK/VCHUNK; ignored otherwise

    @property
    def name(self) -> str:
        if self.kind in (ElementKind.HCHUNK, ElementKind.VCHUNK):
            return f"{self.kind.value}{self.chunk}"
        return self.kind.value


BLOCK = ElementSpec(ElementKind.BLOCK)
SUPERBLOCK = ElementSpec(ElementKind.SUPERBLOCK)
FIXED = ElementSpec(ElementKind.FIXED)


def hchunk(s: int) -> ElementSpec:
    return ElementSpec(ElementKind.HCHUNK, s)


def vchunk(s: int) -> ElementSpec:
    return ElementSpec(ElementKind.VCHUNK, s)


#: Paper §6.1 "Zone Storage Elements": fixed, superblock, block, Vchunk-2,
#: Vchunk-4, Hchunk-2.
PAPER_ELEMENTS: Tuple[ElementSpec, ...] = (
    FIXED,
    SUPERBLOCK,
    BLOCK,
    vchunk(2),
    vchunk(4),
    hchunk(2),
)


@dataclasses.dataclass(frozen=True)
class ElementLayout:
    """Dense description of all storage elements of one kind on a device.

    Arrays (all length ``n_elements`` unless noted):

    * ``group``       -- the element's LUN-group index in ``[0, n_groups)``.
      For BLOCK/HCHUNK a group is a single LUN; for VCHUNK(s) a group is a
      band of s adjacent LUNs; for SUPERBLOCK there is one group (all LUNs).
    * ``blocks``      -- (n_elements, blocks_per_element) global block ids.
    * ``blocks_per_element`` / ``pages_per_element`` -- scalars.
    * ``n_groups``    -- number of LUN-groups the allocator chooses among.
    * ``luns_per_group`` -- LUN columns per group (parallelism contributed
      by a single element).
    """

    spec: ElementSpec
    n_elements: int
    n_groups: int
    luns_per_group: int
    blocks_per_element: int
    pages_per_element: int
    group: np.ndarray   # (n_elements,) int32
    blocks: np.ndarray  # (n_elements, blocks_per_element) int32

    def elements_in_group(self, g: int) -> np.ndarray:
        return np.nonzero(self.group == g)[0]


def build_layout(flash: FlashGeometry, spec: ElementSpec,
                 zone: ZoneGeometry | None = None) -> ElementLayout:
    """Construct the element layout for ``spec`` on ``flash``.

    ``zone`` is required for FIXED (the element *is* a static zone).
    Blocks are numbered LUN-major: ``block = lun * B + off``.
    """
    L, B = flash.n_luns, flash.blocks_per_lun
    ppb = flash.pages_per_block

    if spec.kind is ElementKind.BLOCK:
        n_elem = L * B
        # element id e = lun * B + off  (same as global block id)
        group = (np.arange(n_elem, dtype=np.int32) // B).astype(np.int32)
        blocks = np.arange(n_elem, dtype=np.int32)[:, None]
        return ElementLayout(spec, n_elem, L, 1, 1, ppb, group, blocks)

    if spec.kind is ElementKind.HCHUNK:
        s = spec.chunk
        if B % s:
            raise ValueError(f"hchunk size {s} must divide blocks_per_lun {B}")
        n_per_lun = B // s
        n_elem = L * n_per_lun
        eids = np.arange(n_elem, dtype=np.int32)
        lun = eids // n_per_lun
        within = eids % n_per_lun
        group = lun.astype(np.int32)
        # s consecutive blocks within the LUN
        base = lun * B + within * s
        blocks = (base[:, None] + np.arange(s, dtype=np.int32)[None, :]).astype(np.int32)
        return ElementLayout(spec, n_elem, L, 1, s, s * ppb, group, blocks)

    if spec.kind in (ElementKind.VCHUNK, ElementKind.SUPERBLOCK):
        s = L if spec.kind is ElementKind.SUPERBLOCK else spec.chunk
        if L % s:
            raise ValueError(f"vchunk size {s} must divide n_luns {L}")
        n_groups = L // s
        n_elem = n_groups * B
        eids = np.arange(n_elem, dtype=np.int32)
        grp = eids // B          # LUN band
        off = eids % B           # block offset within every LUN of the band
        group = grp.astype(np.int32)
        luns = grp[:, None] * s + np.arange(s, dtype=np.int32)[None, :]
        blocks = (luns * B + off[:, None]).astype(np.int32)
        return ElementLayout(spec, n_elem, n_groups, s, s, s * ppb, group, blocks)

    if spec.kind is ElementKind.FIXED:
        if zone is None:
            raise ValueError("FIXED layout needs the zone geometry")
        P, G = zone.parallelism, zone.n_segments
        if L % P:
            raise ValueError(f"zone parallelism {P} must divide n_luns {L}")
        bands = L // P                    # vertical placement choices
        zones_per_band = B // G           # stacked zones within a band
        n_elem = bands * zones_per_band
        eids = np.arange(n_elem, dtype=np.int32)
        # band-interleaved numbering: consecutive physical zones land on
        # different LUN bands so concurrent writers scale (paper Fig. 9)
        band = eids % bands
        stack = eids // bands
        group = band.astype(np.int32)
        luns = band[:, None, None] * P + np.arange(P, dtype=np.int32)[None, :, None]
        offs = stack[:, None, None] * G + np.arange(G, dtype=np.int32)[None, None, :]
        blocks = (luns * B + offs).reshape(n_elem, P * G).astype(np.int32)
        return ElementLayout(spec, n_elem, bands, P, P * G, P * G * ppb,
                             group, blocks)

    raise ValueError(f"unknown element kind: {spec.kind}")


def elements_per_zone(layout: ElementLayout, zone: ZoneGeometry) -> int:
    """How many elements of this kind compose one zone."""
    if layout.spec.kind is ElementKind.FIXED:
        return 1
    total_blocks = zone.blocks_per_zone
    if total_blocks % layout.blocks_per_element:
        raise ValueError(
            f"zone of {total_blocks} blocks not divisible by element "
            f"{layout.spec.name} ({layout.blocks_per_element} blocks)")
    return total_blocks // layout.blocks_per_element


def groups_per_zone(layout: ElementLayout, zone: ZoneGeometry) -> int:
    """How many LUN-groups a zone's elements must span (the paper's
    parallelism constraint, adapted to the element granularity)."""
    if layout.spec.kind is ElementKind.FIXED:
        return 1
    if layout.luns_per_group > zone.parallelism:
        raise ValueError(
            f"element {layout.spec.name} spans {layout.luns_per_group} LUNs "
            f"> zone parallelism {zone.parallelism}")
    if zone.parallelism % layout.luns_per_group:
        raise ValueError(
            f"zone parallelism {zone.parallelism} not divisible by element "
            f"span {layout.luns_per_group}")
    return zone.parallelism // layout.luns_per_group


def union_grid_ids(n_elements: int, per_group: int,
                   grid_per_group: int) -> np.ndarray:
    """Dense element ids of one union member -> union-grid positions.

    A padded union layout (one static config hosting several element
    specs per lane) stores member element ``(g, c)`` at grid id
    ``g * grid_per_group + c``; for members whose group width equals
    the grid's (BLOCK / VCHUNK / SUPERBLOCK all share
    ``per_group = blocks_per_lun``) this is the identity prefix.
    """
    ids = np.arange(n_elements, dtype=np.int64)
    return (ids // per_group) * grid_per_group + ids % per_group


def union_grid_mask(grid_n_elements: int, grid_per_group: int,
                    n_elements, per_group) -> np.ndarray:
    """Boolean mask of the union grid's *real* cells for one member
    spec (or, with ``(L,)`` arrays, one row per batch lane): groups
    below ``n_elements // per_group`` and columns below ``per_group``;
    everything else is padding the allocator never touches."""
    ids = np.arange(grid_n_elements, dtype=np.int64)
    g, c = ids // grid_per_group, ids % grid_per_group
    ne = np.asarray(n_elements, dtype=np.int64)
    pg = np.asarray(per_group, dtype=np.int64)
    if ne.ndim:
        g, c, ne, pg = g[None, :], c[None, :], ne[:, None], pg[:, None]
    return (g < ne // pg) & (c < pg)


def is_applicable(spec: ElementSpec, zone: ZoneGeometry, flash: FlashGeometry) -> bool:
    """Paper Tables 3-4 mark some (geometry, element) cells N/A:
    superblock needs P == L; hchunk-s needs n_segments % s == 0 (an hchunk
    sits vertically across segments of one column)."""
    try:
        if spec.kind is ElementKind.SUPERBLOCK:
            return zone.parallelism == flash.n_luns
        if spec.kind is ElementKind.HCHUNK:
            return zone.n_segments % spec.chunk == 0
        if spec.kind is ElementKind.VCHUNK:
            return (zone.parallelism % spec.chunk == 0
                    and flash.n_luns % spec.chunk == 0)
        return True
    except Exception:
        return False
