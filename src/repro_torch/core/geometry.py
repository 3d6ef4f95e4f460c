"""Flash + zone geometry for the augmented ZNS design space (paper §2-§4).

The paper abstracts the SSD as L parallel units (LUNs), each holding
``blocks_per_lun`` erase blocks of ``pages_per_block`` pages.  A *zone* is
built from *segments*; a segment spans ``zone_parallelism`` (P) LUNs with
one erase block per LUN, so a zone of ``n_segments`` segments holds
``n_segments * P`` erase blocks.  Writes are striped page-round-robin
across the P LUN columns of the current segment (paper Fig. 3b).

Two concrete devices from the paper (§6.1):

* ``zn540()``   — the ConfZNS++ model of a WD ZN540 (4 LUNs, 16 KiB pages,
  768-page blocks, 1 GiB zones = 22 superblocks, 48 zones, 14 active).
* ``custom16()`` — the paper's custom SSD (8 channels x 2 ways = 16 LUNs,
  4 KiB pages, 2048-page blocks -> 8 MiB blocks, 128 superblocks).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

KIB = 1024
MIB = 1024 * 1024


@dataclasses.dataclass(frozen=True)
class FlashGeometry:
    """Physical geometry of the emulated flash device."""

    n_channels: int
    ways_per_channel: int
    blocks_per_lun: int
    pages_per_block: int
    page_bytes: int
    # timing constants (seconds) -- FEMU-style per-op latencies
    t_prog: float = 500e-6
    t_read: float = 50e-6
    t_erase: float = 5e-3
    t_xfer: float = 25e-6

    @property
    def n_luns(self) -> int:
        return self.n_channels * self.ways_per_channel

    @property
    def n_blocks(self) -> int:
        return self.n_luns * self.blocks_per_lun

    @property
    def block_bytes(self) -> int:
        return self.pages_per_block * self.page_bytes

    @property
    def lun_bytes(self) -> int:
        return self.blocks_per_lun * self.block_bytes

    @property
    def device_bytes(self) -> int:
        return self.n_luns * self.lun_bytes

    def lun_of_block(self, block: int) -> int:
        """Blocks are numbered LUN-major: block = lun * blocks_per_lun + off."""
        return block // self.blocks_per_lun

    def channel_of_lun(self, lun: int) -> int:
        return lun % self.n_channels


@dataclasses.dataclass(frozen=True)
class ZoneGeometry:
    """Logical zone shape: P LUNs of parallelism x n_segments segments."""

    parallelism: int  # P: number of LUN columns a segment spans
    n_segments: int   # number of segments stacked in a zone

    @property
    def blocks_per_zone(self) -> int:
        return self.parallelism * self.n_segments

    def zone_bytes(self, flash: FlashGeometry) -> int:
        return self.blocks_per_zone * flash.block_bytes

    def zone_pages(self, flash: FlashGeometry) -> int:
        return self.blocks_per_zone * flash.pages_per_block

    def segment_pages(self, flash: FlashGeometry) -> int:
        return self.parallelism * flash.pages_per_block

    def max_zones(self, flash: FlashGeometry) -> int:
        """Upper bound on simultaneously-mapped zones for this geometry."""
        return flash.n_blocks // self.blocks_per_zone

    def describe(self, flash: FlashGeometry) -> str:
        return (
            f"P{self.parallelism}, S{self.zone_bytes(flash) // MIB}"
        )


def zn540() -> Tuple[FlashGeometry, ZoneGeometry]:
    """ConfZNS++ model of the WD ZN540 (paper §6.1, 'Baseline ZNS SSD').

    4 channels, 16 KiB pages, 768-page blocks (12 MiB).  Zone capacity
    ~1 GiB built from 22 superblocks of 4 blocks each -> 88 blocks/zone.
    48 zones total, 14 open/active.  Latencies 700us W / 60us R / 3.5ms E.
    """
    flash = FlashGeometry(
        n_channels=4,
        ways_per_channel=1,
        blocks_per_lun=48 * 22,  # 48 zones x 22 superblocks x 1 block per LUN
        pages_per_block=768,
        page_bytes=16 * KIB,
        t_prog=700e-6,
        t_read=60e-6,
        t_erase=3.5e-3,
        t_xfer=25e-6,
    )
    zone = ZoneGeometry(parallelism=4, n_segments=22)
    return flash, zone


def custom16() -> FlashGeometry:
    """The paper's custom SSD (§6.1): 8 ch x 2 ways = 16 LUNs, 4 KiB pages,
    2048-page (8 MiB) blocks, 128 blocks per LUN (128 superblocks),
    500us W / 50us R / 25us xfer / 5ms E."""
    return FlashGeometry(
        n_channels=8,
        ways_per_channel=2,
        blocks_per_lun=128,
        pages_per_block=2048,
        page_bytes=4 * KIB,
        t_prog=500e-6,
        t_read=50e-6,
        t_erase=5e-3,
        t_xfer=25e-6,
    )


#: The six zone-geometry configurations of paper Fig. 6 (for custom16()).
#: (parallelism P, n_segments) -> named "P{P}, S{MiB}".
PAPER_GEOMETRIES: Tuple[ZoneGeometry, ...] = (
    ZoneGeometry(parallelism=16, n_segments=1),   # P16, S128
    ZoneGeometry(parallelism=16, n_segments=2),   # P16, S256
    ZoneGeometry(parallelism=8, n_segments=1),    # P8,  S64
    ZoneGeometry(parallelism=8, n_segments=2),    # P8,  S128
    ZoneGeometry(parallelism=4, n_segments=1),    # P4,  S32
    ZoneGeometry(parallelism=4, n_segments=2),    # P4,  S64
)
