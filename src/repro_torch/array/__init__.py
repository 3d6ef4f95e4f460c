"""Multi-device ZNS arrays (the port of ``repro.array``, so far its
object array): ``ZNSArray`` stripes logical superzones across N
:class:`~repro_torch.core.device.ZNSDevice` members at zone-chunk
granularity with optional RAID-5-style log-structured parity, and
implements the same :class:`repro_torch.core.backend.ZoneBackend`
surface as a single device -- ``ZoneFS`` and everything above it mount
either interchangeably.  The engine-native ``ArrayEngine`` and the
rebuild storms (``repro.array.engine`` / ``storm``) are not ported yet.
"""

from repro_torch.array.raid import (ArrayGeometry, SuperZoneInfo,
                                    TaggedTrace, ZNSArray, data_device_of,
                                    locate_page, member_chunk_pages,
                                    parity_device_of)

__all__ = ["ArrayGeometry", "SuperZoneInfo", "TaggedTrace", "ZNSArray",
           "data_device_of", "locate_page", "member_chunk_pages",
           "parity_device_of"]
