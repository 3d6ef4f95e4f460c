"""Multi-device ZNS arrays: log-structured RAID over emulated devices (the
port of ``repro.array``).

``ZNSArray`` stripes logical superzones across N
:class:`~repro_torch.core.device.ZNSDevice` members at zone-chunk
granularity with optional RAID-5-style log-structured parity, and
implements the same :class:`repro_torch.core.backend.ZoneBackend` surface
as a single device -- ``ZoneFS`` and everything above it mount either
interchangeably.

:class:`ArrayEngine` is the engine-native port of the same state
machine: zone commands compile to encoded per-member op programs that
execute in ONE batched ``run_programs`` dispatch (K arrays with mixed
member counts / chunk sizes / parity / element specs per batch), with
the object ``ZNSArray`` kept as the bit-exactness oracle.
``repro_torch.array.storm`` runs batched rebuild storms on top of it.
:func:`array_vs_legacy_speedup` times the batched dispatch against the
object array over per-op shims, holding every array's report to an
object array over ``LegacyZNSDevice`` members first; :func:`array_batch`
builds its engine leg.
"""

from repro_torch.array.engine import (ArrayEngine, ArrayResult,
                                      apply_commands, array_batch,
                                      array_vs_legacy_speedup,
                                      fill_commands, run_array_batch,
                                      run_array_timing)
from repro_torch.array.raid import (ArrayGeometry, SuperZoneInfo,
                                    TaggedTrace, ZNSArray, data_device_of,
                                    locate_page, member_chunk_pages,
                                    parity_device_of)
from repro_torch.array.storm import StormScenario, rebuild_storm

__all__ = ["ArrayEngine", "ArrayGeometry", "ArrayResult", "StormScenario",
           "SuperZoneInfo", "TaggedTrace", "ZNSArray", "apply_commands",
           "array_batch", "array_vs_legacy_speedup", "data_device_of", "fill_commands",
           "locate_page", "member_chunk_pages", "parity_device_of",
           "rebuild_storm", "run_array_batch", "run_array_timing"]
