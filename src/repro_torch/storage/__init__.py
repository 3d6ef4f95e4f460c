"""Zoned storage stack on the port's devices (the port of
``repro.storage``): the ZenFS-like filesystem, the KVBench LSM traffic
generator, the zone-granular flash cache, the traffic generators, and
the trace -> op-program compiler that replays a recorded application run
as one batched engine dispatch.
"""

from repro_torch.storage.compile import (CheckpointSchedule,
                                         RecordingBackend, WORKLOADS,
                                         lane_metrics, lane_state,
                                         record_cache, record_checkpoints,
                                         record_lsm, replay_recorders,
                                         run_workload, scaled_kv_config,
                                         workload_programs)
from repro_torch.storage.flashcache import CacheConfig, CacheStats, FlashCache
from repro_torch.storage.lsm import KVBenchConfig, LSMSimulator, kvbench_mix
from repro_torch.storage.traffic import (burst_arrivals, diurnal_load,
                                         zipf_weights, zipfian_keys,
                                         zipfian_tenants)
from repro_torch.storage.zonefs import ZoneFS, FSStats

__all__ = ["ZoneFS", "FSStats", "KVBenchConfig", "LSMSimulator",
           "kvbench_mix",
           "CacheConfig", "CacheStats", "FlashCache",
           "burst_arrivals", "diurnal_load", "zipf_weights",
           "zipfian_keys", "zipfian_tenants",
           "CheckpointSchedule", "RecordingBackend", "WORKLOADS",
           "lane_metrics", "lane_state", "record_cache",
           "record_checkpoints", "record_lsm", "replay_recorders",
           "run_workload", "scaled_kv_config", "workload_programs"]
