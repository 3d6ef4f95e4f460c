"""SilentZNS core on PyTorch: the device engine and its shim, the timing
model and the paper headline (the port of ``repro.core``)."""

from repro_torch.core.geometry import (FlashGeometry, ZoneGeometry, zn540,
                                       custom16, PAPER_GEOMETRIES, MIB, KIB)
from repro_torch.core.elements import (ElementKind, ElementSpec,
                                       ElementLayout, BLOCK, SUPERBLOCK,
                                       FIXED, hchunk, vchunk,
                                       PAPER_ELEMENTS, build_layout,
                                       elements_per_zone, groups_per_zone,
                                       is_applicable)
from repro_torch.core.device import ZNSDevice, ZoneState, ZoneInfo, IOTrace
from repro_torch.core.device_legacy import LegacyZNSDevice
from repro_torch.core.engine import (DeviceState, DynConfig, EngineConfig,
                                     OpTrace, SpecValues, ZoneEngine,
                                     apply_op, encode_program, init_state,
                                     make_dyn, make_union_config,
                                     run_program, run_programs, stack_dyn,
                                     state_from_numpy, state_to_numpy)
from repro_torch.core.backend import ZoneBackend, check_backend
from repro_torch.core.allocator import (select_lowest_wear, allocate,
                                        RoundRobin, eligible_mask)
from repro_torch.core import (alloc_exact, device_legacy, engine, headline,
                              metrics, timing, workloads, zns)

__all__ = [
    "FlashGeometry", "ZoneGeometry", "zn540", "custom16",
    "PAPER_GEOMETRIES", "MIB", "KIB",
    "ElementKind", "ElementSpec", "ElementLayout", "BLOCK", "SUPERBLOCK",
    "FIXED", "hchunk", "vchunk", "PAPER_ELEMENTS", "build_layout",
    "elements_per_zone", "groups_per_zone", "is_applicable",
    "ZNSDevice", "ZoneState", "ZoneInfo", "IOTrace", "LegacyZNSDevice",
    "DeviceState", "DynConfig", "EngineConfig", "OpTrace", "SpecValues",
    "ZoneEngine", "apply_op", "encode_program", "init_state", "make_dyn",
    "make_union_config", "run_program", "run_programs", "stack_dyn",
    "state_from_numpy", "state_to_numpy",
    "ZoneBackend", "check_backend",
    "select_lowest_wear", "allocate", "RoundRobin", "eligible_mask",
    "alloc_exact", "device_legacy", "engine", "headline", "metrics",
    "timing", "workloads", "zns",
]
