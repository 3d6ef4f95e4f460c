"""SilentZNS core on PyTorch: the device engine, its timing model and the
paper headline (the port of ``repro.core``'s main path)."""

from repro_torch.core.geometry import (FlashGeometry, ZoneGeometry, zn540,
                                       custom16, PAPER_GEOMETRIES, MIB, KIB)
from repro_torch.core.elements import (ElementKind, ElementSpec,
                                       ElementLayout, BLOCK, SUPERBLOCK,
                                       FIXED, hchunk, vchunk,
                                       PAPER_ELEMENTS, build_layout,
                                       elements_per_zone, groups_per_zone,
                                       is_applicable)
from repro_torch.core.engine import (DeviceState, DynConfig, EngineConfig,
                                     OpTrace, SpecValues, ZoneEngine,
                                     encode_program, init_state, make_dyn,
                                     make_union_config, run_program,
                                     run_programs, stack_dyn,
                                     state_from_numpy, state_to_numpy)
from repro_torch.core.allocator import (select_lowest_wear, allocate,
                                        RoundRobin, eligible_mask)
from repro_torch.core import (alloc_exact, engine, headline, timing,
                              workloads, zns)

__all__ = [
    "FlashGeometry", "ZoneGeometry", "zn540", "custom16",
    "PAPER_GEOMETRIES", "MIB", "KIB",
    "ElementKind", "ElementSpec", "ElementLayout", "BLOCK", "SUPERBLOCK",
    "FIXED", "hchunk", "vchunk", "PAPER_ELEMENTS", "build_layout",
    "elements_per_zone", "groups_per_zone", "is_applicable",
    "DeviceState", "DynConfig", "EngineConfig", "OpTrace", "SpecValues",
    "ZoneEngine", "encode_program", "init_state", "make_dyn",
    "make_union_config", "run_program", "run_programs", "stack_dyn",
    "state_from_numpy", "state_to_numpy",
    "select_lowest_wear", "allocate", "RoundRobin", "eligible_mask",
    "alloc_exact", "engine", "headline", "timing", "workloads", "zns",
]
