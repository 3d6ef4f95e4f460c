"""ZoneEngine: the device state machine as batched tensors + op programs.

The PyTorch port of :mod:`repro.core.engine`.  All device state lives in
a :class:`DeviceState` of int32 tensors and every zone command is a pure
transition; an encoded ``(n_ops, >=4)`` int32 *op program* runs through
:func:`run_program`, and a batch of programs through
:func:`run_programs`.  Integer state and op traces are bit-identical to
the JAX engine on the same programs (``tests/test_torch_engine.py``).

How the JAX engine maps onto tensors:

* ``run_programs`` is ``lax.map`` over per-lane ``lax.scan``\\ s there.
  Here every ``DeviceState`` field carries one leading lane axis ``L``,
  and one Python loop over the op index steps all lanes at once.  The
  loop body never reads a value back to the host.
* Every ``lax.cond`` / ``lax.switch`` becomes compute-both-and-select
  with ``torch.where`` per lane (traditional vs silent, the round-robin
  window vs the cheapest-groups fallback, the grow branch, the
  EMPTY-triggered ALLOC inside WRITE, the op switch).
* ALLOC's whole selection (the JAX engine's ``_rr_mask`` /
  ``_take_lowest`` / ``_wear_bounded_avail`` / ``_cheapest_groups`` with
  ``lax.top_k``, and the claimed element ids) and the silent grow's are
  one ``zns_alloc`` launch each: the Hopper kernel on a CUDA device, its
  plain version on the CPU (:mod:`repro_torch.kernels.zns_alloc`).
* Scatters whose indices may repeat keep the update at the highest
  flat position, as XLA's sequential scatter does (the silent-policy
  slot collision of ``docs/CHECKING.md`` depends on it); adds
  accumulate.

Op encoding (all int32): ``[opcode, zone, n_pages, flags]`` with flags
bit0 = host write (0 -> dummy/device-internal write); extra trailing
columns ride along untouched.  Illegal ops never raise: they apply the
same partial effects as the reference and report ``ok=0`` in the trace.
Zone and opcode are clamped into range, never rejected.

Units: ``n_pages``/``zone_pages``/``wp`` count flash pages; ``wear`` and
``block_erases`` count erase-block erasures; zones and elements are
indexed densely from 0.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import zns
from repro_torch.core.alloc_exact import (AVAIL_ALLOCATED, AVAIL_FREE,
                                          AVAIL_INVALID, AVAIL_VALID)
from repro_torch.core.elements import (ElementKind, ElementLayout,
                                       ElementSpec, build_layout,
                                       elements_per_zone, groups_per_zone,
                                       union_grid_ids)
from repro_torch.core.geometry import FlashGeometry, ZoneGeometry
from repro_torch.kernels.zns_alloc import ops as zns_ops

# ----------------------------------------------------------------------- #
# op + zone-state encodings
# ----------------------------------------------------------------------- #
OP_NOP, OP_ALLOC, OP_WRITE, OP_FINISH, OP_RESET, OP_READ = range(6)
F_HOST = 1  # flags bit0: host (vs dummy) write

ZONE_EMPTY, ZONE_OPEN, ZONE_FULL = 0, 1, 2

# DynConfig.alloc_policy values: TRADITIONAL commits a zone's whole
# element grid at ALLOC time; SILENT is the paper's on-the-fly allocation.
POLICY_TRADITIONAL, POLICY_SILENT = 0, 1
_POLICY_NAMES = {"traditional": POLICY_TRADITIONAL,
                 "silent": POLICY_SILENT}

_BIG = 2**30  # sentinel wear for unavailable slots
I32 = torch.int32


# ----------------------------------------------------------------------- #
# static config + state
# ----------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SpecValues:
    """The value-only, spec-derived subset of :class:`EngineConfig`:
    everything one element spec contributes that a lane can shadow
    through a :class:`DynConfig` on a padded union layout.  All ints;
    ``pages_per_element`` in pages, the rest count elements / groups /
    slots."""

    n_elements: int
    per_group: int
    take: int
    zone_groups: int
    slot_stride: int
    pages_per_element: int


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Hashable static description of one device geometry/element spec.

    All fields are static values (they determine tensor shapes
    and loop structure).  Page-unit fields: ``pages_per_block``,
    ``zone_pages``, ``pages_per_element``; block-unit:
    ``blocks_per_element``; the rest count elements / groups / zones /
    LUN columns.  The *value-only* subset (``zone_pages``,
    ``max_active``, ``n_zones``, ``wear_aware``, plus the spec-derived
    :class:`SpecValues` fields) can be shadowed per call by a
    :class:`DynConfig`.

    ``members`` lists the element specs this config can host per lane:
    a plain :func:`make_config` has exactly its own spec; a
    :func:`make_union_config` built at the max geometry of a spec set
    has one entry per member, each carrying the member's
    :class:`SpecValues`.
    """

    kind: ElementKind
    chunk: int
    wear_aware: bool
    n_elements: int
    n_groups: int
    per_group: int
    luns_per_group: int
    take: int            # elements taken per winning group
    zone_groups: int     # winning groups per zone
    slot_stride: int     # slot = rank * slot_stride + window_position
    n_slots: int
    parallelism: int
    n_segments: int
    pages_per_block: int
    zone_pages: int
    pages_per_element: int
    blocks_per_element: int
    n_zones: int
    max_active: int
    n_channels: int
    members: Tuple[Tuple[ElementSpec, SpecValues], ...] = ()

    @property
    def spec(self) -> ElementSpec:
        return ElementSpec(self.kind, self.chunk)

    def member_values(self, spec: ElementSpec) -> SpecValues:
        """The :class:`SpecValues` of a member spec (raises
        ``ValueError`` for a spec this config was not built over)."""
        for s, v in self.members:
            if s == spec:
                return v
        raise ValueError(
            f"spec {spec.name} is not a member of this config "
            f"(members: {[s.name for s, _ in self.members]})")


class DeviceState(NamedTuple):
    """The whole device as int32 tensors.  Element arrays carry one
    trailing *scratch* slot (index ``n_elements``) absorbing masked
    scatters.  Shapes below are one device's; the states
    :func:`run_programs` returns carry a leading lane axis ``(L, ...)``
    on every field."""

    elem_wear: torch.Tensor    # (n_elements + 1,)
    elem_avail: torch.Tensor   # (n_elements + 1,)
    elem_pages: torch.Tensor   # (n_elements + 1,)
    elem_zone: torch.Tensor    # (n_elements + 1,)
    zone_state: torch.Tensor   # (n_zones,)
    zone_wp: torch.Tensor      # (n_zones,)
    zone_host_wp: torch.Tensor  # (n_zones,)
    zone_elems: torch.Tensor   # (n_zones, n_slots), -1 = unmapped/released
    zone_cols: torch.Tensor    # (n_zones, parallelism) zone column -> LUN
    rr_next: torch.Tensor      # () round-robin window start
    n_active: torch.Tensor     # () OPEN zone count
    host_pages: torch.Tensor   # ()
    dummy_pages: torch.Tensor  # ()
    block_erases: torch.Tensor  # ()
    alloc_calls: torch.Tensor  # ()


class OpTrace(NamedTuple):
    """Per-op trace: enough to rebuild IO streams host-side.  Shapes are
    one op's; :func:`run_programs` returns ``(L, n_ops, ...)``."""

    op: torch.Tensor          # () int32
    zone: torch.Tensor        # () int32
    ok: torch.Tensor          # () bool
    wp_before: torch.Tensor   # () int32
    wp_after: torch.Tensor    # () int32
    host_delta: torch.Tensor  # () int32
    dummy_delta: torch.Tensor  # () int32
    erase_delta: torch.Tensor  # () int32
    elems: torch.Tensor       # (n_slots,) int32 zone slot row *after* the op
    cols: torch.Tensor        # (parallelism,) int32 zone column -> LUN


class DynConfig(NamedTuple):
    """Per-call / per-lane overrides of the value-only
    :class:`EngineConfig` fields: each a host-side tensor, rank 0 for
    one device or ``(n_programs,)`` for a batch (see :func:`stack_dyn`);
    :func:`run_programs` copies them to its device.  The fields and
    their meaning are those of ``repro.core.engine.DynConfig``:
    ``zone_pages`` / ``max_active`` / ``n_zones`` shrink the static
    geometry, ``wear_aware`` (bool) picks lowest-(wear, col) over
    first-fit, the six spec fields select a union member, and
    ``alloc_policy`` / ``wear_bound`` select traditional vs SilentZNS
    allocation and its wear-leveling bound."""

    zone_pages: torch.Tensor
    max_active: torch.Tensor
    n_zones: torch.Tensor
    wear_aware: torch.Tensor
    n_elements: torch.Tensor
    per_group: torch.Tensor
    take: torch.Tensor
    zone_groups: torch.Tensor
    slot_stride: torch.Tensor
    pages_per_element: torch.Tensor
    alloc_policy: torch.Tensor
    wear_bound: torch.Tensor


def make_dyn(cfg: EngineConfig, *, zone_pages: Optional[int] = None,
             max_active: Optional[int] = None, n_zones: Optional[int] = None,
             wear_aware: Optional[bool] = None,
             spec: Optional[ElementSpec] = None,
             alloc_policy=None,
             wear_bound: Optional[int] = None) -> DynConfig:
    """A :class:`DynConfig` defaulting every field to ``cfg``'s value.

    ``spec`` selects a member of ``cfg.members`` (a union config's spec
    set) and fills the spec-derived fields with that member's
    :class:`SpecValues`; without it the lane runs the *primary*
    (first) member -- for a plain single-spec config that is the
    config's own spec, and for a union config it keeps dyn-less runs
    meaningful instead of mixing cross-member maxima into a spec no
    device has.

    ``alloc_policy`` is ``"traditional"`` / ``"silent"`` (or the
    :data:`POLICY_TRADITIONAL` / :data:`POLICY_SILENT` ints);
    ``wear_bound`` is the silent policy's wear-leveling bound in erases
    (``None`` = unbounded).  See :class:`DynConfig`.

    Overrides are validated eagerly: ``zone_pages`` / ``n_zones`` /
    ``max_active`` beyond the padded static config would index past the
    padded tables (silently wrong metrics), so out-of-range values
    raise ``ValueError`` here instead.  Shrinking ``zone_pages`` on a
    FIXED-kind lane is likewise rejected: FIXED elements *are* the
    whole static zone, so there is no smaller element set for the
    override to claim (see :class:`DynConfig`).  ``alloc_policy`` /
    ``wear_bound`` get the same treatment: an unknown policy or a
    negative bound would otherwise flow into the selection as a
    silently-traditional lane or an always-empty claimable set.
    """
    if spec is not None:
        sv = cfg.member_values(spec)
        kind = spec.kind
    elif cfg.members:
        spec0, sv = cfg.members[0]       # primary member
        kind = spec0.kind
    else:                                # hand-built config: own statics
        sv = SpecValues(cfg.n_elements, cfg.per_group, cfg.take,
                        cfg.zone_groups, cfg.slot_stride,
                        cfg.pages_per_element)
        kind = cfg.kind
    if zone_pages is not None:
        if not 0 < zone_pages <= cfg.zone_pages:
            raise ValueError(
                f"zone_pages override {zone_pages} out of range "
                f"(static config holds {cfg.zone_pages} pages)")
        if kind is ElementKind.FIXED and zone_pages < cfg.zone_pages:
            raise ValueError(
                "FIXED elements span the whole static zone; a "
                f"zone_pages override ({zone_pages} < {cfg.zone_pages}) "
                "cannot shrink a FIXED lane")
    if n_zones is not None and not 0 < n_zones <= cfg.n_zones:
        raise ValueError(
            f"n_zones override {n_zones} out of range "
            f"(static config holds {cfg.n_zones} zones)")
    if max_active is not None and not 0 < max_active <= cfg.max_active:
        raise ValueError(
            f"max_active override {max_active} out of range "
            f"(static config allows {cfg.max_active} active zones)")
    if alloc_policy is None:
        policy = POLICY_TRADITIONAL
    elif isinstance(alloc_policy, str):
        if alloc_policy not in _POLICY_NAMES:
            raise ValueError(
                f"alloc_policy override {alloc_policy!r} unknown "
                f"(expected one of {sorted(_POLICY_NAMES)} or the "
                f"POLICY_* ints)")
        policy = _POLICY_NAMES[alloc_policy]
    else:
        policy = int(alloc_policy)
        if policy not in (POLICY_TRADITIONAL, POLICY_SILENT):
            raise ValueError(
                f"alloc_policy override {alloc_policy!r} unknown "
                f"(expected one of {sorted(_POLICY_NAMES)} or the "
                f"POLICY_* ints)")
    if policy == POLICY_SILENT and kind is ElementKind.FIXED:
        raise ValueError(
            "alloc_policy 'silent' needs a block collection to vary; "
            "FIXED elements are the whole static zone")
    if wear_bound is not None and not 0 <= wear_bound <= _BIG:
        raise ValueError(
            f"wear_bound override {wear_bound} out of range "
            f"(must be in [0, {_BIG}])")
    def i32(v):
        return torch.tensor(int(v), dtype=I32)

    return DynConfig(
        zone_pages=i32(cfg.zone_pages if zone_pages is None
                       else zone_pages),
        max_active=i32(cfg.max_active if max_active is None
                       else max_active),
        n_zones=i32(cfg.n_zones if n_zones is None else n_zones),
        wear_aware=torch.tensor(bool(cfg.wear_aware if wear_aware is None
                                     else wear_aware)),
        n_elements=i32(sv.n_elements),
        per_group=i32(sv.per_group),
        take=i32(sv.take),
        zone_groups=i32(sv.zone_groups),
        slot_stride=i32(sv.slot_stride),
        pages_per_element=i32(sv.pages_per_element),
        alloc_policy=i32(policy),
        wear_bound=i32(_BIG if wear_bound is None else wear_bound),
    )


def dyn_values(cfg: EngineConfig, dyn: Optional[DynConfig] = None,
               lane: Optional[int] = None) -> dict:
    """Host-side snapshot of the *effective* value-only configuration:
    the :class:`DynConfig` fields (tensors, or numpy leaves as
    :func:`dyn_to_numpy` gives them) as plain Python ints/bools
    (``cfg``'s own values when ``dyn`` is ``None``); ``lane`` selects one
    row of a stacked (:func:`stack_dyn`) DynConfig."""
    if dyn is None:
        dyn = make_dyn(cfg)
    out = {}
    for name, leaf in zip(DynConfig._fields, dyn):
        v = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
             else np.asarray(leaf))
        if lane is not None and v.ndim > 0:
            v = v[lane]
        if v.ndim != 0:
            raise ValueError(
                f"dyn field {name!r} has shape {v.shape}; pass lane= "
                f"to select one row of a stacked DynConfig")
        out[name] = bool(v) if v.dtype == np.bool_ else int(v)
    return out


def stack_dyn(dyns: Sequence[DynConfig]) -> DynConfig:
    """Stack per-lane :class:`DynConfig`\\ s along a leading batch axis
    (the shape ``run_programs`` consumes for a heterogeneous batch)."""
    dyns = list(dyns)
    if not dyns:
        raise ValueError("stack_dyn needs at least one DynConfig "
                         "(an empty fleet batch has no lanes to stack)")
    return DynConfig(*[torch.stack(xs) for xs in zip(*dyns)])


def _slot_stride(spec: ElementSpec, parallelism: int) -> int:
    if spec.kind is ElementKind.BLOCK:
        return parallelism
    if spec.kind is ElementKind.VCHUNK:
        return parallelism // spec.chunk
    if spec.kind is ElementKind.SUPERBLOCK:
        return 1
    if spec.kind is ElementKind.HCHUNK:
        return parallelism
    if spec.kind is ElementKind.FIXED:
        return 1
    raise ValueError(spec.kind)


def make_config(flash: FlashGeometry, zone_geom: ZoneGeometry,
                spec: ElementSpec, *, max_active: int = 14,
                wear_aware: Optional[bool] = None
                ) -> Tuple[EngineConfig, ElementLayout]:
    layout = build_layout(flash, spec, zone_geom)
    elems = elements_per_zone(layout, zone_geom)
    zgroups = groups_per_zone(layout, zone_geom)
    values = SpecValues(
        n_elements=layout.n_elements,
        per_group=layout.n_elements // layout.n_groups,
        take=elems // zgroups,
        zone_groups=zgroups,
        slot_stride=_slot_stride(spec, zone_geom.parallelism),
        pages_per_element=layout.pages_per_element,
    )
    cfg = EngineConfig(
        kind=spec.kind,
        chunk=spec.chunk,
        wear_aware=(spec.kind is not ElementKind.FIXED
                    if wear_aware is None else wear_aware),
        n_elements=values.n_elements,
        n_groups=layout.n_groups,
        per_group=values.per_group,
        luns_per_group=layout.luns_per_group,
        take=values.take,
        zone_groups=values.zone_groups,
        slot_stride=values.slot_stride,
        n_slots=zns.n_slots(spec, zone_geom.parallelism,
                            zone_geom.n_segments),
        parallelism=zone_geom.parallelism,
        n_segments=zone_geom.n_segments,
        pages_per_block=flash.pages_per_block,
        zone_pages=zone_geom.zone_pages(flash),
        pages_per_element=values.pages_per_element,
        blocks_per_element=layout.blocks_per_element,
        n_zones=flash.n_blocks // zone_geom.blocks_per_zone,
        max_active=max_active,
        n_channels=flash.n_channels,
        members=((spec, values),),
    )
    return cfg, layout


def make_union_config(flash: FlashGeometry, zone_geom: ZoneGeometry,
                      specs: Sequence[ElementSpec], *, max_active: int = 14,
                      wear_aware: Optional[bool] = None
                      ) -> Tuple[EngineConfig, dict]:
    """One :class:`EngineConfig` hosting *any* of ``specs`` per lane.

    Static shapes are padded to the max geometry across the spec set
    (``n_groups`` x ``per_group`` element grid, ``n_slots`` / ``take``
    / ``zone_groups`` maxima); the per-spec :class:`SpecValues` land in
    ``cfg.members`` and are selected per lane with
    ``make_dyn(cfg, spec=...)``.  A member's element ``(g, c)`` lives
    at union id ``g * per_group_max + c``, so for specs sharing one
    group width (BLOCK / VCHUNK / SUPERBLOCK all have
    ``per_group = blocks_per_lun``) member ids are a dense prefix of
    the union grid.  FIXED is rejected: its element *is* the static
    zone, which leaves no spec axis to vary.

    Returns ``(cfg, layouts)`` with one :class:`ElementLayout` per
    member (host-side wear/block bookkeeping).
    """
    specs = tuple(specs)
    if not specs:
        raise ValueError("make_union_config needs at least one spec")
    if len(set(specs)) != len(specs):
        raise ValueError(f"duplicate specs in union: "
                         f"{[s.name for s in specs]}")
    if any(s.kind is ElementKind.FIXED for s in specs):
        raise ValueError("FIXED elements span the whole static zone "
                         "and cannot join a per-lane spec union")
    built = [make_config(flash, zone_geom, s, max_active=max_active,
                         wear_aware=wear_aware) for s in specs]
    cfgs = [c for c, _ in built]
    layouts = {s: lay for s, (_, lay) in zip(specs, built)}
    n_groups = max(c.n_groups for c in cfgs)
    per_group = max(c.per_group for c in cfgs)
    cfg = dataclasses.replace(
        cfgs[0],
        # the padded element grid must stay rectangular for the
        # (n_groups, per_group) allocator reshape, so the static
        # element count is the full grid, not the largest member's
        n_elements=n_groups * per_group,
        n_groups=n_groups,
        per_group=per_group,
        luns_per_group=max(c.luns_per_group for c in cfgs),
        take=max(c.take for c in cfgs),
        zone_groups=max(c.zone_groups for c in cfgs),
        slot_stride=max(c.slot_stride for c in cfgs),
        n_slots=max(c.n_slots for c in cfgs),
        pages_per_element=max(c.pages_per_element for c in cfgs),
        blocks_per_element=max(c.blocks_per_element for c in cfgs),
        members=tuple((s, c.member_values(s))
                      for s, c in zip(specs, cfgs)),
    )
    return cfg, layouts


def init_state(cfg: EngineConfig, device="cuda") -> DeviceState:
    """A fresh device (every element FREE, every zone EMPTY) on
    ``device``."""
    dev = resolve_device(device)
    n = cfg.n_elements + 1  # + scratch slot

    def full(shape, value):
        return torch.full(shape, value, dtype=I32, device=dev)

    return DeviceState(
        elem_wear=full((n,), 0),
        elem_avail=full((n,), AVAIL_FREE),
        elem_pages=full((n,), 0),
        elem_zone=full((n,), -1),
        zone_state=full((cfg.n_zones,), ZONE_EMPTY),
        zone_wp=full((cfg.n_zones,), 0),
        zone_host_wp=full((cfg.n_zones,), 0),
        zone_elems=full((cfg.n_zones, cfg.n_slots), -1),
        zone_cols=full((cfg.n_zones, cfg.parallelism), 0),
        rr_next=full((), 0),
        n_active=full((), 0),
        host_pages=full((), 0),
        dummy_pages=full((), 0),
        block_erases=full((), 0),
        alloc_calls=full((), 0),
    )


def _state_shapes(cfg: EngineConfig) -> Tuple[tuple, ...]:
    n, z = cfg.n_elements + 1, cfg.n_zones
    return ((n,),) * 4 + ((z,),) * 3 + (
        (z, cfg.n_slots), (z, cfg.parallelism)) + ((),) * 6


def state_from_numpy(cfg: EngineConfig, arrays, device="cuda"
                     ) -> DeviceState:
    """A :class:`DeviceState` from array-likes in field order (a
    ``DeviceState`` of numpy arrays, e.g. the JAX engine's leaves through
    ``np.asarray``) or a field-name mapping.  Leaves may carry leading
    lane axes; their trailing shape must be ``cfg``'s."""
    if isinstance(arrays, dict):
        arrays = [arrays[f] for f in DeviceState._fields]
    arrays = list(arrays)
    if len(arrays) != len(DeviceState._fields):
        raise ValueError(f"expected {len(DeviceState._fields)} state "
                         f"fields, got {len(arrays)}")
    dev = resolve_device(device)
    out = []
    for name, a, shape in zip(DeviceState._fields, arrays,
                              _state_shapes(cfg)):
        a = np.asarray(a)
        if a.shape[a.ndim - len(shape):] != shape or a.ndim < len(shape):
            raise ValueError(f"state field {name!r} has shape {a.shape}; "
                             f"this config needs (..., *{shape})")
        out.append(torch.as_tensor(a.astype(np.int32), device=dev))
    return DeviceState(*out)


def state_to_numpy(state: DeviceState) -> DeviceState:
    """The same state with numpy int32 leaves (host copies)."""
    return DeviceState(*[t.detach().cpu().numpy() for t in state])


def dyn_from_numpy(arrays) -> DynConfig:
    """A :class:`DynConfig` (host tensors) from array-likes in field
    order or a field-name mapping; ``wear_aware`` becomes bool, the rest
    int32."""
    if isinstance(arrays, dict):
        arrays = [arrays[f] for f in DynConfig._fields]
    arrays = list(arrays)
    if len(arrays) != len(DynConfig._fields):
        raise ValueError(f"expected {len(DynConfig._fields)} dyn fields, "
                         f"got {len(arrays)}")
    return DynConfig(*[
        torch.as_tensor(np.asarray(a).astype(
            np.bool_ if name == "wear_aware" else np.int32))
        for name, a in zip(DynConfig._fields, arrays)])


def dyn_to_numpy(dyn: DynConfig) -> DynConfig:
    """The same DynConfig with numpy leaves."""
    return DynConfig(*[t.detach().cpu().numpy() for t in dyn])


# ----------------------------------------------------------------------- #
# lane-batched tensor helpers
# ----------------------------------------------------------------------- #
class _Lanes(NamedTuple):
    """One dispatch's per-lane constants, each ``(L,)`` on the device
    unless noted: the DynConfig itself plus the values the JAX
    transitions derive from it on every op."""

    dyn: DynConfig
    ids: torch.Tensor         # lane ids, int64
    n_slots_eff: torch.Tensor
    erase_blocks: torch.Tensor  # blocks erased per invalid element
    slot_map: torch.Tensor    # (L, n_segments, P) slot of each block cell
    silent: torch.Tensor      # bool (``sel`` holds it as 0/1)
    sel: torch.Tensor         # (L, len(LANE_FIELDS)) the selections' table

    # the other per-lane constants are columns of ``sel`` (views)
    @property
    def take_eff(self) -> torch.Tensor:
        """Ranks a full-capacity claim commits."""
        return self.sel[:, _FIELD["take_eff"]]

    @property
    def per_rank(self) -> torch.Tensor:
        """Pages per claimed rank, at least 1."""
        return self.sel[:, _FIELD["per_rank"]]

    @property
    def lpg(self) -> torch.Tensor:
        """LUN columns per element."""
        return self.sel[:, _FIELD["lpg"]]


_FIELD = {name: i for i, name in enumerate(zns_ops.LANE_FIELDS)}


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _clip(x: torch.Tensor, lo: int, hi: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


def _lanes(cfg: EngineConfig, dyn: DynConfig) -> _Lanes:
    dev = dyn.zone_pages.device
    L = dyn.zone_pages.shape[0]
    ng = _fdiv(dyn.n_elements, dyn.per_group)
    n_slots_eff = _fdiv(dyn.zone_pages, dyn.pages_per_element)
    take_eff = _clip(_fdiv(n_slots_eff,
                           torch.clamp(dyn.slot_stride, min=1)),
                     1, dyn.take)
    lpg = _fdiv(torch.full_like(dyn.zone_groups, cfg.parallelism),
                dyn.zone_groups)
    seg_span = _fdiv(dyn.pages_per_element, lpg * cfg.pages_per_block)
    per_rank = torch.clamp(dyn.pages_per_element * dyn.zone_groups, min=1)
    silent = dyn.alloc_policy == POLICY_SILENT
    table = dict(per_group=dyn.per_group, n_groups=ng,
                 zone_groups=dyn.zone_groups, take_eff=take_eff,
                 wear_aware=dyn.wear_aware, silent=silent,
                 wear_bound=dyn.wear_bound, per_rank=per_rank,
                 take=dyn.take, lpg=lpg)
    return _Lanes(
        dyn=dyn,
        ids=torch.arange(L, device=dev),
        n_slots_eff=n_slots_eff,
        erase_blocks=_fdiv(dyn.pages_per_element,
                           torch.full_like(dyn.zone_groups,
                                           cfg.pages_per_block)),
        slot_map=zns.slot_map_t(dyn.slot_stride, lpg, seg_span,
                                cfg.parallelism, cfg.n_segments),
        silent=silent,
        sel=torch.stack([table[name].to(I32) for name in
                         zns_ops.LANE_FIELDS], 1).contiguous(),
    )


def _lane(pred: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``pred`` (L,) shaped to broadcast against ``t`` (L, ...)."""
    return pred.reshape(pred.shape + (1,) * (t.dim() - 1))


def _where_state(pred, new: DeviceState, old: DeviceState) -> DeviceState:
    return DeviceState(*[torch.where(_lane(pred, a), a, b)
                         for a, b in zip(new, old)])


def _at(t: torch.Tensor, ln: _Lanes, zone: torch.Tensor) -> torch.Tensor:
    """Per-lane ``t[zone]`` of a ``(L, n_zones, ...)`` tensor."""
    return t[ln.ids, zone.long()]


def _fill(t: torch.Tensor, shape, value) -> torch.Tensor:
    """``value`` (a number, or a tensor that broadcasts) as a ``shape``
    tensor of ``t``'s type -- a number never takes a host copy."""
    if isinstance(value, torch.Tensor):
        return value.to(t.dtype).expand(shape)
    return t.new_full(shape, value)


def _set_at(t: torch.Tensor, ln: _Lanes, zone: torch.Tensor, value
            ) -> torch.Tensor:
    """Per-lane ``t.at[zone].set(value)`` (one index per lane)."""
    shape = (zone.shape[0],) + t.shape[2:]
    return t.index_put((ln.ids, zone.long()), _fill(t, shape, value))


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, 1, idx.long())


def _scatter_set(t: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """``t.at[idx].set(value)`` per lane for a value that is the same at
    every repeated index (a number, or one value per lane)."""
    if isinstance(value, torch.Tensor) and value.dim() == 1:
        value = value[:, None]
    return torch.scatter(t, 1, idx.long(), _fill(t, idx.shape, value))


def _scatter_last(t: torch.Tensor, idx: torch.Tensor, val: torch.Tensor
                  ) -> torch.Tensor:
    """``t.at[idx].set(val)`` per lane where indices may repeat with
    different values: the update at the highest flat position wins, as
    in XLA's sequential scatter, and indices past the row are dropped.
    The winner is found with an order-free ``amax`` of positions, so
    the result does not depend on how the device orders the writes."""
    L, n = t.shape
    idx = torch.where((idx >= 0) & (idx < n), idx, n).long()
    pos = torch.arange(idx.shape[1], device=t.device).expand(idx.shape)
    win = torch.full((L, n + 1), -1, dtype=torch.int64, device=t.device)
    win = win.scatter_reduce(1, idx, pos, reduce="amax")[:, :n]
    got = torch.gather(val, 1, win.clamp(min=0))
    return torch.where(win >= 0, got, t)


def _scatter_add(t: torch.Tensor, idx: torch.Tensor, val: torch.Tensor
                 ) -> torch.Tensor:
    return torch.scatter_add(t, 1, idx.long(), val.to(t.dtype))


def _written_per_slot(cfg: EngineConfig, ln: _Lanes, wp: torch.Tensor
                      ) -> torch.Tensor:
    """Pages written per element slot at zone pointer ``wp`` (L,): every
    (segment, column) erase-block cell adds its page count into its
    lane's slot map entry."""
    blk = zns.pages_per_block_t(wp, cfg.parallelism, cfg.n_segments,
                                cfg.pages_per_block)
    L = wp.shape[0]
    out = torch.zeros((L, cfg.n_slots + 1), dtype=I32, device=wp.device)
    slot = ln.slot_map.reshape(L, -1)
    slot = torch.where((slot >= 0) & (slot < cfg.n_slots), slot,
                       cfg.n_slots)
    return _scatter_add(out, slot, blk.reshape(L, -1))[:, :cfg.n_slots]


# ----------------------------------------------------------------------- #
# transitions (all lanes at once; each returns the state every lane
# would reach, and the caller selects per lane)
# ----------------------------------------------------------------------- #
def _alloc(cfg: EngineConfig, ln: _Lanes, s: DeviceState,
           zone: torch.Tensor, hint: torch.Tensor
           ) -> Tuple[DeviceState, torch.Tensor]:
    """ALLOC a zone's elements.  The caller guards on the zone being
    EMPTY; this applies the selection + deferred erase.

    ``hint`` is the triggering op's ``n_pages``.  Traditional lanes
    commit the whole element grid from the round-robin window (or, when
    it is exhausted, the cheapest feasible groups); silent lanes commit
    ``ceil(hint / pages_per_rank)`` ranks (the whole grid when the hint
    is 0) from the cheapest wear-bounded groups."""
    dyn = ln.dyn
    n = cfg.n_elements
    L = zone.shape[0]
    dev = zone.device
    limit_ok = s.n_active < dyn.max_active

    if cfg.kind is ElementKind.FIXED:
        wear = s.elem_wear[:, :n]
        avail = s.elem_avail[:, :n]
        free = (avail == AVAIL_FREE) | (avail == AVAIL_INVALID)
        col = torch.arange(n, dtype=I32, device=dev)
        key = torch.where(
            free, torch.where(dyn.wear_aware[:, None], wear, col), _BIG)
        e = torch.argmin(key, 1).to(I32)
        feasible = free.any(1)
        band = torch.remainder(e, cfg.n_groups)
        cols_row = (band[:, None] * cfg.parallelism
                    + torch.arange(cfg.parallelism, dtype=I32, device=dev))
        elems_row = e[:, None].expand(L, cfg.n_slots)
        rr_next = s.rr_next
        flat = elems_row
        claimed = torch.ones_like(flat, dtype=torch.bool)
    else:
        # the whole selection, one zns_alloc launch: the round-robin
        # window or the cheapest (for silent lanes wear-bounded,
        # hint-sized) groups, and their elements in slot order
        win, eids, feasible, rr_next, rank_lim = zns_ops.alloc_select(
            s.elem_wear, s.elem_avail, ln.sel, s.rr_next, hint,
            n_groups=cfg.n_groups, per_group=cfg.per_group, take=cfg.take,
            zone_groups=cfg.zone_groups)
        ranks = torch.arange(cfg.take, dtype=I32, device=dev)[None, None, :]
        cpos = torch.arange(cfg.zone_groups, dtype=I32,
                            device=dev)[None, :, None]
        e = (slice(None), None, None)
        valid = cpos < dyn.zone_groups[e]
        raw_slots = ranks * dyn.slot_stride[e] + cpos
        slots = torch.where(valid, raw_slots, cfg.n_slots).reshape(L, -1)
        claimed = (valid & (raw_slots < ln.n_slots_eff[e])
                   & (ranks < rank_lim[e])).reshape(L, -1)
        eids = eids.reshape(L, -1)
        row = torch.full((L, cfg.n_slots + 1), -1, dtype=I32, device=dev)
        elems_row = _scatter_last(row, slots,
                                  torch.where(claimed, eids, -1)
                                  )[:, :cfg.n_slots]
        # zone column c -> LUN: window position c // lpg owns the group
        # band, c % lpg walks its LUNs
        c = torch.arange(cfg.parallelism, dtype=I32, device=dev)[None, :]
        lpg = ln.lpg[:, None]
        at = torch.clamp(_fdiv(c, lpg), 0, cfg.zone_groups - 1)
        cols_row = _gather(win, at) * lpg + torch.remainder(c, lpg)
        # unclaimed selections scatter into the scratch slot
        flat = torch.where(claimed, eids, n)

    ok = limit_ok & feasible
    # deferred physical erase of invalid elements (paper §5 RESET)
    inv = claimed & (_gather(s.elem_avail, flat) == AVAIL_INVALID)
    erase_delta = inv.sum(1).to(I32) * ln.erase_blocks
    new = s._replace(
        elem_wear=_scatter_add(s.elem_wear, flat, inv),
        elem_avail=_scatter_set(s.elem_avail, flat, AVAIL_ALLOCATED),
        elem_pages=_scatter_set(s.elem_pages, flat, 0),
        elem_zone=_scatter_set(s.elem_zone, flat, zone),
        zone_state=_set_at(s.zone_state, ln, zone, ZONE_OPEN),
        zone_wp=_set_at(s.zone_wp, ln, zone, 0),
        zone_host_wp=_set_at(s.zone_host_wp, ln, zone, 0),
        zone_elems=_set_at(s.zone_elems, ln, zone, elems_row),
        zone_cols=_set_at(s.zone_cols, ln, zone, cols_row),
        n_active=s.n_active + 1,
        block_erases=s.block_erases + erase_delta,
        alloc_calls=s.alloc_calls + 1,
    )
    out = _where_state(ok, new, s)
    # the window advance survives an infeasible attempt (not a limit
    # refusal)
    return out._replace(
        rr_next=torch.where(limit_ok, rr_next, out.rr_next)), ok


def _grow_silent(cfg: EngineConfig, ln: _Lanes, s: DeviceState,
                 zone: torch.Tensor, wp1: torch.Tensor, pred: torch.Tensor
                 ) -> Tuple[DeviceState, torch.Tensor]:
    """Silent-policy on-demand commitment: when a write will advance the
    zone pointer past the element ranks claimed so far, claim the
    missing ranks (cheapest wear-bounded elements of the zone's own
    winning groups) before the write lands.  A no-op (ok) for
    traditional lanes, FULL zones, and writes the commitment covers."""
    if cfg.kind is ElementKind.FIXED:
        return s, torch.ones_like(pred)
    dyn = ln.dyn
    n = cfg.n_elements
    L = zone.shape[0]
    dev = zone.device
    need = _clip(-_fdiv(-wp1, ln.per_rank), 1, ln.take_eff)
    # committed ranks: the claim grid is rectangular
    have = _fdiv((_at(s.zone_elems, ln, zone) >= 0).sum(1).to(I32),
                 torch.clamp(dyn.zone_groups, min=1))
    grow = pred & ln.silent & (need > have)

    k = need - have
    # the cheapest wear-bounded elements of the zone's own winning
    # groups (recovered from its column map), one zns_alloc launch
    eids, fg = zns_ops.grow_select(
        s.elem_wear, s.elem_avail, ln.sel, s.zone_cols, zone, k,
        n_groups=cfg.n_groups, per_group=cfg.per_group, take=cfg.take,
        zone_groups=cfg.zone_groups)
    ranks = torch.arange(cfg.take, dtype=I32, device=dev)[None, None, :]
    cpos = torch.arange(cfg.zone_groups, dtype=I32,
                        device=dev)[None, :, None]
    e = (slice(None), None, None)
    raw_slots = (have[e] + ranks) * dyn.slot_stride[e] + cpos
    claimed = ((cpos < dyn.zone_groups[e]) & (ranks < k[e])
               & (raw_slots < ln.n_slots_eff[e]))
    slots = torch.where(claimed, raw_slots, cfg.n_slots).reshape(L, -1)
    claimed = claimed.reshape(L, -1)
    eids = eids.reshape(L, -1)
    flat = torch.where(claimed, eids, n)
    row = torch.cat([_at(s.zone_elems, ln, zone),
                     torch.full((L, 1), -1, dtype=I32, device=dev)], 1)
    elems_row = _scatter_last(row, slots, torch.where(claimed, eids, -1)
                              )[:, :cfg.n_slots]
    # deferred physical erase, exactly as at ALLOC time
    inv = claimed & (_gather(s.elem_avail, flat) == AVAIL_INVALID)
    erase_delta = inv.sum(1).to(I32) * ln.erase_blocks
    new = s._replace(
        elem_wear=_scatter_add(s.elem_wear, flat, inv),
        elem_avail=_scatter_set(s.elem_avail, flat, AVAIL_ALLOCATED),
        elem_pages=_scatter_set(s.elem_pages, flat, 0),
        elem_zone=_scatter_set(s.elem_zone, flat, zone),
        zone_elems=_set_at(s.zone_elems, ln, zone, elems_row),
        block_erases=s.block_erases + erase_delta,
        alloc_calls=s.alloc_calls + 1,
    )
    return (_where_state(grow & fg, new, s),
            torch.where(grow, fg, torch.ones_like(fg)))


def _write(cfg: EngineConfig, ln: _Lanes, s: DeviceState, zst0, aok,
           zone, n_pages, host) -> Tuple[DeviceState, torch.Tensor]:
    """WRITE on the state after its EMPTY-triggered ALLOC (``s``;
    ``zst0`` is the zone's state before it, ``aok`` the ALLOC's ok)."""
    dyn = ln.dyn
    n = cfg.n_elements
    wp1 = _at(s.zone_wp, ln, zone) + n_pages
    fits = wp1 <= dyn.zone_pages
    s, gok = _grow_silent(cfg, ln, s, zone, wp1,
                          (zst0 != ZONE_FULL) & aok & fits)
    ok = (zst0 != ZONE_FULL) & aok & fits & gok

    written = _written_per_slot(cfg, ln, wp1)
    elems = _at(s.zone_elems, ln, zone)
    valid = elems >= 0
    idx = torch.where(valid, elems, n)
    touched = valid & (written > 0)
    seal = wp1 == dyn.zone_pages
    host_add = torch.where(host, n_pages, 0)
    new = s._replace(
        elem_pages=_scatter_last(s.elem_pages, idx, written),
        elem_avail=_scatter_set(s.elem_avail,
                                torch.where(touched, elems, n),
                                AVAIL_VALID),
        zone_wp=_set_at(s.zone_wp, ln, zone, wp1),
        zone_host_wp=_set_at(s.zone_host_wp, ln, zone,
                             _at(s.zone_host_wp, ln, zone) + host_add),
        zone_state=_set_at(s.zone_state, ln, zone,
                           torch.where(seal, ZONE_FULL, ZONE_OPEN)),
        n_active=s.n_active - seal.to(I32),
        host_pages=s.host_pages + host_add,
        dummy_pages=s.dummy_pages + torch.where(host, 0, n_pages),
    )
    return _where_state(ok, new, s), ok


def _finish(cfg: EngineConfig, ln: _Lanes, s: DeviceState, zst0, zone
            ) -> DeviceState:
    is_open = zst0 == ZONE_OPEN
    written = _written_per_slot(cfg, ln, _at(s.zone_wp, ln, zone))
    elems = _at(s.zone_elems, ln, zone)
    valid = elems >= 0
    untouched = valid & (written == 0) & is_open[:, None]
    touched = valid & (written > 0) & is_open[:, None]
    cap = ln.dyn.pages_per_element
    pad = torch.where(touched, cap[:, None] - written, 0).sum(1).to(I32)
    n = cfg.n_elements
    u_idx = torch.where(untouched, elems, n)
    t_idx = torch.where(touched, elems, n)
    avail = _scatter_set(s.elem_avail, u_idx, AVAIL_FREE)
    avail = _scatter_set(avail, t_idx, AVAIL_VALID)
    pages = _scatter_set(s.elem_pages, u_idx, 0)
    pages = _scatter_set(pages, t_idx, cap)
    new = s._replace(
        elem_avail=avail,
        elem_pages=pages,
        elem_zone=_scatter_set(s.elem_zone, u_idx, -1),
        zone_elems=_set_at(s.zone_elems, ln, zone,
                           torch.where(untouched, -1, elems)),
        zone_state=_set_at(s.zone_state, ln, zone, ZONE_FULL),
        dummy_pages=s.dummy_pages + pad,
        n_active=s.n_active - is_open.to(I32),
    )
    # FULL is a no-op; EMPTY just seals
    return _where_state(zst0 != ZONE_FULL, new, s)


def _reset(cfg: EngineConfig, ln: _Lanes, s: DeviceState, zst0, zone
           ) -> DeviceState:
    elems = _at(s.zone_elems, ln, zone)
    idx = torch.where(elems >= 0, elems, cfg.n_elements)
    cur = _gather(s.elem_avail, idx)
    nxt = torch.where(cur == AVAIL_VALID, AVAIL_INVALID,
                      torch.where(cur == AVAIL_ALLOCATED, AVAIL_FREE, cur))
    # a repeated index gathers the same code, so it scatters one value
    return s._replace(
        elem_avail=torch.scatter(s.elem_avail, 1, idx.long(), nxt),
        elem_zone=_scatter_set(s.elem_zone, idx, -1),
        elem_pages=_scatter_set(s.elem_pages, idx, 0),
        zone_state=_set_at(s.zone_state, ln, zone, ZONE_EMPTY),
        zone_wp=_set_at(s.zone_wp, ln, zone, 0),
        zone_host_wp=_set_at(s.zone_host_wp, ln, zone, 0),
        zone_elems=_set_at(s.zone_elems, ln, zone, -1),
        zone_cols=_set_at(s.zone_cols, ln, zone, 0),
        n_active=s.n_active - (zst0 == ZONE_OPEN).to(I32),
    )


# ----------------------------------------------------------------------- #
# op dispatch + program executor
# ----------------------------------------------------------------------- #
def _apply_op_impl(cfg: EngineConfig, ln: _Lanes, s: DeviceState,
                   row: torch.Tensor) -> Tuple[DeviceState, OpTrace]:
    """One op row per lane, ``row`` (L, >=4).  Every branch is computed
    for every lane and each lane keeps its opcode's; ALLOC and WRITE's
    EMPTY-triggered ALLOC are the same transition on the same state, so
    it runs once."""
    op = row[:, 0]
    zone = torch.minimum(torch.clamp(row[:, 1], min=0),
                         ln.dyn.n_zones - 1)
    n_pages = row[:, 2]
    host = (row[:, 3] & F_HOST) == F_HOST
    zst0 = _at(s.zone_state, ln, zone)
    empty = zst0 == ZONE_EMPTY

    s_alloc, ok_alloc = _alloc(cfg, ln, s, zone, n_pages)
    s_a = _where_state(empty, s_alloc, s)
    ok_a = ok_alloc | ~empty
    s_w, ok_w = _write(cfg, ln, s_a, zst0, ok_a, zone, n_pages, host)
    s_f = _finish(cfg, ln, s, zst0, zone)
    s_r = _reset(cfg, ln, s, zst0, zone)

    opc = torch.clamp(op, 0, OP_READ)
    s2 = s                                   # OP_NOP, OP_READ
    for code, branch in ((OP_ALLOC, s_a), (OP_WRITE, s_w),
                         (OP_FINISH, s_f), (OP_RESET, s_r)):
        s2 = _where_state(opc == code, branch, s2)
    ok = torch.where(opc == OP_ALLOC, ok_a,
                     torch.where(opc == OP_WRITE, ok_w,
                                 torch.ones_like(ok_a)))
    trace = OpTrace(
        op=op, zone=zone, ok=ok,
        wp_before=_at(s.zone_wp, ln, zone),
        wp_after=_at(s2.zone_wp, ln, zone),
        host_delta=s2.host_pages - s.host_pages,
        dummy_delta=s2.dummy_pages - s.dummy_pages,
        erase_delta=s2.block_erases - s.block_erases,
        elems=_at(s2.zone_elems, ln, zone),
        cols=_at(s2.zone_cols, ln, zone),
    )
    return s2, trace


def _lane_dyn(cfg: EngineConfig, dyn: Optional[DynConfig], L: int,
              dev: torch.device) -> DynConfig:
    if dyn is None:
        dyn = make_dyn(cfg)
    out = []
    for name, leaf in zip(DynConfig._fields, dyn):
        leaf = torch.as_tensor(leaf)
        if leaf.dim() == 0:
            leaf = leaf.expand(L)
        if tuple(leaf.shape) != (L,):
            raise ValueError(f"dyn field {name!r} has shape "
                             f"{tuple(leaf.shape)}; a {L}-lane batch "
                             f"needs () or ({L},)")
        out.append(leaf.to(device=dev, dtype=torch.bool
                           if name == "wear_aware" else I32).contiguous())
    return DynConfig(*out)


def apply_op(cfg: EngineConfig, state: DeviceState, row,
             dyn: Optional[DynConfig] = None
             ) -> Tuple[DeviceState, OpTrace]:
    """One zone command as a pure transition, on the state's device.

    ``row`` is one ``(>=4,)`` op row for a device state without a lane
    axis (``dyn`` with rank-0 leaves), or ``(L, >=4)`` rows -- one per
    lane -- for a state with a leading lane axis (``dyn`` with ``()`` or
    ``(L,)`` leaves).  Returns the new state and the op's trace, shaped
    like the input."""
    dev = state.elem_wear.device
    if not isinstance(row, torch.Tensor):
        row = torch.from_numpy(np.asarray(row, dtype=np.int32))
    row = row.to(device=dev, dtype=I32)
    single = row.dim() == 1
    if single:
        state = DeviceState(*[t[None] for t in state])
        row = row[None]
    if row.dim() != 2 or row.shape[1] < 4:
        raise ValueError(f"row must be (>=4,) or (L, >=4), got "
                         f"{tuple(row.shape)}")
    ln = _lanes(cfg, _lane_dyn(cfg, dyn, row.shape[0], dev))
    s, tr = _apply_op_impl(cfg, ln, state, row)
    if single:
        return (DeviceState(*[t[0] for t in s]),
                OpTrace(*[t[0] for t in tr]))
    return s, tr


def run_programs(cfg: EngineConfig, state: DeviceState, programs,
                 dyn: Optional[DynConfig] = None, *, obs=None,
                 device="cuda") -> Tuple[DeviceState, OpTrace]:
    """Run ``(n_programs, n_ops, >=4)`` int32 programs from one shared
    initial ``state``, all lanes at once on ``device``.

    ``dyn`` (optional) holds ``()`` or ``(n_programs,)`` leaves (see
    :func:`stack_dyn`): lane ``k`` runs ``programs[k]`` under
    ``dyn[k]``.  Returns ``(states, traces)`` with a leading lane axis
    on every field (``(L, n_ops, ...)`` for the traces).  The op loop
    reads nothing back from the device; the caller syncs when it reads
    the results.  ``obs`` (a ``repro_torch.obs.recorder.ObsConfig``)
    opts into per-lane telemetry folded after every op step: the return
    becomes ``(states, traces, telemetry)``.  The recorder only *reads*
    the device state, so states and traces are bit-identical with and
    without it."""
    dev = resolve_device(device)
    if not isinstance(programs, torch.Tensor):
        programs = torch.from_numpy(np.asarray(programs, dtype=np.int32))
    programs = programs.to(device=dev, dtype=I32)
    if programs.dim() != 3 or programs.shape[2] < 4:
        raise ValueError(f"programs must be (n_programs, n_ops, >=4), "
                         f"got {tuple(programs.shape)}")
    L, n_ops = programs.shape[:2]
    ln = _lanes(cfg, _lane_dyn(cfg, dyn, L, dev))
    s = DeviceState(*[t.to(dev).expand((L,) + t.shape).contiguous()
                      for t in state])
    trace = OpTrace(*[torch.empty((L, n_ops) + shape, dtype=dtype,
                                  device=dev)
                      for shape, dtype in (
                          ((), I32), ((), I32), ((), torch.bool),
                          ((), I32), ((), I32), ((), I32), ((), I32),
                          ((), I32), ((cfg.n_slots,), I32),
                          ((cfg.parallelism,), I32))])
    tel = None
    if obs is not None:
        # imported lazily: repro_torch.obs depends on core, not vice versa
        from repro_torch.obs import recorder
        tel = recorder.telemetry_init(obs, L, dev)
    for i in range(n_ops):
        row = programs[:, i]
        s2, tr = _apply_op_impl(cfg, ln, s, row)
        if tel is not None:
            tel = recorder.telemetry_update(obs, tel, s, s2, tr, row,
                                            max(n_ops, 1), i)
        s = s2
        for buf, val in zip(trace, tr):
            buf[:, i] = val
    if tel is None:
        return s, trace
    return s, trace, tel


def run_program(cfg: EngineConfig, state: DeviceState, program,
                dyn: Optional[DynConfig] = None, *, obs=None,
                device="cuda") -> Tuple[DeviceState, OpTrace]:
    """Execute one ``(n_ops, >=4)`` int32 program; ``dyn`` holds rank-0
    leaves.  Only the first four row columns are interpreted.  Returns
    one device's state and ``(n_ops, ...)`` traces (and, with ``obs``,
    its telemetry as a third element)."""
    if not isinstance(program, torch.Tensor):
        program = torch.from_numpy(np.asarray(program, dtype=np.int32))
    if dyn is not None:
        dyn = DynConfig(*[torch.as_tensor(x)[None] for x in dyn])
    out = run_programs(cfg, state, program[None], dyn, obs=obs,
                       device=device)
    return tuple(type(part)(*[t[0] for t in part]) for part in out)


# ----------------------------------------------------------------------- #
# host-facing wrapper
# ----------------------------------------------------------------------- #
def encode_program(ops, width: int = 4) -> np.ndarray:
    """``[(opcode, zone, n_pages, flags[, ...]), ...]`` -> (n_ops, width)
    int32; short rows are zero-padded."""
    out = np.zeros((len(ops), width), dtype=np.int32)
    for i, row in enumerate(ops):
        out[i, : len(row)] = row
    return out


class ZoneEngine:
    """Pure functional core of one emulated ZNS device on ``device``.

    Holds the static :class:`EngineConfig` + :class:`ElementLayout`;
    state is always passed explicitly.  ``spec`` may be a single
    :class:`ElementSpec` or a *sequence* of them: a sequence builds the
    padded union config (:func:`make_union_config`), whose lanes each
    pick a member spec through ``self.dyn(spec=...)``.  ``self.spec`` /
    ``self.layout`` refer to the first (primary) member.
    """

    def __init__(self, flash: FlashGeometry, zone_geom: ZoneGeometry,
                 spec, *, max_active: int = 14,
                 wear_aware: Optional[bool] = None, device="cuda"):
        self.device = resolve_device(device)
        self.flash = flash
        self.zone_geom = zone_geom
        if isinstance(spec, ElementSpec):
            self.cfg, self.layout = make_config(
                flash, zone_geom, spec, max_active=max_active,
                wear_aware=wear_aware)
            self.layouts = {spec: self.layout}
        else:
            self.cfg, self.layouts = make_union_config(
                flash, zone_geom, spec, max_active=max_active,
                wear_aware=wear_aware)
            self.layout = self.layouts[tuple(spec)[0]]
            spec = tuple(spec)[0]
        self.spec = spec

    # -- state ---------------------------------------------------------- #
    def init_state(self) -> DeviceState:
        return init_state(self.cfg, self.device)

    @property
    def members(self) -> dict:
        """Member spec -> :class:`SpecValues`."""
        return dict(self.cfg.members)

    def dyn(self, **overrides) -> DynConfig:
        """Per-call :class:`DynConfig` (keywords of :func:`make_dyn`)."""
        return make_dyn(self.cfg, **overrides)

    def member_element_ids(self, spec: ElementSpec) -> np.ndarray:
        """Dense element ids of ``spec`` -> their union-grid positions."""
        v = self.cfg.member_values(spec)
        return union_grid_ids(v.n_elements, v.per_group,
                              self.cfg.per_group)

    def apply(self, state: DeviceState, row,
              dyn: Optional[DynConfig] = None
              ) -> Tuple[DeviceState, OpTrace]:
        """One op row: :func:`apply_op`."""
        return apply_op(self.cfg, state, row, dyn)

    def run(self, state: DeviceState, program,
            dyn: Optional[DynConfig] = None, *, obs=None
            ) -> Tuple[DeviceState, OpTrace]:
        return run_program(self.cfg, state, program, dyn, obs=obs,
                           device=self.device)

    def run_batch(self, state: DeviceState, programs,
                  dyn: Optional[DynConfig] = None, *, obs=None
                  ) -> Tuple[DeviceState, OpTrace]:
        return run_programs(self.cfg, state, programs, dyn, obs=obs,
                            device=self.device)

    def warmup(self) -> None:
        """Run every op branch once on a scratch state, so the first
        timed command pays no kernel build or load."""
        s = self.init_state()
        for op in (OP_ALLOC, OP_WRITE, OP_FINISH, OP_RESET):
            s, _ = self.apply(s, (op, 0, 1, F_HOST))
        s.elem_wear.cpu()

    # -- metrics -------------------------------------------------------- #
    def metrics(self, state: DeviceState) -> dict:
        host = int(state.host_pages)
        dummy = int(state.dummy_pages)
        return {
            "host_pages": float(host),
            "dummy_pages": float(dummy),
            "dlwa": (host + dummy) / host if host else 1.0,
            "block_erases": float(int(state.block_erases)),
            "alloc_calls": float(int(state.alloc_calls)),
            "n_active": float(int(state.n_active)),
        }

    def elem_wear(self, state: DeviceState,
                  spec: Optional[ElementSpec] = None) -> np.ndarray:
        """Element wear in ``spec``'s dense id order (default: the
        primary spec; union-grid padding elements are excluded)."""
        ids = self.member_element_ids(spec or self.spec)
        return state.elem_wear.cpu().numpy().astype(np.int64)[ids]

    def block_wear(self, state: DeviceState,
                   spec: Optional[ElementSpec] = None) -> np.ndarray:
        spec = spec or self.spec
        layout = self.layouts[spec]
        wear = np.zeros(self.flash.n_blocks, dtype=np.int64)
        wear[layout.blocks.reshape(-1)] = np.repeat(
            self.elem_wear(state, spec), layout.blocks_per_element)
        return wear

    # -- IO stream reconstruction (host-side, after the dispatch) ------- #
    def op_stream(self, op: int, wp_before: int, wp_after: int,
                  dummy_delta: int, elems_after: np.ndarray,
                  cols: np.ndarray):
        """Rebuild the per-page ``(luns, channels, kind)`` stream of one
        traced op, exactly as the device shim's ``trace=True`` path emits
        it.  Returns ``None`` when the op moved no pages."""
        cfg = self.cfg
        cols = np.asarray(cols, dtype=np.int64)
        if op == OP_WRITE and wp_after > wp_before:
            return zns.page_stream(wp_before, wp_after - wp_before,
                                   cfg.parallelism, cfg.pages_per_block,
                                   cols, cfg.n_channels) + ("write",)
        if op == OP_FINISH and dummy_delta > 0:
            written = zns.element_pages(
                wp_before, self.spec, cfg.parallelism, cfg.n_segments,
                cfg.pages_per_block)
            padded = np.nonzero((np.asarray(elems_after) >= 0)
                                & (written > 0)
                                & (written < cfg.pages_per_element))[0]
            return zns.pad_stream(
                wp_before, cfg.zone_pages, self.spec, cfg.parallelism,
                cfg.pages_per_block, cols, padded.astype(np.int64),
                cfg.n_channels) + ("write",)
        return None
