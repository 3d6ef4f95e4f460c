"""Tenant-tagged op programs: encode *who* issued each zone command (the
port of ``repro.fleet.tenants``).

The engine's op rows are ``[opcode, zone, n_pages, flags]`` (see
:mod:`repro_torch.core.engine`); this module appends an engine-opaque fifth
column -- the **tenant tag** -- and provides the transforms that turn
per-tenant workload programs into one executable program per device:

* :func:`tag_tenant`          -- widen a width-4 program to width 5 and
                                 stamp a tenant id on every row;
* :func:`interleave_tenants`  -- merge per-tenant programs round-robin
                                 by per-tenant position, the same
                                 concurrent-submission-queue model the
                                 timing layer uses for IO streams;
* :func:`stripe_program`      -- rewrite a *logical* (superzone-
                                 addressed) program into per-member
                                 *physical* programs at zone-chunk
                                 granularity, with optional RAID-5-style
                                 log-structured parity appends, using
                                 the exact stripe math of
                                 :class:`repro_torch.array.ZNSArray`;
* :func:`pad_programs`        -- right-pad ragged per-device programs
                                 with NOP rows so a fleet stacks into
                                 the rectangular batch ``run_programs``
                                 consumes.

Units: ``n_pages`` counts flash pages; zones/tenants/devices are dense
int indexes.  Parity rows carry the reserved tag passed as
``parity_tenant`` (by convention ``n_tenants``, one past the real
tenants) so array-level DLWA can separate parity from host data.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.array.raid import locate_page, parity_device_of
from repro_torch.core import engine as zengine

#: column index of the tenant tag in a width-5 op row
TENANT_COL = 4


def tag_tenant(program: np.ndarray, tenant: int) -> np.ndarray:
    """Widen ``(n_ops, >=4)`` to width 5 and stamp ``tenant`` on every
    row (an already-width-5 program is re-stamped)."""
    program = np.asarray(program, dtype=np.int32)
    out = np.zeros((len(program), TENANT_COL + 1), dtype=np.int32)
    out[:, :4] = program[:, :4]
    out[:, TENANT_COL] = tenant
    return out


def interleave_tenants(programs: Sequence[np.ndarray]) -> np.ndarray:
    """Merge tenant programs round-robin by per-tenant op position.

    Models concurrent per-tenant submission queues drained fairly --
    exactly the merge :func:`repro_torch.core.timing._merge` applies to IO
    streams, lifted to op granularity.  A single program passes through
    unchanged (so 1 tenant x 1 device is bit-identical to the plain
    ``run_program`` path -- tested).
    """
    programs = [np.asarray(p, dtype=np.int32) for p in programs if len(p)]
    if not programs:
        return np.zeros((0, TENANT_COL + 1), dtype=np.int32)
    width = max(p.shape[1] for p in programs)
    programs = [p if p.shape[1] == width else
                np.pad(p, ((0, 0), (0, width - p.shape[1])))
                for p in programs]
    if len(programs) == 1:
        return programs[0]
    order_keys = np.concatenate(
        [np.arange(len(p), dtype=np.int64) * len(programs) + i
         for i, p in enumerate(programs)])
    perm = np.argsort(order_keys, kind="stable")
    return np.concatenate(programs)[perm]


def stripe_program(program: np.ndarray, *, n_devices: int,
                   chunk_pages: int, parity: bool,
                   member_zone_pages: int, parity_tenant: int
                   ) -> List[np.ndarray]:
    """Rewrite a logical superzone program into per-member programs.

    The logical address space is :class:`repro_torch.array.ZNSArray`'s: a
    superzone ``z`` maps to physical zone ``z`` on every member, host
    pages stripe at ``chunk_pages`` granularity across the ``n_data``
    data members of each stripe, and (with ``parity``) one parity chunk
    per stripe is appended to the rotating parity member as soon as the
    stripe completes -- or, for the final partial stripe, at FINISH.
    FINISH/RESET fan out to every member.  Each member's program is a
    strictly sequential append stream per zone, which is what a ZNS
    zone requires and what keeps SilentZNS allocation valid underneath.

    ``member_zone_pages`` is the *effective* member zone capacity in
    pages (a ``DynConfig`` override under heterogeneous geometries);
    the logical superzone capacity is ``n_data * member_zone_pages``.
    Parity rows are tagged ``parity_tenant``.

    Returns ``n_devices`` programs of width 5 (ragged lengths -- see
    :func:`pad_programs`).
    """
    if n_devices < 1:
        raise ValueError("n_devices must be >= 1")
    if parity and n_devices < 2:
        raise ValueError("parity needs >= 2 devices")
    if member_zone_pages % chunk_pages:
        raise ValueError(
            f"chunk_pages={chunk_pages} must divide the member zone "
            f"capacity ({member_zone_pages} pages)")
    n_data = n_devices - (1 if parity else 0)
    cap = n_data * member_zone_pages
    c = chunk_pages
    out: List[List[tuple]] = [[] for _ in range(n_devices)]
    wp: Dict[int, int] = {}                 # superzone -> logical wp
    emitted: Dict[int, int] = {}            # superzone -> parity stripes

    def emit_parity(zone: int, upto_stripe: int) -> None:
        if not parity:
            return
        while emitted.get(zone, 0) < upto_stripe:
            s = emitted.get(zone, 0)
            p = parity_device_of(zone, s, n_devices)
            out[p].append((zengine.OP_WRITE, zone, c, zengine.F_HOST,
                           parity_tenant))
            emitted[zone] = s + 1

    program = np.asarray(program, dtype=np.int32)
    for row in program:
        op, zone, n_pages = int(row[0]), int(row[1]), int(row[2])
        flags = int(row[3])
        tenant = int(row[TENANT_COL]) if len(row) > TENANT_COL else 0
        if op == zengine.OP_WRITE:
            page = wp.get(zone, 0)
            if page + n_pages > cap:
                raise ValueError(
                    f"superzone {zone} overflow: wp={page} + {n_pages} "
                    f"> {cap}")
            remaining = n_pages
            while remaining > 0:
                stripe, _, r, dev = locate_page(
                    zone, page, c, n_data, n_devices, parity)
                # parity of every completed stripe lands before this
                # member appends its next chunk (log-structured order)
                emit_parity(zone, stripe)
                take = min(c - r, remaining)
                out[dev].append((op, zone, take, flags, tenant))
                page += take
                remaining -= take
            wp[zone] = page
            emit_parity(zone, page // (c * n_data))
        elif op == zengine.OP_FINISH:
            page = wp.get(zone, 0)
            full_stripes = page // (c * n_data)
            emit_parity(zone, full_stripes)
            # partial-stripe parity exactly once (a repeated FINISH is
            # a no-op, matching ZNSArray's FULL-zone semantics)
            if (parity and page % (c * n_data)
                    and emitted.get(zone, 0) <= full_stripes):
                # parity over the final partial stripe covers the
                # written prefix (unwritten data reads as zeros)
                p = parity_device_of(zone, full_stripes, n_devices)
                out[p].append((zengine.OP_WRITE, zone, c, zengine.F_HOST,
                               parity_tenant))
                emitted[zone] = full_stripes + 1
            for dev in range(n_devices):
                out[dev].append((op, zone, 0, 0, tenant))
        elif op == zengine.OP_RESET:
            for dev in range(n_devices):
                out[dev].append((op, zone, 0, 0, tenant))
            wp.pop(zone, None)
            emitted.pop(zone, None)
        else:  # NOP/ALLOC/READ: replicate (state-neutral or per-member)
            for dev in range(n_devices):
                out[dev].append((op, zone, n_pages, flags, tenant))
    return [zengine.encode_program(rows, width=TENANT_COL + 1)
            for rows in out]


def pad_programs(programs: Sequence[np.ndarray],
                 n_ops: int | None = None) -> np.ndarray:
    """Right-pad ragged programs with NOP rows and stack to
    ``(n_programs, n_ops, 5)`` -- the rectangular batch
    ``run_programs`` consumes.  NOP rows are all-zero (``OP_NOP``
    moves no pages and touches no state)."""
    programs = [np.asarray(p, dtype=np.int32) for p in programs]
    width = max((p.shape[1] for p in programs if p.ndim == 2),
                default=TENANT_COL + 1)
    n_max = n_ops if n_ops is not None else max(
        (len(p) for p in programs), default=0)
    out = np.zeros((len(programs), n_max, width), dtype=np.int32)
    for i, p in enumerate(programs):
        if len(p) > n_max:
            raise ValueError(f"program {i} has {len(p)} ops > {n_max}")
        out[i, : len(p), : p.shape[1]] = p
    return out
