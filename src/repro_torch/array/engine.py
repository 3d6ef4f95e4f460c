"""Engine-native ZNS-RAID: the array data plane compiled onto ``ZoneEngine``
(the port of ``repro.array.engine``).

:class:`ArrayEngine` keeps :class:`repro_torch.array.raid.ZNSArray`'s exact
state machine -- zone-chunk striping, rotated append-only parity,
degraded reads, ``rebuild_device`` -- but *compiles* it instead of
interpreting it: every zone command is lowered host-side into encoded
per-member op rows (using the same module-level stripe math
``fleet/tenants.py`` shares with the object array), and the whole
member fleet then executes in ONE batched ``run_programs`` dispatch --
one op step per program row for every member lane at once, on the
engine's device.

The host side keeps only the superzone mirror (``SuperZoneInfo`` per
zone, the same metadata the object array keeps): enough to validate
commands eagerly with the object array's exact errors, to route
degraded reads to the surviving members that physically wrote a chunk
row, and to plan a rebuild without touching device state.  Because the
engine's ``OP_READ`` is state-neutral and a rebuilt member starts
blank, *everything* composes into the one-dispatch model: a rebuild
simply replaces the failed lane's program with the replacement's
append stream (reads land on the survivor lanes), and the next
:meth:`ArrayEngine.run` replays the array's full history from a blank
shared initial state.

The object ``ZNSArray`` stays as the bit-exactness oracle:
:meth:`ArrayEngine.report` and :meth:`ArrayEngine.device_reports`
reproduce its rollups exactly (``tests/test_torch_array_engine.py``
holds them to the reference's and to the port's object array).
:func:`array_vs_legacy_speedup` times the batched dispatch against the
object array over per-op shims, after holding every array's report to
an object array over ``LegacyZNSDevice`` members (the pure-numpy oracle);
:func:`array_batch` builds its engine leg.

Batched sweeps: :func:`run_array_batch` stacks K arrays (mixed member
counts, chunk sizes, parity settings, and -- on a union-config engine
-- mixed per-member element specs via per-lane ``DynConfig``) into one
padded dispatch.  ``repro_torch.array.storm`` builds the rebuild-storm
mode on top of it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.array.raid import (ArrayGeometry, SuperZoneInfo,
                                    ZNSArray, locate_page,
                                    member_chunk_pages, parity_device_of)
from repro_torch.core import engine as zengine
from repro_torch.core import timing
from repro_torch.core.alloc_exact import AVAIL_INVALID
from repro_torch.core.device import ZoneState
from repro_torch.core.elements import ElementSpec
from repro_torch.core.engine import (DeviceState, OpTrace, ZoneEngine,
                                     stack_dyn)

#: column index of the tenant tag in a width-5 op row (same convention
#: as repro_torch.fleet.tenants.TENANT_COL; duplicated to keep the
#: layering acyclic -- fleet builds on array, not the reverse)
TENANT_COL = 4


@dataclasses.dataclass
class ArrayResult:
    """Decoded outputs of one array dispatch (numpy, apart from
    ``states`` on the CPU and ``telemetry`` on the engine's device).

    Lane axis = member device index (``n_devices`` lanes); op axis is
    the padded per-member program length.  ``pages`` counts the flash
    pages an op physically moved *including reads* (the engine's
    ``OP_READ`` is state-neutral, so its page count comes from the
    program row, not the write pointer) -- the quantity the op-granular
    timing model books LUN-busy time with.
    """

    programs: np.ndarray     # (n_devices, n_ops, 5) i32
    states: DeviceState      # stacked CPU tensors, leading axis n_devices
    ok: np.ndarray           # (n_devices, n_ops) bool
    host_delta: np.ndarray   # (n_devices, n_ops) host pages per op
    dummy_delta: np.ndarray  # (n_devices, n_ops) FINISH-pad pages
    erase_delta: np.ndarray  # (n_devices, n_ops) block erasures
    pages: np.ndarray        # (n_devices, n_ops) pages moved (R+W+pad)
    cols: np.ndarray         # (n_devices, n_ops, P) zone column -> LUN
    #: per-lane telemetry stack (repro_torch.obs TelemetryState) when the
    #: dispatch ran with obs=ObsConfig(...), else None
    telemetry: Optional[object] = None

    @property
    def tenants(self) -> np.ndarray:
        return self.programs[:, :, TENANT_COL]

    def member_state(self, idx: int) -> DeviceState:
        """Member ``idx``'s final ``DeviceState`` (leading axis sliced)."""
        return DeviceState(*[a[idx] for a in self.states])


def _decode_result(programs: np.ndarray, states: DeviceState, trace,
                   telemetry) -> ArrayResult:
    wp_b = trace.wp_before
    wp_a = trace.wp_after
    dummy = trace.dummy_delta
    op = programs[:, :, 0]
    # pages the op physically moved: write advance, FINISH padding, and
    # -- unlike the write-only fleet runner -- READ page counts (reads
    # are engine nops; their size rides in the program row)
    pages = (np.maximum(wp_a - wp_b, 0)
             + np.where(op == zengine.OP_FINISH, dummy, 0)
             + np.where(op == zengine.OP_READ, programs[:, :, 2], 0))
    return ArrayResult(
        programs=programs,
        states=states,
        ok=trace.ok,
        host_delta=trace.host_delta,
        dummy_delta=dummy,
        erase_delta=trace.erase_delta,
        pages=pages.astype(np.int32),
        cols=trace.cols,
        telemetry=telemetry,
    )


class ArrayEngine:
    """The engine-native :class:`ZNSArray`: same surface, compiled body.

    Commands (``zone_write`` / ``zone_finish`` / ``zone_reset`` /
    ``zone_read`` / ``fail_device`` / ``rebuild_device``) validate
    eagerly against the host-side superzone mirror -- raising the object
    array's exact errors -- and append encoded op rows to the per-member
    programs.  :meth:`run` executes the accumulated programs from a
    blank shared state in one batched dispatch; :meth:`report` /
    :meth:`device_reports` then reproduce ``ZNSArray``'s rollups
    bit-exactly from the stacked ``DeviceState``.

    ``eng`` may be shared between many arrays (it is stateless); build
    it over a spec *set* and pass ``member_specs`` to run a
    heterogeneous-member array (mixed element granularities) -- each
    member lane selects its spec through the per-lane ``DynConfig``.

    Tenant tags: data rows carry the caller's ``tenant`` (default 0),
    parity appends carry ``n_tenants``, rebuild traffic carries
    ``n_tenants + 1`` -- so the op-granular timing model can separate
    host, parity, and rebuild streams.
    """

    def __init__(self, eng: ZoneEngine, geom: ArrayGeometry, *,
                 member_specs: Optional[Sequence[ElementSpec]] = None,
                 zone_pages: Optional[int] = None,
                 max_active: Optional[int] = None,
                 wear_aware: Optional[bool] = None,
                 alloc_policy: Optional[str] = None,
                 n_tenants: int = 1):
        self.eng = eng
        self.geom = geom
        cfg = eng.cfg
        self.dev_zone_pages = int(zone_pages if zone_pages is not None
                                  else cfg.zone_pages)
        if self.dev_zone_pages % geom.chunk_pages:
            raise ValueError(
                f"chunk_pages={geom.chunk_pages} must divide the member "
                f"zone capacity ({self.dev_zone_pages} pages)")
        self.stripes_per_zone = self.dev_zone_pages // geom.chunk_pages
        self.n_zones = int(cfg.n_zones)
        self.max_active = int(max_active if max_active is not None
                              else cfg.max_active)
        self.flash = eng.flash
        if member_specs is None:
            member_specs = (eng.spec,) * geom.n_devices
        member_specs = tuple(member_specs)
        if len(member_specs) != geom.n_devices:
            raise ValueError(
                f"got {len(member_specs)} member specs for geometry "
                f"{geom.describe()}")
        for s in member_specs:
            if s not in eng.members:
                raise ValueError(
                    f"member spec {s.name} is not a member of the "
                    f"engine's config; build the engine over the spec "
                    f"set")
        self.member_specs = member_specs
        # per-member wear_aware / alloc_policy: a rebuilt member is a
        # stock blank device (the object array's replacement drops the
        # overrides).  Note the bit-exactness oracle (the object
        # ZNSArray) has no silent allocator, so wear rollups are only
        # cross-checked against it when alloc_policy is unset.
        self._member_wear_aware: List[Optional[bool]] = (
            [wear_aware] * geom.n_devices)
        self._member_alloc_policy: List[Optional[str]] = (
            [alloc_policy] * geom.n_devices)
        self.n_tenants = int(n_tenants)
        self.parity_tenant = self.n_tenants
        self.rebuild_tenant = self.n_tenants + 1

        self.zones: Dict[int, SuperZoneInfo] = {
            z: SuperZoneInfo() for z in range(self.n_zones)}
        self.failed: set[int] = set()
        self.host_pages = 0
        self.parity_pages = 0
        self._rows: List[List[tuple]] = [[] for _ in range(geom.n_devices)]
        self._result: Optional[ArrayResult] = None
        self._dirty = True

    # ------------------------------------------------------------------ #
    # construction helper (mirrors ZNSArray.build)
    # ------------------------------------------------------------------ #
    @classmethod
    def build(cls, flash, zone_geom, spec, *, n_devices: int,
              chunk_pages: Optional[int] = None, parity: bool = False,
              max_active: int = 14, wear_aware: Optional[bool] = None,
              alloc_policy: Optional[str] = None,
              n_tenants: int = 1, device="cuda") -> "ArrayEngine":
        """Own-engine constructor on ``device``; ``chunk_pages``
        defaults to one segment, like :meth:`ZNSArray.build`.  ``spec``
        may be a sequence (heterogeneous members over a union config)."""
        if chunk_pages is None:
            chunk_pages = zone_geom.segment_pages(flash)
        member_specs = None
        if not isinstance(spec, ElementSpec):
            member_specs = tuple(spec[d % len(spec)]
                                 for d in range(n_devices))
            spec = tuple(dict.fromkeys(spec))
            if len(spec) == 1:
                spec = spec[0]
        eng = ZoneEngine(flash, zone_geom, spec, max_active=max_active,
                         device=device)
        return cls(eng, ArrayGeometry(n_devices, chunk_pages, parity),
                   member_specs=member_specs, wear_aware=wear_aware,
                   alloc_policy=alloc_policy, n_tenants=n_tenants)

    # ------------------------------------------------------------------ #
    # geometry / metrics mirror (ZoneBackend-shaped surface)
    # ------------------------------------------------------------------ #
    @property
    def zone_pages(self) -> int:
        """Host-visible capacity of a superzone (data chunks only)."""
        return self.dev_zone_pages * self.geom.n_data

    @property
    def n_active(self) -> int:
        return sum(1 for z in self.zones.values()
                   if z.state is ZoneState.OPEN)

    @property
    def dlwa(self) -> float:
        if self.host_pages == 0:
            return 1.0
        return ((self.host_pages + self.parity_pages + self.dummy_pages)
                / self.host_pages)

    @property
    def dummy_pages(self) -> int:
        res = self.result()
        return int(res.states.dummy_pages.sum())

    # ------------------------------------------------------------------ #
    # stripe math (the shared module-level functions)
    # ------------------------------------------------------------------ #
    def _parity_device(self, zone_id: int, stripe: int) -> int:
        return parity_device_of(zone_id, stripe, self.geom.n_devices)

    def _locate(self, zone_id: int, page: int) -> Tuple[int, int, int, int]:
        return locate_page(zone_id, page, self.geom.chunk_pages,
                           self.geom.n_data, self.geom.n_devices,
                           self.geom.parity)

    def _member_chunk(self, zone_id: int, stripe: int, idx: int,
                      info: SuperZoneInfo) -> int:
        return member_chunk_pages(
            zone_id, stripe, idx, chunk_pages=self.geom.chunk_pages,
            n_data=self.geom.n_data, n_devices=self.geom.n_devices,
            parity=self.geom.parity, wp=info.wp,
            parity_emitted=info.parity_emitted)

    def member_wp(self, zone_id: int, idx: int) -> int:
        """Member ``idx``'s physical write pointer in zone ``zone_id``,
        reconstructed from superzone metadata (sum of its chunk rows) --
        what the object array reads off ``devices[idx].zones[z].wp``."""
        info = self.zones[zone_id]
        return sum(self._member_chunk(zone_id, s, idx, info)
                   for s in range(self.stripes_per_zone))

    # ------------------------------------------------------------------ #
    # command compilers (the ZNSArray state machine, emitting op rows)
    # ------------------------------------------------------------------ #
    def zone_write(self, zone_id: int, n_pages: int, *, host: bool = True,
                   tenant: int = 0, trace: bool = False) -> None:
        """Compile a logical superzone write into striped member rows
        (parity appends land log-structured, exactly like the object
        array).  ``trace`` is accepted for surface compatibility and
        ignored -- traces come from the batched run."""
        del trace
        info = self.zones[zone_id]
        if info.state is ZoneState.FULL:
            raise RuntimeError(f"write to FULL superzone {zone_id}")
        if info.state is ZoneState.EMPTY:
            if self.n_active >= self.max_active:
                raise RuntimeError(
                    f"open/active superzone limit ({self.max_active}) "
                    "reached")
            info.state = ZoneState.OPEN
        if info.wp + n_pages > self.zone_pages:
            raise RuntimeError(
                f"superzone {zone_id} overflow: wp={info.wp} + {n_pages} "
                f"> {self.zone_pages}")
        c = self.geom.chunk_pages
        flags = zengine.F_HOST if host else 0
        remaining, page = n_pages, info.wp
        while remaining > 0:
            stripe, _, r, dev = self._locate(zone_id, page)
            # parity for every completed stripe must land before this
            # device appends its next chunk row (log-structured order)
            self._emit_parity(zone_id, info, upto_stripe=stripe)
            take = min(c - r, remaining)
            self._rows[dev].append(
                (zengine.OP_WRITE, zone_id, take, flags, tenant))
            page += take
            remaining -= take
        info.wp = page
        if host:
            info.host_wp += n_pages
            self.host_pages += n_pages
        self._emit_parity(zone_id, info,
                          upto_stripe=info.wp // (c * self.geom.n_data))
        if info.wp == self.zone_pages:
            info.state = ZoneState.FULL
        self._dirty = True

    def _emit_parity(self, zone_id: int, info: SuperZoneInfo, *,
                     upto_stripe: int) -> None:
        if not self.geom.parity:
            return
        c = self.geom.chunk_pages
        while info.parity_emitted < upto_stripe:
            s = info.parity_emitted
            p = self._parity_device(zone_id, s)
            self._rows[p].append(
                (zengine.OP_WRITE, zone_id, c, zengine.F_HOST,
                 self.parity_tenant))
            self.parity_pages += c
            info.parity_emitted += 1

    def zone_finish(self, zone_id: int, *, tenant: int = 0,
                    trace: bool = False) -> None:
        """Partial-stripe parity (once), then member FINISH fan-out."""
        del trace
        info = self.zones[zone_id]
        if info.state is ZoneState.FULL:
            return
        if info.state is ZoneState.OPEN:
            c, k = self.geom.chunk_pages, self.geom.n_data
            full_stripes = info.wp // (c * k)
            self._emit_parity(zone_id, info, upto_stripe=full_stripes)
            if self.geom.parity and info.wp % (c * k):
                s = full_stripes
                p = self._parity_device(zone_id, s)
                self._rows[p].append(
                    (zengine.OP_WRITE, zone_id, c, zengine.F_HOST,
                     self.parity_tenant))
                self.parity_pages += c
                info.parity_emitted += 1
        for dev in range(self.geom.n_devices):
            self._rows[dev].append(
                (zengine.OP_FINISH, zone_id, 0, 0, tenant))
        info.state = ZoneState.FULL
        self._dirty = True

    def zone_reset(self, zone_id: int, *, tenant: int = 0) -> None:
        for dev in range(self.geom.n_devices):
            self._rows[dev].append(
                (zengine.OP_RESET, zone_id, 0, 0, tenant))
        self.zones[zone_id] = SuperZoneInfo()
        self._dirty = True

    def zone_read(self, zone_id: int, pages, *, tenant: int = 0
                  ) -> Dict[int, np.ndarray]:
        """Route logical page reads to members (degraded reads included,
        with the object array's exact error semantics) and append one
        ``OP_READ`` row per touched member.  Returns the physical read
        plan ``{member: offsets}`` -- the routing the object array's
        tagged traces realize, exposed for differential tests."""
        info = self.zones[zone_id]
        if info.state is ZoneState.EMPTY:
            raise RuntimeError(f"read from unmapped superzone {zone_id}")
        c = self.geom.chunk_pages
        per_dev: List[List[int]] = [[] for _ in range(self.geom.n_devices)]
        member_wp = [self.member_wp(zone_id, d)
                     for d in range(self.geom.n_devices)]
        for page in np.asarray(pages, dtype=np.int64):
            stripe, _, r, dev_idx = self._locate(zone_id, int(page))
            if dev_idx in self.failed:
                if not self.geom.parity:
                    raise RuntimeError(
                        f"device {dev_idx} failed and parity is off: "
                        f"superzone {zone_id} page {int(page)} lost")
                if stripe >= info.parity_emitted:
                    raise RuntimeError(
                        f"superzone {zone_id} page {int(page)}: stripe "
                        f"{stripe} parity not yet written, page lost")
                # degraded: same chunk row from every surviving member
                # that physically wrote it
                off = stripe * c + r
                for other in range(self.geom.n_devices):
                    if other == dev_idx or other in self.failed:
                        continue
                    if member_wp[other] <= off:
                        continue
                    per_dev[other].append(off)
            else:
                per_dev[dev_idx].append(stripe * c + r)
        plan: Dict[int, np.ndarray] = {}
        for i, plist in enumerate(per_dev):
            if not plist:
                continue
            self._rows[i].append(
                (zengine.OP_READ, zone_id, len(plist), 0, tenant))
            plan[i] = np.asarray(plist, dtype=np.int64)
        self._dirty = True
        return plan

    # ------------------------------------------------------------------ #
    # failure injection + rebuild
    # ------------------------------------------------------------------ #
    def fail_device(self, idx: int) -> None:
        if (self.geom.parity and len(self.failed) >= 1
                and idx not in self.failed):
            raise RuntimeError("single-parity array cannot survive a "
                               "second device failure")
        self.failed.add(idx)

    def heal_device(self, idx: int) -> None:
        self.failed.discard(idx)

    def rebuild_device(self, idx: int) -> List[Tuple[int, int, int, int]]:
        """Compile the rebuild: survivor reads + replacement appends.

        The failed lane's program is *replaced* by the reconstructed
        append stream (the replacement starts blank, exactly like the
        object array's fresh ``ZNSDevice``); every chunk row it held is
        re-read from the surviving members that wrote it (stripe XOR --
        the degraded-read access pattern) as state-neutral ``OP_READ``
        rows on their lanes.  Nothing executes until :meth:`run`; the
        whole rebuild then rides the same single dispatch as the rest
        of the array's history.

        Returns the read plan as ``(survivor, zone, offset, n_read)``
        tuples (what the object array's tagged traces realize).
        """
        if not self.geom.parity:
            raise RuntimeError("rebuild requires parity")
        if any(f != idx for f in self.failed):
            raise RuntimeError("cannot rebuild with another member down")
        c = self.geom.chunk_pages
        new_rows: List[tuple] = []
        plan: List[Tuple[int, int, int, int]] = []
        for z, info in self.zones.items():
            if info.wp == 0 and info.parity_emitted == 0:
                continue
            dwp = {other: self.member_wp(z, other)
                   for other in range(self.geom.n_devices)}
            wrote = 0
            for s in range(self.stripes_per_zone):
                pages_here = self._member_chunk(z, s, idx, info)
                if pages_here <= 0:
                    continue
                off = s * c
                for other in range(self.geom.n_devices):
                    if other == idx or other in self.failed:
                        continue
                    if dwp[other] <= off:
                        continue
                    n_read = min(pages_here, dwp[other] - off)
                    self._rows[other].append(
                        (zengine.OP_READ, z, n_read, 0,
                         self.rebuild_tenant))
                    plan.append((other, z, off, n_read))
                new_rows.append(
                    (zengine.OP_WRITE, z, pages_here, zengine.F_HOST,
                     self.rebuild_tenant))
                wrote += pages_here
            if info.state is ZoneState.FULL and wrote > 0:
                new_rows.append(
                    (zengine.OP_FINISH, z, 0, 0, self.rebuild_tenant))
        self._rows[idx] = new_rows
        # the replacement is a stock device: the object array builds it
        # without the wear_aware / alloc_policy overrides, so the
        # oracle does too
        self._member_wear_aware[idx] = None
        self._member_alloc_policy[idx] = None
        self.failed.discard(idx)
        self._dirty = True
        return plan

    # ------------------------------------------------------------------ #
    # lowering + execution
    # ------------------------------------------------------------------ #
    def member_dyn(self, idx: int):
        """Per-lane ``DynConfig`` binding member ``idx``'s element spec
        / effective capacity / allocator on the shared engine config."""
        kw: Dict = {"spec": self.member_specs[idx]}
        if self.dev_zone_pages != int(self.eng.cfg.zone_pages):
            kw["zone_pages"] = self.dev_zone_pages
        if self.max_active != int(self.eng.cfg.max_active):
            kw["max_active"] = self.max_active
        if self._member_wear_aware[idx] is not None:
            kw["wear_aware"] = self._member_wear_aware[idx]
        if self._member_alloc_policy[idx] is not None:
            kw["alloc_policy"] = self._member_alloc_policy[idx]
        return self.eng.dyn(**kw)

    def member_programs(self) -> List[np.ndarray]:
        """The compiled per-member programs (ragged, width 5)."""
        return [zengine.encode_program(rows, width=TENANT_COL + 1)
                for rows in self._rows]

    def run(self, *, obs=None, pad_quantum: int = 1,
            sanitize: bool = False) -> ArrayResult:
        """Execute the array's full compiled history from a blank shared
        state: ONE batched ``run_programs`` dispatch over the member
        lanes (``obs`` threads the in-scan telemetry recorder through
        it).  Illegal rows cannot occur -- commands were validated at
        compile time -- and that is asserted, not assumed; ``sanitize``
        additionally audits the final member device states with the
        :mod:`repro_torch.check` sanitizer."""
        res = run_array_batch([self], obs=obs,
                              pad_quantum=pad_quantum,
                              sanitize=sanitize)[0]
        return res

    def result(self) -> ArrayResult:
        """The latest dispatch result (re-runs if commands were compiled
        since)."""
        if self._dirty or self._result is None:
            self.run()
        return self._result

    # ------------------------------------------------------------------ #
    # rollups (bit-exact with the object ZNSArray)
    # ------------------------------------------------------------------ #
    def device_reports(self) -> List[Dict[str, float]]:
        res = self.result()
        out = []
        for i in range(self.geom.n_devices):
            st = res.member_state(i)
            spec = self.member_specs[i]
            host = int(st.host_pages)
            dummy = int(st.dummy_pages)
            erases = int(st.block_erases)
            ids = self.eng.member_element_ids(spec)
            layout = self.eng.layouts[spec]
            inv = np.asarray(st.elem_avail)[ids] == AVAIL_INVALID
            pending = int(inv.sum()) * layout.blocks_per_element
            w = self.eng.block_wear(st, spec)
            out.append({
                "device": float(i),
                "dlwa": (host + dummy) / host if host else 1.0,
                "host_pages": float(host),
                "dummy_pages": float(dummy),
                "failed": float(i in self.failed),
                "total_block_erases": float(erases),
                "pending_block_erases": float(pending),
                "total_incl_pending": float(erases + pending),
                "mean_wear": float(w.mean()),
                "max_wear": float(w.max()),
                "std_wear": float(w.std()),
                "cv_wear": (float(w.std() / w.mean())
                            if w.mean() > 0 else 0.0),
            })
        return out

    def report(self) -> Dict[str, float]:
        """Array-level rollup, key-for-key ``ZNSArray.report()``."""
        per = self.device_reports()
        dummy = sum(int(r["dummy_pages"]) for r in per)
        host = self.host_pages
        return {
            "n_devices": float(self.geom.n_devices),
            "chunk_pages": float(self.geom.chunk_pages),
            "parity": float(self.geom.parity),
            "host_pages": float(host),
            "parity_pages": float(self.parity_pages),
            "dummy_pages": float(dummy),
            "dlwa": ((host + self.parity_pages + dummy) / host
                     if host else 1.0),
            "parity_overhead": (self.parity_pages / host if host else 0.0),
            "max_device_dlwa": max(r["dlwa"] for r in per),
            "total_block_erases": sum(r["total_block_erases"]
                                      for r in per),
            "total_incl_pending": sum(r["total_incl_pending"]
                                      for r in per),
            "max_wear": max(r["max_wear"] for r in per),
        }

    def fleet_timing(self, *, skip_rows: Optional[Sequence[int]] = None
                     ) -> Dict[str, float]:
        """Op-granular fleet timing of the compiled history: one
        ``simulate_fleet_ops`` dispatch with per-op page costs (reads
        at ``t_read + t_xfer``, writes at ``t_prog + t_xfer``).

        ``skip_rows`` (per-member row counts) masks a program prefix
        out of the clock -- the rebuild-storm mode times only the storm
        phase, not the fill that established the array state.
        """
        res = self.result()
        pages = res.pages
        if skip_rows is not None:
            pages = pages.copy()
            for lane, m in enumerate(skip_rows):
                pages[lane, :m] = 0
        completions, latencies, makespans = run_array_timing(
            self.flash, res.programs, res.cols, pages,
            n_tenants=self.rebuild_tenant + 1, device=self.eng.device)
        out = {"fleet_makespan_s": float(makespans.max(initial=0.0)),
               "fleet_pages": float(pages.sum())}
        for i in range(self.geom.n_devices):
            out[f"dev{i}_makespan_s"] = float(makespans[i])
        for t in range(self.rebuild_tenant + 1):
            sel = (res.tenants == t) & (pages > 0)
            out[f"tenant{t}_makespan_s"] = (
                float(completions[sel].max()) if sel.any() else 0.0)
        return out


# --------------------------------------------------------------------- #
# batched sweeps: K arrays in one dispatch
# --------------------------------------------------------------------- #
def run_array_batch(arrays: Sequence[ArrayEngine], *, obs=None,
                    pad_quantum: int = 1,
                    sanitize: bool = False) -> List[ArrayResult]:
    """Execute K arrays' member lanes in ONE ``run_programs`` dispatch.

    All arrays must share one ``ZoneEngine`` (they may still mix member
    counts, chunk sizes, parity, effective zone capacities, and -- on a
    union config -- per-member element specs: every lane carries its
    own ``DynConfig``).  ``pad_quantum`` rounds the padded op axis as
    the reference does, so same-scale batches run the same padded
    programs.  Each array's
    result is installed (so ``report()`` works) and returned in order.
    ``sanitize`` audits every member lane's final device state with the
    :mod:`repro_torch.check` sanitizer (host-side numpy on the
    already-fetched states).
    """
    if not arrays:
        return []
    eng = arrays[0].eng
    for a in arrays:
        if a.eng is not eng:
            raise ValueError("all arrays of one batch must share a "
                             "ZoneEngine")
    lane_programs: List[np.ndarray] = []
    dyns = []
    for a in arrays:
        lane_programs += a.member_programs()
        dyns += [a.member_dyn(d) for d in range(a.geom.n_devices)]
    q = max(1, pad_quantum)
    n_ops = -(-max(max((len(p) for p in lane_programs), default=0), 1)
              // q) * q
    programs = np.zeros((len(lane_programs), n_ops, TENANT_COL + 1),
                        dtype=np.int32)
    for i, p in enumerate(lane_programs):
        programs[i, : len(p)] = p
    dyn = stack_dyn(dyns)
    out = eng.run_batch(eng.init_state(), programs, dyn, obs=obs)
    states, trace = out[0], out[1]
    telemetry = out[2] if obs is not None else None

    # one device->host transfer per field here; per-member report
    # slicing is then views on the host
    states = DeviceState(*[t.cpu() for t in states])
    trace = OpTrace(*[t.cpu().numpy() for t in trace])
    if sanitize:
        from repro_torch.check import assert_states
        assert_states(eng.cfg, states, dyn, where="array batch states")
    results = []
    lo = 0
    for a in arrays:
        hi = lo + a.geom.n_devices
        sl = slice(lo, hi)
        res = _decode_result(
            programs[sl],
            DeviceState(*[x[sl] for x in states]),
            OpTrace(*[x[sl] for x in trace]),
            (type(telemetry)(*[x[sl] for x in telemetry])
             if telemetry is not None else None))
        real = res.programs[:, :, 0] != zengine.OP_NOP
        bad = real & ~res.ok
        if bad.any():
            lane, idx = np.argwhere(bad)[0]
            raise AssertionError(
                f"illegal op at member {lane} index {idx}: "
                f"{res.programs[lane, idx].tolist()} -- the compiler "
                f"validated this command, so this is an engine/compiler "
                f"divergence")
        a._result = res
        a._dirty = False
        results.append(res)
        lo = hi
    return results


def run_array_timing(flash, programs: np.ndarray, cols: np.ndarray,
                     pages: np.ndarray, *, n_tenants: int, device="cuda"
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One op-granular timing pass on ``device`` with per-op page costs:
    read rows book ``t_read + t_xfer`` per page, everything else
    ``t_prog + t_xfer`` (the per-op ``t_page`` extension of
    :func:`repro_torch.core.timing.simulate_fleet_ops`).  Returns numpy
    arrays."""
    op = programs[:, :, 0]
    t_page = np.where(op == zengine.OP_READ,
                      np.float32(flash.t_read + flash.t_xfer),
                      np.float32(flash.t_prog + flash.t_xfer)
                      ).astype(np.float32)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    completions, latencies, makespans = timing.simulate_fleet_ops(
        on_device(cols), on_device(pages.astype(np.int32)),
        on_device(programs[:, :, TENANT_COL]), on_device(t_page),
        flash.n_luns, n_tenants)
    return (completions.cpu().numpy(), latencies.cpu().numpy(),
            makespans.cpu().numpy())


# --------------------------------------------------------------------- #
# differential replay + the comparator's engine leg
# --------------------------------------------------------------------- #
#: command tuples: ("write", zone, n_pages, host) / ("finish", zone) /
#: ("reset", zone) / ("read", zone, offsets) / ("fail", idx) /
#: ("rebuild", idx)
Command = tuple


def apply_commands(backend, commands: Sequence[Command]):
    """Drive an :class:`ArrayEngine` or an object :class:`ZNSArray`
    through one logical command list -- the shared differential-test /
    comparator driver (both surfaces take the same verbs)."""
    for cmd in commands:
        verb = cmd[0]
        if verb == "write":
            backend.zone_write(cmd[1], cmd[2], host=cmd[3])
        elif verb == "finish":
            backend.zone_finish(cmd[1])
        elif verb == "reset":
            backend.zone_reset(cmd[1])
        elif verb == "read":
            backend.zone_read(cmd[1], np.asarray(cmd[2], dtype=np.int64))
        elif verb == "fail":
            backend.fail_device(cmd[1])
        elif verb == "rebuild":
            backend.rebuild_device(cmd[1])
        else:
            raise ValueError(f"unknown command {cmd!r}")
    return backend


def fill_commands(zone_pages: int, *, n_zones: int, occupancy: float,
                  writes_per_zone: int = 4, churn: int = 1,
                  zone_base: int = 0) -> List[Command]:
    """A fill + FINISH (+ RESET-churn refill) logical workload -- the
    DLWA benchmark traffic, array edition."""
    per_zone = max(1, int(zone_pages * occupancy))
    step = -(-per_zone // writes_per_zone)
    cmds: List[Command] = []
    for cycle in range(max(1, churn)):
        if cycle:
            cmds += [("reset", z)
                     for z in range(zone_base, zone_base + n_zones)]
        for z in range(zone_base, zone_base + n_zones):
            left = per_zone
            while left > 0:
                take = min(step, left)
                cmds.append(("write", z, take, True))
                left -= take
            cmds.append(("finish", z))
    return cmds


def _legacy_array(flash, zone_geom, geom: ArrayGeometry,
                  member_specs: Sequence[ElementSpec], *,
                  max_active: int, oracle: bool = False,
                  device="cuda") -> ZNSArray:
    """The object pipeline: a ``ZNSArray`` over per-op ``ZNSDevice``
    shims on ``device`` (what ``ZNSArray.build`` constructs -- one engine
    step per member op), each member built with its actual spec.
    ``oracle=True`` swaps in ``LegacyZNSDevice`` members -- the
    bit-compatible numpy oracle, cheap enough to differential-check every
    array (its wear-aware ALLOCs run the ``zns_alloc`` row kernel on a
    card)."""
    if oracle:
        from repro_torch.core.device_legacy import LegacyZNSDevice as cls
    else:
        from repro_torch.core.device import ZNSDevice as cls
    devices = [cls(flash, zone_geom, s, max_active=max_active,
                   device=device)
               for s in member_specs]
    return ZNSArray(devices, geom)


def array_batch(eng: ZoneEngine, *, n_arrays: int = 8, n_zones: int = 4,
                max_active: int = 14,
                specs: Optional[Sequence[ElementSpec]] = None
                ) -> Tuple[List[ArrayEngine], List[List[Command]]]:
    """The engine leg of :func:`array_vs_legacy_speedup`: a devices x
    chunk x parity sweep of fill/FINISH/churn workloads, each array
    compiled on ``eng`` from its command list, member ``d`` of
    ``specs[d % len(specs)]`` (every member of ``eng``'s spec by
    default).  Returns the arrays and their commands;
    ``run_array_batch(arrays, pad_quantum=64)`` then runs them as the
    comparator's engine pass does."""
    specs = tuple(specs) if specs else (eng.spec,)
    seg = eng.zone_geom.segment_pages(eng.flash)
    axis = [(n_dev, chunk, parity)
            for n_dev in (4, 3)
            for chunk in (seg, seg // 2)
            for parity in (True, False)]
    arrays: List[ArrayEngine] = []
    commands: List[List[Command]] = []
    for i in range(n_arrays):
        n_dev, chunk, parity = axis[i % len(axis)]
        member_specs = tuple(specs[d % len(specs)] for d in range(n_dev))
        a = ArrayEngine(eng, ArrayGeometry(n_dev, chunk, parity),
                        member_specs=member_specs, max_active=max_active)
        occ = 0.4 + 0.2 * (i % 3)
        cmds = fill_commands(a.zone_pages, n_zones=n_zones,
                             occupancy=occ, churn=2)
        apply_commands(a, cmds)
        arrays.append(a)
        commands.append(cmds)
    return arrays, commands


def array_vs_legacy_speedup(*, n_arrays: int = 8, repeats: int = 3,
                            flash=None, zone_geom=None,
                            specs: Optional[Sequence[ElementSpec]] = None,
                            max_active: int = 14, n_zones: int = 4,
                            legacy_arrays: Optional[int] = None,
                            device="cuda") -> Dict[str, float]:
    """Time the engine-native array path against the object ``ZNSArray``
    replay, both on ``device``.

    Both paths run the *same* logical commands (:func:`array_batch`'s
    devices x chunk x parity sweep of fill/FINISH/churn workloads).  The
    engine leg compiles the commands ONCE into encoded member programs
    (``build_s``, reported separately), then each timed repeat is one
    batched ``run_array_batch`` dispatch plus the full per-array
    ``report()`` decode.  The legacy leg replays the commands through
    object arrays over per-op ``ZNSDevice`` shims; with ``legacy_arrays``
    < ``n_arrays`` it is timed once on that prefix and scaled (recorded
    in the returned fields: ``legacy_timed_arrays`` /
    ``legacy_measured_s`` / ``legacy_scale``).  Before any timing, every
    per-array report is asserted bit-identical to an object array over
    ``LegacyZNSDevice`` members (the exactness oracle), and the timed
    prefix's shim reports to the engine's.
    """
    import time

    from repro_torch.core.elements import SUPERBLOCK
    from repro_torch.core.geometry import zn540

    if (flash is None) != (zone_geom is None):
        raise ValueError("flash and zone_geom must be given together")
    if flash is None:
        flash, zone_geom = zn540()
    specs = tuple(specs) if specs else (SUPERBLOCK,)
    eng = ZoneEngine(flash, zone_geom,
                     specs if len(specs) > 1 else specs[0],
                     max_active=max_active, device=device)
    t0 = time.perf_counter()
    arrays, commands = array_batch(eng, n_arrays=n_arrays, n_zones=n_zones,
                                   max_active=max_active, specs=specs)
    build_s = time.perf_counter() - t0

    def engine_pass():
        run_array_batch(arrays, pad_quantum=64)
        return [a.report() for a in arrays]

    def legacy_pass(subset, *, oracle=False):
        reports = []
        for a, cmds in subset:
            arr = _legacy_array(flash, zone_geom, a.geom, a.member_specs,
                                max_active=max_active, oracle=oracle,
                                device=device)
            apply_commands(arr, cmds)
            reports.append(arr.report())
        return reports

    # exactness oracle (and engine warm-up): every report key of every
    # array bit-identical to the numpy object oracle before anything is
    # timed
    engine_reports = engine_pass()
    oracle_reports = legacy_pass(list(zip(arrays, commands)), oracle=True)
    for er, lr in zip(engine_reports, oracle_reports):
        assert er.keys() == lr.keys()
        for k in er:
            assert er[k] == lr[k], (
                f"engine/legacy array mismatch on {k}: "
                f"{er[k]} vs {lr[k]}")

    t0 = time.perf_counter()
    for _ in range(repeats):
        engine_pass()
    engine_s = (time.perf_counter() - t0) / repeats

    # the timed legacy leg is the object pipeline itself (ZNSArray over
    # per-op ZNSDevice shims); warmed on its prefix, timed once, scaled
    n_leg = min(legacy_arrays or n_arrays, n_arrays)
    scale = n_arrays / n_leg
    prefix = list(zip(arrays, commands))[:n_leg]
    shim_reports = legacy_pass(prefix)      # warm-up (builds, plans)
    for er, lr in zip(engine_reports, shim_reports):
        assert er == lr, "shim-member array diverged from the engine"
    t0 = time.perf_counter()
    legacy_pass(prefix)
    legacy_measured_s = time.perf_counter() - t0
    legacy_s = legacy_measured_s * scale

    lane_ops = float(sum(len(p) for a in arrays
                         for p in a.member_programs()))
    return {
        "n_arrays": float(n_arrays),
        "lane_ops": lane_ops,
        "build_s": build_s,
        "engine_s": engine_s,
        "engine_total_s": build_s / max(1, repeats) + engine_s,
        "legacy_s": legacy_s,
        "legacy_measured_s": legacy_measured_s,
        "legacy_timed_arrays": float(n_leg),
        "legacy_scale": scale,
        "speedup": legacy_s / engine_s,
    }
