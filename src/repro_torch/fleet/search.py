"""Allocator/geometry design-space search over batched fleet simulations
(the port of ``repro.fleet.search``).

The paper's core argument is that zone-allocation strategy (element
granularity, zone geometry, write order, mapping) drives DLWA, wear and
host interference; SilentZNS wins by searching a wider allocation design
space.  This module makes that search executable: a
:class:`FleetConfig` crosses

* **tenant mix**      -- which workload programs share the fleet
                         (:data:`MIXES`, built from the paper's
                         benchmarks in :mod:`repro_torch.core.workloads`);
* **zone geometry**   -- effective segments per zone, realized as a
                         ``DynConfig`` capacity override on the padded
                         static config (heterogeneous lanes batch
                         together);
* **element spec**    -- the zone storage-element granularity (paper
                         §4, Table 1), realized as a per-lane
                         ``DynConfig`` spec selection on a padded
                         *union* config (``ZoneEngine`` built over a
                         spec set) -- mixed-spec fleets run in ONE
                         dispatch;
* **chunk size**      -- the RAID stripe unit (pages per member turn);
* **parity**          -- log-structured RAID-5 parity on/off;
* **allocator**       -- wear-aware vs first-fit element selection;

and every config expands to ``n_devices`` lanes that execute in ONE
``run_programs`` dispatch (:func:`evaluate_configs`).  Configs are
scored on a weighted (DLWA, wear spread, p99 tenant latency) objective
(:func:`score_rows`) and the non-dominated set is reported as the
Pareto front (:func:`pareto_front`).

Grid enumeration (:func:`grid_space`) and seeded random sampling
(:func:`random_space`) are both deterministic: same seed, same configs,
same scores (tested).  Every strategy -- grid, random, and the
evolutionary/successive-halving searcher in
:mod:`repro_torch.fleet.evolve` -- scores candidates through one shared :class:`Evaluator`: a
:class:`SearchSpace` supplies the candidate codec (config <-> gene
vector), :meth:`Evaluator.evaluate` runs one batched dispatch per
candidate set (optionally at reduced *fidelity* via truncated op
programs), and :meth:`Evaluator.objective` is the fixed scalar the
adaptive strategies minimize.

Every config expands to lanes of ONE ``run_programs`` dispatch on the
engine's device: one op step per padded program row for all lanes at
once (on a card, one fused ALLOC and one grow selection launch per op
step, whatever the lane count).  The per-op legacy comparators
(:func:`run_configs_legacy` / :func:`fleet_vs_legacy_speedup`) replay the
same logical traffic through object arrays over
:class:`~repro_torch.core.device_legacy.LegacyZNSDevice` members and hold
every config's DLWA to the batched path's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import random as pyrandom
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import engine as zengine
from repro_torch.core import timing, workloads
from repro_torch.core.elements import SUPERBLOCK, ElementKind, ElementSpec
from repro_torch.core.engine import ZoneEngine, stack_dyn
from repro_torch.core.geometry import FlashGeometry, ZoneGeometry
from repro_torch.fleet import runner
from repro_torch.fleet.tenants import (interleave_tenants, pad_programs,
                                       stripe_program, tag_tenant)

#: real tenants per mix (parity appends carry the tag N_TENANTS)
N_TENANTS = 2


def _with_churn(program: np.ndarray, cycles: int = 2) -> np.ndarray:
    """Repeat a tenant program ``cycles`` times with a RESET of every
    touched zone in between -- re-allocation after RESET is what drives
    deferred erases and therefore wear (paper §5), so without churn the
    wear objective is degenerate."""
    zones = sorted({int(z) for z in program[:, 1]})
    resets = zengine.encode_program(
        [(zengine.OP_RESET, z, 0, 0) for z in zones],
        width=program.shape[1])
    parts: List[np.ndarray] = []
    for c in range(cycles):
        if c:
            parts.append(resets)
        parts.append(program)
    return np.concatenate(parts)


def _mix_dlwa_pair(eng: ZoneEngine, cap: int) -> List[np.ndarray]:
    """Two DLWA-benchmark tenants at different occupancies, disjoint
    superzones (paper Fig. 4a traffic, multi-tenant edition), cycled
    through RESET churn."""
    return [
        _with_churn(workloads.dlwa_program(
            eng, occupancy=0.35, n_zones=2, zone_base=0, zone_pages=cap)),
        _with_churn(workloads.dlwa_program(
            eng, occupancy=0.7, n_zones=2, zone_base=2, zone_pages=cap)),
    ]


def _mix_dlwa_write(eng: ZoneEngine, cap: int) -> List[np.ndarray]:
    """A DLWA (fill + FINISH) tenant next to a sequential-writer tenant
    (paper Fig. 9 jobs) -- FINISH padding interferes with host writes.
    The DLWA side churns; the writer keeps zones open."""
    return [
        _with_churn(workloads.dlwa_program(
            eng, occupancy=0.5, n_zones=2, zone_base=0, zone_pages=cap)),
        workloads.write_program(eng, request_kib=256, n_jobs=2,
                                mib_per_job=96, zone_base=2,
                                zone_pages=cap),
    ]


#: tenant-mix name -> builder(eng, logical_superzone_pages) -> programs
MIXES: Dict[str, Callable[[ZoneEngine, int], List[np.ndarray]]] = {
    "dlwa_pair": _mix_dlwa_pair,
    "dlwa_write": _mix_dlwa_write,
}

#: objective keys, all lower-is-better
OBJECTIVE_KEYS: Tuple[str, ...] = ("dlwa", "wear_cv", "p99_latency_s")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """One point of the allocator/geometry/array design space.

    ``spec`` may be a *tuple* of specs: member device ``d`` then gets
    spec ``spec[d % len(spec)]`` (a heterogeneous-member array, per-lane
    through the union config).  ``n_devices = 0`` means "the
    evaluator's default member count" -- the backward-compatible value
    every pre-array config carries.
    """

    mix: str             # tenant mix (MIXES key)
    n_segments: int      # effective segments per member zone
    chunk_pages: int     # stripe unit (pages per member turn)
    parity: bool         # log-structured RAID-5 parity
    wear_aware: bool     # allocator element selection (wear vs first-fit)
    spec: ElementSpec = SUPERBLOCK  # element granularity (or a mix tuple)
    n_devices: int = 0   # array member count (0 = evaluator default)
    alloc_policy: str = "traditional"  # zone mapping: traditional|silent

    def specs_mix(self) -> Tuple[ElementSpec, ...]:
        """The spec tuple member ``d`` indexes with ``d % len``."""
        if isinstance(self.spec, ElementSpec):
            return (self.spec,)
        return tuple(self.spec)

    def describe(self) -> str:
        mix = self.specs_mix()
        spec_name = ("+".join(s.name for s in mix) if len(mix) > 1
                     else mix[0].name)
        base = (f"{self.mix}_s{self.n_segments}_c{self.chunk_pages}"
                f"_{'p1' if self.parity else 'p0'}"
                f"_{'wa' if self.wear_aware else 'ff'}"
                f"_{spec_name}")
        if self.n_devices:
            base += f"_d{self.n_devices}"
        if self.alloc_policy != "traditional":
            base += f"_{self.alloc_policy}"
        return base


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The finite design-space axes plus the candidate *gene* codec.

    A candidate is a :class:`FleetConfig`; its gene vector is the tuple
    of per-axis indexes (one int per axis, in axis order).  The codec
    is what the evolutionary operators in :mod:`repro_torch.fleet.evolve`
    mutate/cross over, so every strategy shares one source of truth for
    which configs exist.
    """

    mixes: Tuple[str, ...] = tuple(MIXES)
    segments: Tuple[int, ...] = (22, 11)
    chunks: Tuple[int, ...] = (1536, 3072)
    parities: Tuple[bool, ...] = (False, True)
    wear: Tuple[bool, ...] = (True, False)
    specs: Tuple = (SUPERBLOCK,)   # each entry: a spec, or a mix tuple
    devices: Tuple[int, ...] = (0,)  # member counts (0 = default)
    policies: Tuple[str, ...] = ("traditional",)  # alloc_policy values

    @property
    def _axes_fields(self) -> Tuple[Tuple[Tuple, str], ...]:
        # the devices / policies axes join the codec only when the
        # space declares values to search: a default space keeps its
        # 6-gene vectors, so seeded sampling/evolve trajectories from
        # before those axes stay bit-identical.  Genes map to configs
        # by *field name* (not position): with policies present but
        # devices absent, a positional FleetConfig(*vals) would land
        # the policy in n_devices.
        base = [(self.mixes, "mix"), (self.segments, "n_segments"),
                (self.chunks, "chunk_pages"), (self.parities, "parity"),
                (self.wear, "wear_aware"), (self.specs, "spec")]
        if self.devices != (0,):
            base.append((self.devices, "n_devices"))
        if self.policies != ("traditional",):
            base.append((self.policies, "alloc_policy"))
        return tuple(base)

    @property
    def axes(self) -> Tuple[Tuple, ...]:
        return tuple(a for a, _ in self._axes_fields)

    def __len__(self) -> int:
        return math.prod(len(a) for a in self.axes)

    def decode(self, genes: Sequence[int]) -> FleetConfig:
        """Per-axis index vector -> config (indexes taken modulo each
        axis length, so any int vector decodes)."""
        return FleetConfig(**{
            f: axis[g % len(axis)]
            for (axis, f), g in zip(self._axes_fields, genes)})

    def encode(self, fc: FleetConfig) -> Tuple[int, ...]:
        """Config -> per-axis index vector (raises if off the axes)."""
        if fc.n_devices and self.devices == (0,):
            raise ValueError(
                f"{fc.describe()}: config sets n_devices but this space "
                f"has no devices axis")
        if (fc.alloc_policy != "traditional"
                and self.policies == ("traditional",)):
            raise ValueError(
                f"{fc.describe()}: config sets alloc_policy "
                f"{fc.alloc_policy!r} but this space has no policies "
                f"axis")
        return tuple(axis.index(getattr(fc, f))
                     for axis, f in self._axes_fields)

    def grid(self) -> List[FleetConfig]:
        """Full cross product, axis-major order."""
        fields = [f for _, f in self._axes_fields]
        return [FleetConfig(**dict(zip(fields, vals)))
                for vals in itertools.product(*self.axes)]

    def sample_genes(self, rng: pyrandom.Random) -> Tuple[int, ...]:
        """One uniform gene vector from a seeded ``random.Random``."""
        return tuple(rng.randrange(len(a)) for a in self.axes)


def grid_space(*, mixes: Sequence[str] = tuple(MIXES),
               segments: Sequence[int] = (22, 11),
               chunks: Sequence[int] = (1536, 3072),
               parities: Sequence[bool] = (False, True),
               wear: Sequence[bool] = (True, False),
               specs: Sequence = (SUPERBLOCK,),
               devices: Sequence[int] = (0,),
               policies: Sequence[str] = ("traditional",)
               ) -> List[FleetConfig]:
    """Full cross product (defaults: 2*2*2*2*2 = 32 configs on zn540)."""
    return SearchSpace(tuple(mixes), tuple(segments), tuple(chunks),
                       tuple(parities), tuple(wear), tuple(specs),
                       tuple(devices), tuple(policies)).grid()


def random_space(seed: int, n: int, *,
                 mixes: Sequence[str] = tuple(MIXES),
                 segments: Sequence[int] = (22, 11),
                 chunks: Sequence[int] = (1536, 3072),
                 parities: Sequence[bool] = (False, True),
                 wear: Sequence[bool] = (True, False),
                 specs: Sequence = (SUPERBLOCK,),
                 devices: Sequence[int] = (0,),
                 policies: Sequence[str] = ("traditional",)
                 ) -> List[FleetConfig]:
    """``n`` distinct configs sampled without replacement from the grid
    by a seeded PRNG -- deterministic under a fixed seed (tested)."""
    grid = grid_space(mixes=mixes, segments=segments, chunks=chunks,
                      parities=parities, wear=wear, specs=specs,
                      devices=devices, policies=policies)
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(grid), size=min(n, len(grid)), replace=False)
    return [grid[i] for i in idx]


def _nd_max(configs: Sequence[FleetConfig], default: int) -> int:
    """Lanes per config in the rectangular batch: the widest member
    count in the set (``n_devices = 0`` falls back to ``default``)."""
    return max((fc.n_devices or default for fc in configs),
               default=default)


def build_fleet_batch(eng: ZoneEngine, configs: Sequence[FleetConfig],
                      *, n_devices: int, fidelity: float = 1.0,
                      pad_quantum: int = 1
                      ) -> Tuple[np.ndarray, object, List[np.ndarray]]:
    """Expand configs to the rectangular lane batch of one dispatch.

    Returns ``(programs (K*nd_max, n_ops, 5), dyn with (K*nd_max,)
    leaves, merged logical programs per config)``, where ``nd_max`` is
    :func:`_nd_max` -- a config whose ``n_devices`` is below the widest
    member count in the set gets inert all-NOP pad lanes (configs with
    mixed array sizes still batch into ONE rectangular dispatch).  The
    merged logical program of config ``k`` (tenants interleaved,
    superzone-addressed, pre-striping) is what a per-op comparator
    replays through a real ``ZNSArray`` -- both paths execute identical
    logical traffic.

    ``fidelity`` < 1 truncates each merged logical program to its first
    ``ceil(fidelity * n_rows)`` rows *before* striping -- the low-cost
    rung evaluation of the successive-halving searcher.  A prefix of a
    legal program is legal, so truncated lanes still pass
    ``assert_all_ok``; their metrics are comparable only within the
    same fidelity.

    ``pad_quantum`` rounds the padded op axis up to a multiple (NOP
    rows are inert), so repeated same-size batches run the same op-step
    count -- see :class:`Evaluator`.
    """
    if not 0.0 < fidelity <= 1.0:
        raise ValueError(f"fidelity must be in (0, 1], got {fidelity}")
    if eng.cfg.kind is ElementKind.FIXED:
        raise ValueError("FIXED elements span the whole static zone and "
                         "cannot take an effective-capacity override")
    seg_pages = eng.zone_geom.parallelism * eng.flash.pages_per_block
    nd_max = _nd_max(configs, n_devices)
    lane_programs: List[np.ndarray] = []
    dyns = []
    merged_per_config: List[np.ndarray] = []
    for fc in configs:
        if fc.n_segments > eng.zone_geom.n_segments:
            raise ValueError(f"{fc}: n_segments exceeds the static "
                             f"geometry ({eng.zone_geom.n_segments})")
        specs_mix = fc.specs_mix()
        for s in specs_mix:
            if s not in eng.members:
                raise ValueError(
                    f"{fc}: spec {s.name} is not a member of the "
                    f"engine's config (members: "
                    f"{[m.name for m in eng.members]}); build the engine "
                    f"over the search space's spec set")
        nd = fc.n_devices or n_devices
        member_zp = seg_pages * fc.n_segments
        n_data = nd - (1 if fc.parity else 0)
        cap = n_data * member_zp
        tenant_progs = MIXES[fc.mix](eng, cap)
        merged = interleave_tenants(
            [tag_tenant(p, t) for t, p in enumerate(tenant_progs)])
        if fidelity < 1.0:
            merged = merged[: max(1, math.ceil(fidelity * len(merged)))]
        merged_per_config.append(merged)
        lane_programs += stripe_program(
            merged, n_devices=nd, chunk_pages=fc.chunk_pages,
            parity=fc.parity, member_zone_pages=member_zp,
            parity_tenant=N_TENANTS)
        dyns += [eng.dyn(spec=specs_mix[d % len(specs_mix)],
                         zone_pages=member_zp,
                         wear_aware=fc.wear_aware,
                         alloc_policy=fc.alloc_policy)
                 for d in range(nd)]
        # inert pad lanes square up a mixed-member-count batch
        lane_programs += [np.zeros((0, 5), dtype=np.int32)] * (nd_max - nd)
        dyns += [eng.dyn()] * (nd_max - nd)
    q = max(1, pad_quantum)
    n_ops = -(-max((len(p) for p in lane_programs), default=0) // q) * q
    return (pad_programs(lane_programs, n_ops=n_ops), stack_dyn(dyns),
            merged_per_config)


class Evaluator:
    """The one batched scorer every search strategy dispatches through.

    Grid/random enumeration, and the evolutionary/successive-halving
    searcher in :mod:`repro_torch.fleet.evolve`, all share this object: it
    owns candidate expansion (:func:`build_fleet_batch`), the batched
    execution + per-config rollups, the fixed scalar objective, and the
    budget ledger.  One :meth:`evaluate` call is one *dispatch*: one
    batched ``run_programs`` + one batched timing pass, whatever the
    candidate count or fidelity.

    Budget ledger (cumulative, read by benchmarks/tests):

    * ``n_dispatches`` -- :meth:`evaluate` calls issued;
    * ``n_evals``      -- full-fidelity-equivalent config evaluations
      (a config at fidelity ``f`` costs ``f``), the unit the
      dispatches-to-target comparison in ``BENCH_fleet.json`` uses;
    * ``lane_ops``     -- scanned ``(lane, op)`` cells actually
      dispatched (lanes x padded program length), the raw compute
      proxy.

    ``pad_quantum`` rounds every dispatch's op axis up to a multiple,
    as the reference does (its compiled ``run_programs`` is shaped by
    the op axis), so repeated same-size candidate sets (evolve
    generations, halving rungs) run the same padded programs.

    Observability (``repro_torch.obs``): ``profiler`` threads
    per-section counters (``evaluator.build`` / the ``fleet.*`` sections
    of :func:`runner.run_fleet`) through every dispatch, and
    ``recompiles`` watches the launch plans the kernels keep per
    argument signature behind the dispatch surface -- :meth:`jit_cache`
    readings staying flat across repeated generations is the
    shape-stability property (asserted in ``tests/test_torch_obs.py``,
    recorded per generation by ``repro_torch.fleet.evolve`` when a
    profiler is attached).
    """

    def __init__(self, eng: ZoneEngine, *, n_devices: int = 4,
                 weights: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                 check_legal: bool = True, pad_quantum: int = 64,
                 profiler=None, sanitize: bool = False):
        from repro_torch.obs.profile import RecompileCounter
        self.eng = eng
        self.n_devices = n_devices
        self.weights = tuple(weights)
        self.check_legal = check_legal
        # opt-in repro_torch.check device-state audit after every
        # dispatch (host-side numpy on fetched values)
        self.sanitize = sanitize
        self.pad_quantum = max(1, pad_quantum)
        self.profiler = profiler
        self.recompiles = RecompileCounter(
            run_programs=zengine.run_programs,
            simulate_fleet_ops=timing.simulate_fleet_ops)
        self.n_dispatches = 0
        self.n_evals = 0.0
        self.lane_ops = 0

    def jit_cache(self) -> Dict[str, int]:
        """Launch-plan entry counts of the dispatch surface (one entry
        per argument signature its kernels have seen)."""
        return self.recompiles.counts()

    def evaluate(self, configs: Sequence[FleetConfig], *,
                 fidelity: float = 1.0) -> List[Dict]:
        """Score ``configs`` in ONE batched dispatch; one metrics row
        per config (see :func:`repro_torch.fleet.runner.config_report`),
        each stamped with ``fidelity``.  An empty candidate set returns
        ``[]`` without dispatching anything or touching the budget
        ledger (an empty dispatch used to count, skewing the halving
        decisions adaptive strategies read off ``n_dispatches``)."""
        if not configs:
            return []
        sec = (self.profiler.section if self.profiler is not None
               else (lambda _name: contextlib.nullcontext()))
        with sec("evaluator.build"):
            programs, dyn, _ = build_fleet_batch(
                self.eng, configs, n_devices=self.n_devices,
                fidelity=fidelity, pad_quantum=self.pad_quantum)
        res = runner.run_fleet(self.eng, programs, dyn=dyn,
                               n_tenants=N_TENANTS,
                               profiler=self.profiler)
        if self.check_legal:
            runner.assert_all_ok(res)
        if self.sanitize:
            from repro_torch.check import assert_states
            assert_states(self.eng.cfg, res.states, dyn,
                          where="Evaluator dispatch states")
        self.n_dispatches += 1
        self.n_evals += fidelity * len(configs)
        self.lane_ops += runner.dispatch_cost(res)
        nd_max = _nd_max(configs, self.n_devices)
        rows = []
        for k, fc in enumerate(configs):
            nd = fc.n_devices or self.n_devices
            # pad lanes (all-NOP) of a narrower config are excluded:
            # they would dilute the per-config rollup with empty lanes
            lanes = np.arange(k * nd_max, k * nd_max + nd)
            specs_mix = fc.specs_mix()
            row: Dict = {
                "config": fc.describe(),
                "mix": fc.mix,
                "n_segments": fc.n_segments,
                "chunk_pages": fc.chunk_pages,
                "parity": float(fc.parity),
                "wear_aware": float(fc.wear_aware),
                "spec": "+".join(s.name for s in specs_mix),
                "n_devices": float(nd),
                "alloc_policy": fc.alloc_policy,
                "fidelity": float(fidelity),
            }
            row.update(runner.config_report(res, self.eng, lanes))
            rows.append(row)
        return rows

    def objective(self, row: Dict) -> float:
        """Fixed weighted sum of the raw objectives (lower = better).

        Unlike :func:`score_rows` (which min-max-normalizes *within* a
        batch), this scalar is comparable across dispatches and
        generations -- the quantity adaptive strategies minimize and
        the monotone best-so-far curve is measured on.  Comparable only
        between rows of equal ``fidelity``.
        """
        return float(sum(w * row[k]
                         for k, w in zip(OBJECTIVE_KEYS, self.weights)))

    def ledger(self) -> Dict[str, float]:
        """The budget counters as a plain dict (for artifacts)."""
        return {"n_dispatches": float(self.n_dispatches),
                "n_evals": float(self.n_evals),
                "lane_ops": float(self.lane_ops)}


def evaluate_configs(eng: ZoneEngine, configs: Sequence[FleetConfig], *,
                     n_devices: int = 4,
                     check_legal: bool = True) -> List[Dict]:
    """Score every config in ONE batched engine dispatch + ONE batched
    timing pass (a single-shot :class:`Evaluator`)."""
    return Evaluator(eng, n_devices=n_devices,
                     check_legal=check_legal).evaluate(configs)


def score_rows(rows: List[Dict],
               weights: Tuple[float, float, float] = (1.0, 1.0, 1.0)
               ) -> List[Dict]:
    """Weighted sum of min-max-normalized objectives (lower = better);
    (re)sets ``score`` in place and returns the rows sorted best-first
    (re-scoring with different weights replaces, never accumulates)."""
    for r in rows:
        r["score"] = 0.0
    for key, w in zip(OBJECTIVE_KEYS, weights):
        vals = np.asarray([r[key] for r in rows], dtype=np.float64)
        span = vals.max() - vals.min()
        norm = (vals - vals.min()) / span if span > 0 else vals * 0.0
        for r, v in zip(rows, norm):
            r["score"] += float(w * v)
    return sorted(rows, key=lambda r: r["score"])


def pareto_front(rows: List[Dict],
                 keys: Sequence[str] = OBJECTIVE_KEYS) -> List[Dict]:
    """Non-dominated rows (no other row is <= on every key and < on
    one); flags every row with ``pareto`` in place and returns the
    front."""
    vals = np.asarray([[r[k] for k in keys] for r in rows],
                      dtype=np.float64)
    front = []
    for i, r in enumerate(rows):
        dominated = np.any(
            np.all(vals <= vals[i], axis=1)
            & np.any(vals < vals[i], axis=1))
        r["pareto"] = float(not dominated)
        if not dominated:
            front.append(r)
    return front


# --------------------------------------------------------------------- #
# per-op legacy comparator (the speedup baseline of the batched sweep)
# --------------------------------------------------------------------- #
def run_configs_legacy(flash: FlashGeometry, spec: ElementSpec,
                       configs: Sequence[FleetConfig],
                       merged_programs: Sequence[np.ndarray], *,
                       parallelism: int, n_devices: int = 4,
                       max_active: int = 14,
                       fleet_timing: bool = False,
                       device="cuda") -> List[Dict]:
    """Evaluate each config the pre-fleet way: replay its merged logical
    program through a real :class:`repro_torch.array.ZNSArray` over per-op
    ``LegacyZNSDevice`` members on ``device``.  Each config gets devices
    built with its *actual* (non-padded) zone geometry **and element
    spec** (``fc.spec``; the ``spec`` argument is only the engine's
    primary and is superseded per config), so this doubles as a semantic
    cross-check: array DLWA must match the batched engine path exactly
    -- including mixed-spec batches through a union config.
    ``alloc_policy = "silent"`` configs replay here too: which blocks a
    zone claims never changes which pages FINISH pads (pads depend only
    on the write pointer and the spec's stripe map), so silent lanes are
    DLWA-identical to the legacy device at the same spec (wear totals are
    where the policies diverge, and those are not replayed).

    With ``fleet_timing`` the replay also collects the page-granular IO
    traces and runs :func:`repro_torch.core.timing.run_fleet_trace` per
    config on ``device`` (one ``page_clock`` launch a config on a
    card)."""
    from repro_torch.array import ArrayGeometry, ZNSArray
    from repro_torch.core.device_legacy import LegacyZNSDevice

    out = []
    for fc, merged in zip(configs, merged_programs):
        geom = ZoneGeometry(parallelism=parallelism,
                            n_segments=fc.n_segments)
        nd = fc.n_devices or n_devices
        specs_mix = fc.specs_mix()
        devices = [LegacyZNSDevice(flash, geom,
                                   specs_mix[d % len(specs_mix)],
                                   max_active=max_active,
                                   wear_aware=fc.wear_aware, device=device)
                   for d in range(nd)]
        arr = ZNSArray(devices, ArrayGeometry(
            nd, fc.chunk_pages, fc.parity))
        tagged: List = []
        for row in merged:
            op, zone, n_pages = int(row[0]), int(row[1]), int(row[2])
            if op == zengine.OP_WRITE:
                tr = arr.zone_write(zone, n_pages,
                                    host=bool(row[3] & zengine.F_HOST),
                                    trace=fleet_timing)
                tagged += tr or []
            elif op == zengine.OP_FINISH:
                tagged += arr.zone_finish(zone, trace=fleet_timing) or []
            elif op == zengine.OP_RESET:
                arr.zone_reset(zone)
        rep = arr.report()
        rep["config"] = fc.describe()
        # pooled over all members' blocks, the same statistic as
        # runner.config_report (block wear repeats element wear
        # blocks_per_element times, which leaves the CV unchanged)
        w = np.concatenate([d.block_wear() for d in arr.devices])
        rep["wear_cv"] = float(w.std() / w.mean()) if w.mean() > 0 else 0.0
        if fleet_timing:
            fleet = timing.run_fleet_trace(
                arr.flash, timing.group_tagged(tagged, nd), device=device)
            rep["makespan_s"] = fleet["fleet_makespan_s"]
            rep["fleet_pages"] = float(fleet["n"])
        out.append(rep)
    return out


def fleet_vs_legacy_speedup(*, n_devices: int = 4,
                            configs: Optional[Sequence[FleetConfig]] = None,
                            repeats: int = 3,
                            flash: Optional[FlashGeometry] = None,
                            zone_geom: Optional[ZoneGeometry] = None,
                            max_active: int = 14,
                            specs: Optional[Sequence[ElementSpec]] = None,
                            legacy_configs: Optional[int] = None,
                            device="cuda") -> Dict[str, float]:
    """Time the batched fleet sweep against the per-op legacy pipeline,
    both on ``device``.

    Both paths evaluate the *same* configs on the *same* logical
    traffic (the merged tenant programs), end to end:

    * **engine** -- :func:`evaluate_configs`: ONE ``run_programs``
      dispatch over all (config x device) lanes + ONE batched
      op-granular timing pass;
    * **legacy** -- :func:`run_configs_legacy` with ``fleet_timing``:
      per config, a real ``ZNSArray`` over stateful-Python members,
      page-granular trace collection, and a ``run_fleet_trace`` device
      simulation.

    Steady state (first builds and launch plans excluded via one warm
    pass); array-level DLWA is asserted identical between the paths for
    EVERY config before anything is timed.  Also reports the replay-only
    legacy time (``legacy_replay_s``, no trace/timing), which separates
    the state machine's cost from the page-granular timing's.  With
    ``specs`` (a spec set) the engine is the padded *union* config and
    the configs may mix element specs per lane -- the legacy path then
    builds each config's members with its actual spec, making the DLWA
    assert an exactness oracle for the mixed-spec dispatch.

    ``legacy_configs`` (< the config count) times the legacy legs on
    only that config prefix, once, and linearly scales the measurement
    (the per-op pipeline is per-config sequential, so its cost is linear
    in the config count).  The scaling is recorded in the returned dict:
    ``legacy_timed_configs``, the measured times (``legacy_measured_s`` /
    ``legacy_replay_measured_s``) and ``legacy_scale``.
    """
    import time

    from repro_torch.core.geometry import zn540

    if (flash is None) != (zone_geom is None):
        raise ValueError("flash and zone_geom must be given together")
    if flash is None:
        flash, zone_geom = zn540()
    specs = tuple(specs) if specs else (SUPERBLOCK,)
    eng = ZoneEngine(flash, zone_geom,
                     specs if len(specs) > 1 else specs[0],
                     max_active=max_active, device=device)
    if configs is None:
        configs = grid_space(specs=specs)
    programs, dyn, merged = build_fleet_batch(eng, configs,
                                              n_devices=n_devices)
    n_ops = int((programs[:, :, 0] != zengine.OP_NOP).sum())

    def engine_pass():
        return evaluate_configs(eng, configs, n_devices=n_devices)

    def legacy_pass(fleet_timing=True, n=None):
        return run_configs_legacy(
            flash, specs[0], configs[:n], merged[:n],
            parallelism=zone_geom.parallelism, n_devices=n_devices,
            max_active=max_active, fleet_timing=fleet_timing,
            device=device)

    rows = engine_pass()      # warm both paths
    legacy = legacy_pass()    # EVERY config: the exactness oracle
    for r, l in zip(rows, legacy):
        assert abs(r["dlwa"] - l["dlwa"]) < 1e-9, (
            f"engine/legacy DLWA mismatch on {r['config']}: "
            f"{r['dlwa']} vs {l['dlwa']}")

    def timed(fn, reps=repeats):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps

    n_leg = min(legacy_configs or len(configs), len(configs))
    scale = len(configs) / n_leg
    leg_reps = repeats if n_leg == len(configs) else 1
    t_eng = timed(engine_pass)
    t_leg_measured = timed(lambda: legacy_pass(n=n_leg), leg_reps)
    t_leg_replay_measured = timed(
        lambda: legacy_pass(fleet_timing=False, n=n_leg), leg_reps)
    t_leg = t_leg_measured * scale
    t_leg_replay = t_leg_replay_measured * scale
    return {
        "n_configs": float(len(configs)),
        "n_devices": float(n_devices),
        "fleet_ops": float(n_ops),
        "legacy_s": t_leg,
        "legacy_replay_s": t_leg_replay,
        "legacy_measured_s": t_leg_measured,
        "legacy_replay_measured_s": t_leg_replay_measured,
        "legacy_timed_configs": float(n_leg),
        "legacy_scale": scale,
        "engine_s": t_eng,
        "legacy_configs_s": len(configs) / t_leg,
        "engine_configs_s": len(configs) / t_eng,
        "speedup": t_leg / t_eng,
        "replay_speedup": t_leg_replay / t_eng,
    }
