"""Multi-tenant fleet simulation + allocator search over the port's
ZoneEngine (the port of ``repro.fleet``):

* :mod:`repro_torch.fleet.tenants` -- tenant-tagged width-5 op programs,
  the round-robin tenant interleaver, and the program-space RAID striper
  (same stripe math as :class:`repro_torch.array.ZNSArray`);
* :mod:`repro_torch.fleet.runner`  -- T tenants x N devices x K configs
  executed through ONE batched ``run_programs`` dispatch (heterogeneous
  per-lane geometries / allocators / element specs via ``DynConfig`` on
  a padded union config) plus op-granular fleet timing;
* :mod:`repro_torch.fleet.search`  -- the :class:`SearchSpace` candidate
  codec and the shared batched :class:`Evaluator` (one dispatch per
  candidate set, fidelity-truncated programs, budget ledger), plus
  grid/random enumeration over (tenant mix, zone geometry, chunk size,
  parity, wear-awareness, element spec) scored on a weighted (DLWA,
  wear spread, p99 tenant latency) objective, with the Pareto front of
  non-dominated configs;
* :mod:`repro_torch.fleet.evolve`  -- the adaptive strategy: evolutionary
  proposals (mutation/crossover on the gene vector) with a
  successive-halving rung schedule, a persistent cross-generation
  Pareto archive, and seeded determinism.

:func:`run_configs_legacy` / :func:`fleet_vs_legacy_speedup` replay the
same configs through object arrays over per-op
:class:`~repro_torch.core.device_legacy.LegacyZNSDevice` members: the
DLWA oracle and the speedup baseline of the batched sweep.
"""

from repro_torch.fleet.evolve import (EvolveParams, EvolveResult, evolve,
                                      evolve_vs_random)
from repro_torch.fleet.runner import (FleetResult, assert_all_ok,
                                      config_report, dispatch_cost,
                                      real_op_count, run_fleet)
from repro_torch.fleet.search import (MIXES, N_TENANTS, OBJECTIVE_KEYS,
                                      Evaluator, FleetConfig, SearchSpace,
                                      build_fleet_batch, evaluate_configs,
                                      fleet_vs_legacy_speedup, grid_space,
                                      pareto_front, random_space,
                                      run_configs_legacy, score_rows)
from repro_torch.fleet.tenants import (TENANT_COL, interleave_tenants,
                                       pad_programs, stripe_program,
                                       tag_tenant)

__all__ = [
    "EvolveParams", "EvolveResult", "evolve", "evolve_vs_random",
    "FleetResult", "assert_all_ok", "config_report", "dispatch_cost",
    "real_op_count", "run_fleet",
    "MIXES", "N_TENANTS", "OBJECTIVE_KEYS", "Evaluator", "FleetConfig",
    "SearchSpace", "build_fleet_batch", "evaluate_configs",
    "fleet_vs_legacy_speedup", "grid_space", "pareto_front",
    "random_space", "run_configs_legacy", "score_rows",
    "TENANT_COL", "interleave_tenants", "pad_programs",
    "stripe_program", "tag_tenant",
]
