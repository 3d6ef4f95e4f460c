"""Multi-tenant fleet execution over the port's ZoneEngine (the port of
``repro.fleet``, so far its runner and tenant encoding):

* :mod:`repro_torch.fleet.tenants` -- tenant-tagged width-5 op programs,
  the round-robin tenant interleaver, and the program-space RAID striper
  (same stripe math as :class:`repro_torch.array.ZNSArray`);
* :mod:`repro_torch.fleet.runner`  -- T tenants x N devices x K configs
  executed through ONE batched ``run_programs`` dispatch (heterogeneous
  per-lane geometries / allocators / element specs via ``DynConfig`` on
  a padded union config) plus op-granular fleet timing.

The allocator search (``repro.fleet.search``) and its evolutionary
strategy (``repro.fleet.evolve``) are not ported yet.
"""

from repro_torch.fleet.runner import (FleetResult, assert_all_ok,
                                      config_report, dispatch_cost,
                                      real_op_count, run_fleet)
from repro_torch.fleet.tenants import (TENANT_COL, interleave_tenants,
                                       pad_programs, stripe_program,
                                       tag_tenant)

__all__ = [
    "FleetResult", "assert_all_ok", "config_report", "dispatch_cost",
    "real_op_count", "run_fleet",
    "TENANT_COL", "interleave_tenants", "pad_programs",
    "stripe_program", "tag_tenant",
]
