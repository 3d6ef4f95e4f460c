"""Quickstart on the port: the paper's headline result (the counterpart
of the reference's ``examples/quickstart.py``).

Builds the emulated WD ZN540, fills zones to varying occupancy, FINISHes
them, and compares device-level write amplification between the
fixed-zone baseline (ConfZNS++) and SilentZNS superblock allocation,
through the device shim (:class:`repro_torch.core.ZNSDevice`, one engine
op step a command)::

    PYTHONPATH=src python -m repro_torch.tools.quickstart [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from repro_torch.core import FIXED, SUPERBLOCK, ZNSDevice, zn540
from repro_torch.core.workloads import dlwa_benchmark

OCCUPANCIES = (0.1, 0.25, 0.5, 0.75, 0.9)


def main(argv=None) -> list:
    """Print the table; return its rows (occupancy, the two DLWAs and
    the reduction)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = ap.parse_args(argv).device
    flash, zone = zn540()
    print(f"device: {flash.n_luns} LUNs, "
          f"{zone.zone_bytes(flash) / 2**20:.0f} MiB zones\n")
    print(f"{'occupancy':>10} {'baseline DLWA':>14} {'SilentZNS DLWA':>15} "
          f"{'reduction':>10}")
    rows = []
    for occ in OCCUPANCIES:
        base = ZNSDevice(flash, zone, FIXED, device=device)
        silent = ZNSDevice(flash, zone, SUPERBLOCK, device=device)
        rb = dlwa_benchmark(base, occupancy=occ, n_zones=4)
        rs = dlwa_benchmark(silent, occupancy=occ, n_zones=4)
        red = (rb["dlwa"] - rs["dlwa"]) / rb["dlwa"]
        print(f"{occ:>10.0%} {rb['dlwa']:>14.2f} {rs['dlwa']:>15.2f} "
              f"{red:>10.1%}")
        rows.append({"occupancy": occ, "baseline_dlwa": rb["dlwa"],
                     "silentzns_dlwa": rs["dlwa"], "reduction": red})
    print("\npaper §6.2: 'reducing DLWA by up to 86.36% (10% zone "
          "occupancy with the superblock configuration)'")
    return rows


if __name__ == "__main__":
    main()
