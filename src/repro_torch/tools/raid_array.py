"""ZNS-RAID on the port: one workload, one device vs an 8-device fleet
(the counterpart of the reference's ``examples/raid_array.py``).

Because ``ZoneFS`` talks to the :class:`repro_torch.core.backend.ZoneBackend`
protocol, the same LSM traffic mounts unchanged on a bare ``ZNSDevice``
or a ``ZNSArray`` with log-structured parity; the array adds degraded
reads and a batched fleet-timing path::

    PYTHONPATH=src python -m repro_torch.tools.raid_array [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.array import ZNSArray
from repro_torch.core import SUPERBLOCK, ZNSDevice, timing, zn540
from repro_torch.storage import KVBenchConfig, LSMSimulator, ZoneFS

#: the LSM workload's KVBench operations
N_OPS = 300_000


def lsm_over(backend, n_ops: int = N_OPS) -> dict:
    fs = ZoneFS(backend, finish_threshold=0.1)
    sim = LSMSimulator(fs, KVBenchConfig(n_ops=n_ops))
    return sim.run()


def raid_array(*, device="cuda", n_ops: int = N_OPS) -> dict:
    """Print the example's report; return its figures: both backends'
    LSM reports, the first four members' rollups, the degraded read's
    page reads a member, and the fleet timing's makespan and page ops."""
    flash, zone = zn540()
    out = {}

    print("same LSM workload, two backends (ZoneBackend protocol):")
    dev_rep = lsm_over(ZNSDevice(flash, zone, SUPERBLOCK, max_active=14,
                                 device=device), n_ops)
    arr = ZNSArray.build(flash, zone, SUPERBLOCK, n_devices=8,
                         parity=True, max_active=14, device=device)
    arr_rep = lsm_over(arr, n_ops)
    print(f"  1x ZNSDevice : dlwa={dev_rep['dlwa']:.3f} "
          f"sa={dev_rep['sa']:.3f}")
    print(f"  8x ZNSArray+P: dlwa={arr_rep['dlwa']:.3f} "
          f"sa={arr_rep['sa']:.3f} "
          f"(parity overhead folded into array DLWA)")
    out.update(device_lsm=dev_rep, array_lsm=arr_rep)

    print("\nper-device rollup (first 4 members):")
    out["members"] = []
    for r in arr.device_reports()[:4]:
        print(f"  dev{int(r['device'])}: dlwa={r['dlwa']:.3f} "
              f"erases={int(r['total_block_erases'])} "
              f"max_wear={int(r['max_wear'])}")
        out["members"].append(r)

    print("\ndegraded read: fail device 2, reconstruct from survivors")
    arr2 = ZNSArray.build(flash, zone, SUPERBLOCK, n_devices=4, parity=True,
                          device=device)
    arr2.zone_write(0, arr2.zone_pages)
    arr2.fail_device(2)
    reads = arr2.zone_read(0, np.arange(4 * arr2.geom.chunk_pages))
    out["degraded_reads"] = []
    for idx, tr in reads:
        print(f"  dev{idx}: {len(tr.luns)} page reads")
        out["degraded_reads"].append([int(idx), len(tr.luns)])

    print("\nfleet timing: 8 devices in one batched pass")
    arr3 = ZNSArray.build(flash, zone, SUPERBLOCK, n_devices=8, parity=True,
                          device=device)
    tagged = arr3.zone_write(0, arr3.zone_pages // 2, trace=True)
    tagged += arr3.zone_finish(0, trace=True) or []
    fleet = timing.run_fleet_trace(arr3.flash, timing.group_tagged(tagged, 8),
                                   device=device)
    print(f"  fleet makespan: {fleet['fleet_makespan_s'] * 1e3:.2f} ms "
          f"over {fleet['n']} page ops")
    out.update(fleet_makespan_s=fleet["fleet_makespan_s"],
               fleet_pages=int(fleet["n"]))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return raid_array(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
