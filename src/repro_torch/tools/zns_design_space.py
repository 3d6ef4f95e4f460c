"""The augmented ZNS design space on the port (paper §4/§6.3 + Table 5;
the counterpart of the reference's ``examples/zns_design_space.py``).

Sweeps zone geometry x storage element on the paper's custom 16-LUN SSD
and prints, per configuration: DLWA at low occupancy, interference under
concurrent FINISH, and allocation latency -- then echoes the paper's
per-use-case recommendations (Table 5).  Each measure runs on its own
device shim (:class:`repro_torch.core.ZNSDevice`, one engine op step a
command); the latency is the card's own, not the reference's::

    PYTHONPATH=src python -m repro_torch.tools.zns_design_space [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core import (BLOCK, FIXED, PAPER_GEOMETRIES, SUPERBLOCK,
                              ZNSDevice, custom16, hchunk, is_applicable,
                              vchunk)
from repro_torch.core.workloads import (alloc_latency_benchmark,
                                        dlwa_benchmark,
                                        interference_benchmark)

ELEMENTS = (FIXED, SUPERBLOCK, BLOCK, vchunk(2), vchunk(4), hchunk(2))

RECOMMENDATIONS = """
paper Table 5 -- how to pick a configuration:
  (A) WAL / OLTP logs           -> block/Vchunk-2, small zones, early FINISH
  (B) LSM flushes / minor comp. -> superblock/Vchunk-4, medium zones
  (C) large compactions/ingest  -> superblock/Vchunk-4, large zones
  (D) mixed-lifetime ZenFS data -> block/Vchunk-2, small zones, early FINISH
  (E) read-mostly               -> superblock/Vchunk-4, large zones
"""


def design_space(*, device="cuda", geometries: Optional[Sequence] = None,
                 elements: Optional[Sequence] = None) -> list:
    """Print the table over ``geometries`` x ``elements`` (the paper's
    six and :data:`ELEMENTS` by default); return its rows, each with the
    allocation benchmark's sample count (``n_allocs``)."""
    flash = custom16()
    print(f"{'geometry':>10} {'element':>11} {'DLWA@10%':>9} "
          f"{'interf.':>8} {'alloc us':>9}")
    rows = []
    for geom in geometries or PAPER_GEOMETRIES:
        for spec in elements or ELEMENTS:
            if not is_applicable(spec, geom, flash):
                continue
            dev = ZNSDevice(flash, geom, spec, max_active=64, device=device)
            d = dlwa_benchmark(dev, occupancy=0.10, n_zones=2)
            dev2 = ZNSDevice(flash, geom, spec, max_active=64, device=device)
            i = interference_benchmark(
                dev2, concurrency=min(4, dev2.n_zones // 2))
            dev3 = ZNSDevice(flash, geom, spec, max_active=64, device=device)
            a = alloc_latency_benchmark(dev3, n_allocs=8)
            print(f"{geom.describe(flash):>10} {spec.name:>11} "
                  f"{d['dlwa']:>9.2f} {i['interference']:>8.2f} "
                  f"{a['median_us']:>9.1f}")
            rows.append({"geometry": geom.describe(flash),
                         "element": spec.name, "dlwa": d["dlwa"],
                         "interference": i["interference"],
                         "alloc_us": a["median_us"],
                         "n_allocs": a["n_allocs"]})
    print(RECOMMENDATIONS)
    return rows


def named_geometries(names: str) -> tuple:
    """The paper geometries named as the table names them, ``;``-separated
    (``"P4,S32;P16,S256"``; spaces ignored), in the paper's order."""
    flash = custom16()
    want = {n.replace(" ", "") for n in names.split(";") if n.strip()}
    known = {g.describe(flash).replace(" ", ""): g for g in PAPER_GEOMETRIES}
    unknown = sorted(want - set(known))
    if unknown or not want:
        raise argparse.ArgumentTypeError(
            f"unknown geometries {unknown or names!r} (want some of "
            f"{';'.join(known)})")
    return tuple(g for n, g in known.items() if n in want)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--geometries", type=named_geometries, default=None,
                    help="a subset of the paper's six zone geometries, "
                         "';'-separated as the table names them (e.g. "
                         "'P4,S32;P16,S256'); all six by default")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    return design_space(device=args.device, geometries=args.geometries)


if __name__ == "__main__":
    main()
