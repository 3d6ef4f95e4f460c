"""Re-derive the analytic roofline terms of the port's dry-run JSONs
without re-running the meta step (the counterpart of the reference's
``tools/recompute_roofline.py``: the placement proof is unchanged, only
the cost model moved).

    PYTHONPATH=src python -m repro_torch.tools.recompute_roofline \\
        [--dir results/dryrun]

For each ``ok`` JSON the terms come from ``analysis.flops.cell_cost`` and
``analysis.roofline.Roofline`` on the H100's peaks with the arguments
``launch.dryrun.run_cell`` gives them (``launch.dryrun.roofline_terms``),
the microbatches the collectives were scaled by (``collective_scale``),
and the recorded ``collectives.total`` stays the collective term's floor;
``roofline``, ``analytic`` and ``analytic_detail`` are rewritten in place.
A JSON that is not ``ok`` is skipped and counted.
"""

from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path

from repro_torch.configs import get_arch, get_shape
from repro_torch.launch.dryrun import roofline_terms


def recompute(path: Path) -> bool:
    """Rewrite ``path``'s analytic terms; False where it is not ``ok``."""
    d = json.loads(path.read_text())
    if not d.get("ok"):
        return False
    d.update(roofline_terms(get_arch(d["arch"]), get_shape(d["shape"]),
                            d["mesh_shape"], d["devices"],
                            d["collective_scale"],
                            d["collectives"].get("total", 0)))
    path.write_text(json.dumps(d, indent=1, default=str))
    return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    ap.add_argument("--dir", default="results/dryrun")
    args = ap.parse_args(argv)
    paths = [Path(p) for p in sorted(glob.glob(f"{args.dir}/*.json"))]
    done = sum(recompute(p) for p in paths)
    print(f"recomputed {done} of {len(paths)} JSONs in {args.dir}; "
          f"skipped {len(paths) - done} not ok")


if __name__ == "__main__":
    main()
