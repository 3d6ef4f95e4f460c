"""Framework-level benchmark on the port: checkpoint traffic through the
zoned store (the counterpart of the reference's
``benchmarks/ckpt_zns.py``).

For each architecture, model six checkpoint epochs: params (+ optimizer
state) sharded to a host's share, written as ~1 GiB files with lifetime
hints, the oldest checkpoint rotated out.  Reports DLWA and dummy pages
under baseline (FIXED) vs SilentZNS (SUPERBLOCK) devices.  Each arch's
epochs are recorded on a :class:`~repro_torch.storage.compile.RecordingBackend`
and every spec replays one lane an arch in one dispatch on ``device``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.configs import get_arch, list_archs
from repro_torch.core import FIXED, SUPERBLOCK, workloads, zn540
from repro_torch.models import model as MDL
from repro_torch.storage import ZoneFS, lane_metrics, replay_recorders
from repro_torch.tools.paper_figures import (RunFacts, recorder,
                                             same_programs)

#: bytes per host: a 256-chip pod, params+opt sharded -> per-host share.
HOSTS = 64
SPECS = (("baseline", FIXED), ("silentzns", SUPERBLOCK))


def record_checkpoints(fs: ZoneFS, n_params: int, *, keep: int = 2,
                       epochs: int = 6) -> None:
    """The reference's checkpoint epochs over ``fs``: each epoch writes
    the host's share in ~1 GiB shard files (stopping where the device
    is full), deleting the epoch ``keep`` back."""
    page_bytes = fs.dev.flash.page_bytes
    ckpt_bytes_per_host = n_params * (2 + 8) / HOSTS   # bf16 + f32 mu/nu
    pages = max(1, int(ckpt_bytes_per_host // page_bytes))
    # shard files ~1 GiB each (object-store style)
    shard_pages = max(1, (2**30) // page_bytes)
    fid = 0
    live = []
    for _ in range(epochs):
        shards = []
        rem = pages
        while rem > 0:
            fid += 1
            n = min(shard_pages, rem)
            if not fs.create(fid, n, lifetime=2):
                break
            shards.append(fid)
            rem -= n
        live.append(shards)
        if len(live) > keep:
            for old in live.pop(0):
                fs.delete(old)


def _rows(archs, *, keep: int, epochs: int, device, run: RunFacts
          ) -> List[Dict]:
    flash, zone = zn540()
    engines = {name: run.watch(workloads.make_engine(
        flash, zone, spec, max_active=14, device=device))
        for name, spec in SPECS}
    rows, recs = [], {name: [] for name, _ in SPECS}
    for arch in archs:
        n_params = MDL.param_count(get_arch(arch))
        rows.append({"arch": arch,
                     "ckpt_gib_per_host": n_params * (2 + 8) / HOSTS
                     / 2**30})
        for name, _ in SPECS:
            rec = recorder(engines[name])
            record_checkpoints(ZoneFS(rec, finish_threshold=0.1),
                               n_params, keep=keep, epochs=epochs)
            recs[name].append(rec)
        same_programs([recs[name][-1] for name, _ in SPECS],
                      f"ckpt {arch}")
    for name, _ in SPECS:
        eng = engines[name]
        res = replay_recorders(eng, recs[name], check=True)
        for k, row in enumerate(rows):
            m = lane_metrics(eng, res, k)
            row[f"{name}_dlwa"] = m["dlwa"]
            row[f"{name}_dummy_pages"] = m["dummy_pages"]
    for row in rows:
        row["dlwa_reduction"] = 1 - (row["silentzns_dlwa"]
                                     / max(1e-9, row["baseline_dlwa"]))
    return rows


def checkpoint_traffic(arch: str, *, keep: int = 2, epochs: int = 6,
                       device="cuda") -> Dict:
    """One arch's checkpoint epochs, each spec's lane replayed alone."""
    run = RunFacts(device)
    row = _rows((arch,), keep=keep, epochs=epochs, device=device,
                run=run)[0]
    return run.close(row)


def run_all(*, device="cuda") -> Dict:
    """Every arch of ``configs.list_archs()``, one lane an arch in each
    spec's dispatch."""
    run = RunFacts(device)
    rows = _rows(list_archs(), keep=2, epochs=6, device=device, run=run)
    return run.close({
        "rows": rows,
        "mean_dlwa_reduction": float(np.mean(
            [r["dlwa_reduction"] for r in rows])),
        "worst_baseline_dlwa": max(r["baseline_dlwa"] for r in rows),
    })
