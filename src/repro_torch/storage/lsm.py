"""KVBench-II-style LSM traffic generator (paper §6.1), the port of
``repro.storage.lsm``.

The paper runs KVBench [44] on RocksDB+ZenFS: 50% inserts, 10% deletes,
15% point queries, 25% updates with 512 B entries.  We model the parts
that generate *storage traffic*, including RocksDB's concurrency, which is
what pressures ZenFS's active-zone budget:

* every mutation batch appends to the WAL (lifetime 0) through a
  persistent file session;
* a full memtable enqueues a *flush job* (L0 SST, lifetime 1) and the WAL
  epoch is truncated when the flush completes;
* a level over its file budget enqueues a *compaction job* that merges it
  into the next level (dropping ``dedup_fraction`` obsolete versions) and
  splits the output into target-size files;
* updates also invalidate old versions resident in deeper levels
  (``update_overlap``), creating garbage inside live files;
* up to ``max_concurrent_jobs`` flush/compaction jobs write concurrently,
  each holding its own zone open (ZenFS: one writer per zone).

Deterministic given the seed; emits traffic into :class:`ZoneFS`.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.core.backend import set_stream_class
from repro_torch.storage.zonefs import ZoneFS


def kvbench_mix(n_ops: int, seed: int = 0) -> np.ndarray:
    """Op stream: 0=insert, 1=delete, 2=point query, 3=update (paper mix:
    50/10/15/25)."""
    rng = np.random.default_rng(seed)
    return rng.choice(4, size=n_ops, p=[0.50, 0.10, 0.15, 0.25])


@dataclasses.dataclass
class KVBenchConfig:
    n_ops: int = 4_000_000            # paper: 4M total operations
    entry_bytes: int = 512            # paper: 512 B entries
    memtable_entries: int = 131_072   # 64 MiB memtable (RocksDB default)
    size_ratio: int = 4               # level file-count growth factor
    max_levels: int = 4
    seed: int = 0
    dedup_fraction: float = 0.25      # obsolete versions dropped at merge
    update_overlap: float = 0.15      # deep-level bytes invalidated per merge
    max_concurrent_jobs: int = 4      # concurrent flush/compaction writers
    io_chunk_pages: int = 512         # pages a job writes per pump round


@dataclasses.dataclass
class _SST:
    file_id: int
    entries: int
    compacting: bool = False


@dataclasses.dataclass
class _Job:
    kind: str                                   # 'flush' | 'compact'
    outputs: List[tuple]                        # (fid, lifetime, pages, entries)
    out_idx: int = 0
    written_in_cur: int = 0
    on_complete: Optional[Callable[[], None]] = None
    started: bool = False

    def done(self) -> bool:
        return self.out_idx >= len(self.outputs)


class LSMSimulator:
    """Drives a ZoneFS with concurrent LSM-shaped file traffic."""

    def __init__(self, fs: ZoneFS, cfg: KVBenchConfig):
        self.fs = fs
        self.cfg = cfg
        self.levels: List[List[_SST]] = [[] for _ in range(cfg.max_levels)]
        self._next_file = 0
        self._memtable = 0
        self._wal_fid: Optional[int] = None
        self._epoch_wals: List[int] = []
        self.pending: Deque[_Job] = collections.deque()
        self.active: List[_Job] = []
        self.ops_run = 0
        self.failed = False
        self.wal_pages = 0
        self.flush_pages = 0
        self.compact_pages = 0

    # ------------------------------------------------------------------ #
    def _fid(self) -> int:
        self._next_file += 1
        return self._next_file

    def _pages(self, entries: int) -> int:
        page = self.fs.dev.flash.page_bytes
        return max(1, (entries * self.cfg.entry_bytes + page - 1) // page)

    # ------------------------------------------------------------------ #
    # job engine
    # ------------------------------------------------------------------ #
    def _pump(self) -> None:
        """Advance all active jobs by one IO chunk each; start pending
        jobs while slots are free."""
        while (len(self.active) < self.cfg.max_concurrent_jobs
               and self.pending):
            self.active.append(self.pending.popleft())
        still = []
        for job in self.active:
            if not self._step(job):
                self.failed = True
                continue
            if job.done():
                if job.on_complete:
                    job.on_complete()
            else:
                still.append(job)
        self.active = still

    def _step(self, job: _Job) -> bool:
        fid, lifetime, pages, _ = job.outputs[job.out_idx]
        set_stream_class(self.fs.dev, job.kind)
        if job.written_in_cur == 0:
            self.fs.begin(fid, lifetime, expected_pages=pages)
        room = pages - job.written_in_cur
        chunk = min(self.cfg.io_chunk_pages, room)
        if not self.fs.write(fid, chunk):
            self.fs.end(fid)
            return False
        if job.kind == "flush":
            self.flush_pages += chunk
        else:
            self.compact_pages += chunk
        job.written_in_cur += chunk
        if job.written_in_cur >= pages:
            self.fs.end(fid)
            job.out_idx += 1
            job.written_in_cur = 0
        return True

    def _drain(self) -> None:
        guard = 0
        while (self.active or self.pending) and not self.failed:
            self._pump()
            guard += 1
            if guard > 10_000_000:
                raise RuntimeError("LSM job engine wedged")

    # ------------------------------------------------------------------ #
    # LSM logic
    # ------------------------------------------------------------------ #
    def run(self) -> Dict[str, float]:
        cfg = self.cfg
        ops = kvbench_mix(cfg.n_ops, cfg.seed)
        mutations = int((ops != 2).sum())
        wal_batch = max(1, cfg.memtable_entries // 16)
        done = 0
        while done < mutations and not self.failed:
            batch = min(wal_batch, mutations - done)
            done += batch
            if not self._wal_append(batch):
                break
            self._memtable += batch
            if self._memtable >= cfg.memtable_entries:
                self._enqueue_flush()
            self._pump()
            self.ops_run += batch
        self._drain()
        self.fs.sa.sample()
        rep = self.fs.report()
        rep.update({
            "ops_run": float(self.ops_run),
            "wal_pages": float(self.wal_pages),
            "flush_pages": float(self.flush_pages),
            "compact_pages": float(self.compact_pages),
            "failed": float(self.failed),
        })
        return rep

    def _wal_append(self, entries: int) -> bool:
        set_stream_class(self.fs.dev, "wal")
        if self._wal_fid is None:
            self._wal_fid = self._fid()
            self._epoch_wals.append(self._wal_fid)
            self.fs.begin(self._wal_fid, lifetime=0)
        pages = self._pages(entries)
        ok = self.fs.write(self._wal_fid, pages)
        if ok:
            self.wal_pages += pages
        else:
            self.failed = True
        return ok

    def _enqueue_flush(self) -> None:
        entries = self._memtable
        self._memtable = 0
        # seal current WAL epoch
        if self._wal_fid is not None:
            self.fs.end(self._wal_fid)
            self._wal_fid = None
        epoch_wals = list(self._epoch_wals)
        self._epoch_wals = []
        fid = self._fid()
        pages = self._pages(entries)

        def complete() -> None:
            self.levels[0].append(_SST(fid, entries))
            for w in epoch_wals:
                self.fs.delete(w)
            self._maybe_compact(0)

        self.pending.append(_Job("flush", [(fid, 1, pages, entries)],
                                 on_complete=complete))

    def _maybe_compact(self, level: int) -> None:
        cfg = self.cfg
        if level >= cfg.max_levels - 1:
            return
        budget = cfg.size_ratio
        ready = [s for s in self.levels[level] if not s.compacting]
        if len(ready) < budget:
            return
        for s in ready:
            s.compacting = True
        entries = sum(s.entries for s in ready)
        merged = int(entries * (1.0 - cfg.dedup_fraction))
        # one merged output run per compaction (may span zones); deeper
        # levels therefore produce large files that pin their own zones
        outputs = [(self._fid(), 2 + level, self._pages(merged), merged)]

        def complete() -> None:
            self.levels[level] = [s for s in self.levels[level]
                                  if not s.compacting or s not in ready]
            for s in ready:
                if s in self.levels[level]:
                    self.levels[level].remove(s)
                self.fs.delete(s.file_id)
            for (fid, _, _, ents) in outputs:
                self.levels[level + 1].append(_SST(fid, ents))
            # updates invalidate old versions living deeper (garbage
            # pinned inside live files -> SA pressure)
            self._invalidate_deep(level + 1, entries)
            self._maybe_compact(level + 1)

        self.pending.append(_Job("compact", outputs, on_complete=complete))

    def _invalidate_deep(self, level: int, merged_entries: int) -> None:
        cfg = self.cfg
        victims = [s for s in self.levels[level] if not s.compacting]
        if not victims:
            return
        obsolete = int(merged_entries * cfg.update_overlap)
        per = obsolete // len(victims)
        for s in victims:
            cut = min(per, s.entries)
            if cut <= 0:
                continue
            s.entries -= cut
            self.fs.invalidate_partial(s.file_id, self._pages(cut))
