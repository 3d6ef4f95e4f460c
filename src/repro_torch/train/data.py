"""Deterministic, sharded, skip-ahead data pipeline (the port of
``repro.train.data``: numpy only, the same streams bit for bit).

Fault-tolerance contract: a loader's state is exactly ``(seed, step)`` --
``batch_at(step)`` is a pure function, so restarting from a checkpoint at
step k replays the identical stream with zero drift, and elastic restarts
(different host count) re-shard deterministically by host id.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np



@dataclasses.dataclass
class SyntheticLM:
    """Zipf-ish synthetic token stream (content-free but shaped like text)."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        if self.batch % self.n_hosts:
            raise ValueError("global batch must divide host count")
        local = self.batch // self.n_hosts
        rng = np.random.default_rng(
            (self.seed, step, self.host_id))
        # zipf-flavored marginal over the vocab
        z = rng.zipf(1.3, size=(local, self.seq + 1))
        tokens = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class MemmapLM:
    """Memory-mapped token-file dataset with deterministic skip-ahead.

    The file is a flat int32 token array; batch b at step s reads
    deterministic offsets derived from (seed, step, host) so restarts and
    elastic re-shards replay exactly.
    """

    path: str
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        if len(self._data) < self.seq + 2:
            raise ValueError("dataset smaller than one sequence")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        local = self.batch // self.n_hosts
        rng = np.random.default_rng((self.seed, step, self.host_id))
        max_start = len(self._data) - self.seq - 1
        starts = rng.integers(0, max_start, size=local)
        toks = np.stack([np.asarray(self._data[s: s + self.seq + 1])
                         for s in starts])
        toks = np.clip(toks, 0, self.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterate(self, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def write_synthetic_corpus(path: str | Path, n_tokens: int, vocab: int,
                           seed: int = 0) -> Path:
    """Materialize a synthetic corpus for the memmap path (tests/examples)."""
    rng = np.random.default_rng(seed)
    toks = np.minimum(rng.zipf(1.3, size=n_tokens) - 1, vocab - 1)
    arr = toks.astype(np.int32)
    path = Path(path)
    arr.tofile(path)
    return path
