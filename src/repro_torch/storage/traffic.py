"""Synthetic production traffic generators for the storage front-ends
(the port of ``repro.storage.traffic``; numpy ``default_rng``, so the
streams are the reference's bit for bit).

The paper's evaluation replays application workloads (KVBench on
RocksDB+ZenFS, §6.1); production zone traffic is neither uniform nor
stationary, so the trace compiler's workload recorders draw their
request streams from the three shapes operators actually see:

* **Zipfian skew** (:func:`zipfian_keys` / :func:`zipfian_tenants`) --
  a small hot set absorbs most accesses (cache traffic, tenant load
  imbalance);
* **diurnal load** (:func:`diurnal_load`) -- a smooth day/night cycle
  scaling the per-step operation budget;
* **burst arrivals** (:func:`burst_arrivals`) -- checkpoint-style
  on/off traffic: quiet baseline punctuated by multiplicative bursts.

Every generator is a pure function of its ``seed`` (deterministic
streams, tested), returns plain numpy arrays, and never touches a
device -- the front-ends in :mod:`repro_torch.storage.flashcache` /
:mod:`repro_torch.storage.compile` turn these streams into zone commands.
"""

from __future__ import annotations

import numpy as np

__all__ = ["zipf_weights", "zipfian_keys", "zipfian_tenants",
           "diurnal_load", "burst_arrivals"]


def zipf_weights(n_keys: int, skew: float) -> np.ndarray:
    """Normalized Zipf(``skew``) probabilities over ranks ``0..n_keys-1``
    (rank 0 hottest).  ``skew = 0`` degenerates to uniform."""
    if n_keys < 1:
        raise ValueError(f"n_keys must be >= 1, got {n_keys}")
    if skew < 0:
        raise ValueError(f"skew must be >= 0, got {skew}")
    w = np.arange(1, n_keys + 1, dtype=np.float64) ** -skew
    return w / w.sum()


def zipfian_keys(n: int, n_keys: int, *, skew: float = 1.1,
                 seed: int = 0) -> np.ndarray:
    """``n`` key ids drawn i.i.d. from Zipf(``skew``) over ``n_keys``
    ranks -- the access stream cache/LSM front-ends consume.  Key id ==
    popularity rank (id 0 hottest), so distribution-shape tests can
    compare empirical frequencies against :func:`zipf_weights`
    directly."""
    rng = np.random.default_rng(seed)
    return rng.choice(n_keys, size=n, p=zipf_weights(n_keys, skew))


def zipfian_tenants(n: int, n_tenants: int, *, skew: float = 1.0,
                    seed: int = 0) -> np.ndarray:
    """Per-request tenant ids under Zipfian tenant load imbalance
    (tenant 0 the heaviest) -- who issues each request of a shared-fleet
    stream."""
    return zipfian_keys(n, n_tenants, skew=skew, seed=seed)


def diurnal_load(n_steps: int, *, base: int, peak: int,
                 period: int = 24, phase: float = 0.0,
                 seed: int | None = None, jitter: float = 0.0
                 ) -> np.ndarray:
    """Per-step operation budgets on a smooth day/night cycle.

    A raised cosine oscillates between ``base`` (trough) and ``peak``
    (crest) with the given ``period`` (steps per day).  ``jitter`` adds
    seeded multiplicative noise (fraction of the local level; requires
    a ``seed``).  Budgets are integer and never below zero."""
    if peak < base:
        raise ValueError(f"peak ({peak}) must be >= base ({base})")
    t = np.arange(n_steps, dtype=np.float64)
    level = base + (peak - base) * 0.5 * (
        1.0 - np.cos(2.0 * np.pi * (t / period + phase)))
    if jitter:
        if seed is None:
            raise ValueError("jitter needs a seed (determinism)")
        rng = np.random.default_rng(seed)
        level = level * (1.0 + jitter * rng.standard_normal(n_steps))
    return np.maximum(np.round(level), 0).astype(np.int64)


def burst_arrivals(n_steps: int, *, rate: int, burst_prob: float = 0.1,
                   burst_len: int = 3, burst_mult: int = 8,
                   seed: int = 0) -> np.ndarray:
    """Per-step arrival counts with checkpoint-style bursts.

    Baseline Poisson(``rate``) arrivals; each step starts a burst with
    probability ``burst_prob``, which multiplies the rate by
    ``burst_mult`` for the next ``burst_len`` steps (overlapping bursts
    extend, not stack).  Deterministic per ``seed``."""
    if not 0.0 <= burst_prob <= 1.0:
        raise ValueError(f"burst_prob must be in [0, 1], got {burst_prob}")
    rng = np.random.default_rng(seed)
    starts = rng.random(n_steps) < burst_prob
    noise = rng.poisson(rate, size=n_steps)
    boost = rng.poisson(rate * (burst_mult - 1), size=n_steps)
    out = np.zeros(n_steps, dtype=np.int64)
    until = -1
    for i in range(n_steps):
        if starts[i]:
            until = i + burst_len - 1
        out[i] = noise[i] + (boost[i] if i <= until else 0)
    return out
