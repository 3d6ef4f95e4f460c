"""Evaluation metrics (paper §6.1 "Evaluation Metrics"), the port of
``repro.core.metrics``."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.device import ZNSDevice


def dlwa(host_pages: int, device_pages: int) -> float:
    """Device-level write amplification: (W_h + W_d) / W_h."""
    if host_pages == 0:
        return 1.0
    return (host_pages + device_pages) / host_pages


@dataclasses.dataclass
class SATracker:
    """Space amplification (paper §6.1/Fig. 1): the ratio of data the
    system must keep on device (live + invalidated-but-unreclaimed) to the
    live host data, sampled per timestamp and averaged:

        SA(t) = (W_live(t) + W_i(t)) / W_live(t)

    W_i grows when files are deleted inside zones that still hold live
    data (lifetime mixing) and shrinks when a fully-invalid zone RESETs.
    """

    live_bytes: float = 0.0
    invalid_bytes: float = 0.0
    _samples: List[float] = dataclasses.field(default_factory=list)

    def on_host_write(self, nbytes: float) -> None:
        self.live_bytes += nbytes

    def on_invalidate(self, nbytes: float) -> None:
        self.live_bytes = max(0.0, self.live_bytes - nbytes)
        self.invalid_bytes += nbytes

    def on_reclaim(self, nbytes: float) -> None:
        self.invalid_bytes = max(0.0, self.invalid_bytes - nbytes)

    def sample(self) -> None:
        if self.live_bytes > 0:
            self._samples.append(
                (self.live_bytes + self.invalid_bytes) / self.live_bytes)

    @property
    def sa(self) -> float:
        return float(np.mean(self._samples)) if self._samples else 1.0


def wear_report(dev: ZNSDevice) -> Dict[str, float]:
    """Total + distributional wear (paper Fig. 7c)."""
    w = dev.block_wear()
    return {
        "total_block_erases": float(dev.block_erases),
        "pending_block_erases": float(dev.pending_erases()),
        "total_incl_pending": float(dev.block_erases + dev.pending_erases()),
        "mean_wear": float(w.mean()),
        "max_wear": float(w.max()),
        "std_wear": float(w.std()),
        "cv_wear": float(w.std() / w.mean()) if w.mean() > 0 else 0.0,
    }


def interference_factor(baseline_throughput: float,
                        contended_throughput: float) -> float:
    """Ratio of baseline host throughput to throughput under concurrent
    FINISH (paper §6.1); >1 means the device slows the host down."""
    if contended_throughput <= 0:
        return float("inf")
    return baseline_throughput / contended_throughput
