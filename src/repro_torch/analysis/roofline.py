"""Three-term roofline of a dry-run cell on the NVIDIA H100 (the port of
``repro.analysis.roofline``, its fields and ``report()`` keys kept).

    compute    = FLOPs_per_device / peak_FLOPs
    memory     = HBM_bytes_per_device / HBM_bw
    collective = collective_bytes_per_device / LINK_BW

Per-device quantities over per-card peaks equal total work over (cards x
peak).  The constants are one NVIDIA H100 80GB HBM3 (the SXM5 part, at
its 700 W power limit), from NVIDIA's H100 Tensor Core GPU datasheet:
dense bf16 tensor-core rate without sparsity, HBM3 bandwidth, and NVLink
4's 900 GB/s a card, 450 GB/s each way.  As in the reference, one
bandwidth serves every mesh axis and a transfer is assumed to use one
link direction; a card set below 700 W runs slower than these peaks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

# NVIDIA H100 80GB HBM3 (SXM5, 700 W), datasheet peaks
PEAK_FLOPS_BF16 = 989e12        # FLOP/s per card, dense bf16
HBM_BW = 3.35e12                # B/s per card
LINK_BW = 450e9                 # B/s, NVLink 4, one direction


@dataclasses.dataclass
class Roofline:
    flops: float                # per-device flops
    hbm_bytes: float            # per-device bytes accessed
    coll_bytes: float           # per-device collective bytes
    model_flops: float = 0.0    # 6*N*D useful flops (per device)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / FLOPs: how much of the counted compute is useful."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful flop-time over the bounding term."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS_BF16) / self.t_bound

    def report(self) -> Dict[str, float]:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_per_dev": self.model_flops,
            "useful_flop_fraction": self.useful_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_train(n_active_params: int, n_tokens: int) -> float:
    """6*N*D for a train step (fwd+bwd)."""
    return 6.0 * n_active_params * n_tokens


def model_flops_forward(n_active_params: int, n_tokens: int) -> float:
    """2*N*D for inference forward (prefill/decode)."""
    return 2.0 * n_active_params * n_tokens
