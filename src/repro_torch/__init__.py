"""SilentZNS on PyTorch and CUDA: a port of the JAX package ``repro``.

The same subpackage layout as ``repro`` (``repro_torch.X.Y`` ports
``repro.X.Y``), importing ``torch`` and ``numpy`` only.  Entry points take
``device=`` and default to ``"cuda"``; see :func:`resolve_device`.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`.  A CUDA device without a
    card raises: the port never drops to the CPU on its own -- pass
    ``device="cpu"`` for that."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    return dev
