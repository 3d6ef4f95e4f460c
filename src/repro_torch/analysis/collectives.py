"""Collective-byte accounting over the collectives a step ran (the
port's counterpart of ``repro.analysis.hlo``).

The reference parses the compiled SPMD module's HLO text for its
collective instructions.  PyTorch runs eagerly and has no such text, so
nothing here parses one: :class:`CollectiveRecord` is a dispatch mode
that notes every collective the step calls while it runs -- the
functional collectives DTensor's redistributions call, and the
``torch.distributed`` collectives (``c10d``) a hand-written schedule
calls -- and :func:`collective_bytes` / :func:`collective_count` read the
record under the reference's category names.  Each op contributes its
result's bytes on this device, as ``hlo.py`` counts an instruction's
result shape: an all-gather its gathered tensor, a reduce-scatter its
shard, an all-reduce its input's size.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

#: op name without its namespace -> (category, index of the argument
#: holding the result for an in-place ``c10d`` op, or None where the op
#: returns its result); the functional collectives live in the
#: ``_c10d_functional`` and ``c10d_functional`` namespaces
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = {
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "send": "collective-permute",
}


def _category(name: str):
    """(category, result argument) of op ``namespace::name``, or None."""
    ns, _, op = name.partition("::")
    if ns in ("_c10d_functional", "c10d_functional") and op in _FUNCTIONAL:
        return _FUNCTIONAL[op], None
    if ns == "c10d" and op in _C10D:
        return _C10D[op], 0
    return None


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(v) for v in x)
    return 0


def _group_name(func, args, kwargs) -> Optional[str]:
    """The process group's name a functional collective was given (its
    ``group_name`` argument), else None."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == "group_name":
            return kwargs.get("group_name", args[i] if i < len(args)
                              else None)
    return None


class CollectiveRecord(TorchDispatchMode):
    """Notes ``(category, result bytes)`` of every collective dispatched
    while it is active, in call order (``self.ops``), and beside each the
    name of its process group where the op names it (``self.groups``:
    ``DeviceMesh.get_group(axis).group_name`` tells a mesh axis's; None
    for a ``c10d`` op).  Enter it around the step: ``with
    CollectiveRecord() as rec: step(...)``."""

    def __init__(self):
        super().__init__()
        self.ops: List[Tuple[str, int]] = []
        self.groups: List[Optional[str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # a mode runs before a tensor subclass: step aside so that
            # DTensor desugars the op into local ops and collectives,
            # which come back through here
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        hit = _category(func._schema.name)
        if hit is not None:
            category, arg = hit
            self.ops.append((category,
                             _bytes(out if arg is None else args[arg])))
            self.groups.append(_group_name(func, args, kwargs or {}))
        return out


def collective_bytes(record: CollectiveRecord) -> Dict[str, int]:
    """Per-category result bytes (per device) of every collective, and
    their ``"total"``."""
    out: Dict[str, int] = defaultdict(int)
    for category, nbytes in record.ops:
        out[category] += nbytes
    out["total"] = sum(out.values())
    return dict(out)


def collective_count(record: CollectiveRecord) -> Dict[str, int]:
    """Per-category count of the collectives called."""
    out: Dict[str, int] = defaultdict(int)
    for category, _ in record.ops:
        out[category] += 1
    return dict(out)
