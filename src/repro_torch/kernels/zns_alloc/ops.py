"""Public entry points of the zns_alloc selection kernel.

:func:`zns_alloc_rows` is the engine's selection: on CUDA tensors it
launches the hand-written Hopper kernel (``csrc/zns_alloc.cu``, built at
first use), on CPU tensors it runs the plain version in :mod:`.ref`.  The
choice is made by the tensors' device alone, and a CUDA call either
launches the kernel or raises.  :func:`zns_alloc` is the Pallas contract
of ``repro.kernels.zns_alloc.ops.zns_alloc`` on top of it.

``launches`` counts kernel launches (never plain-version calls), so a run
can show that it went through the kernel; :func:`reset_launches` zeroes
it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.zns_alloc.ref import zns_alloc_rows_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "zns_alloc.cu"
MAX_WIDTH = 2048       # 256 threads x 8 register-resident keys
MAX_TAKE = 64

launches = 0
_lib_cache: list = []      # the loaded library, once per process


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use and loaded once: later
    calls neither hash the source nor touch the file system."""
    if not _lib_cache:
        lib = _build.load(SOURCE)
        # every pointer and the stream as c_void_p: an undeclared
        # argument would pass as a 32-bit int and cut the pointer
        lib.zns_alloc_rows.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.zns_alloc_rows.restype = ctypes.c_int
        _lib_cache.append(lib)
    return _lib_cache[0]


def _check(wear, avail, eligible, by_wear, take_eff, per_group_eff,
           take: int) -> None:
    if wear.dim() != 3 or avail.shape != wear.shape:
        raise ValueError(f"wear/avail must share one (L, G, W) shape, got "
                         f"{tuple(wear.shape)} and {tuple(avail.shape)}")
    L, G, W = wear.shape
    for name, t, shape in (("eligible", eligible, (L, G)),
                           ("by_wear", by_wear, (L,)),
                           ("take_eff", take_eff, (L,)),
                           ("per_group_eff", per_group_eff, (L,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("wear", wear), ("avail", avail),
                    ("eligible", eligible), ("by_wear", by_wear),
                    ("take_eff", take_eff),
                    ("per_group_eff", per_group_eff)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != wear.device:
            raise ValueError(f"{name} is on {t.device}, wear on "
                             f"{wear.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= take <= min(W, MAX_TAKE):
        raise ValueError(f"take {take} must be in [1, min(width {W}, "
                         f"{MAX_TAKE})]")
    if W > MAX_WIDTH:
        raise ValueError(f"width {W} exceeds the kernel's {MAX_WIDTH}")
    if L * G == 0:
        raise ValueError("empty batch")


def zns_alloc_rows(wear: torch.Tensor, avail: torch.Tensor,
                   eligible: torch.Tensor, by_wear: torch.Tensor,
                   take_eff: torch.Tensor, per_group_eff: torch.Tensor,
                   *, take: int, with_sel: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """Per-row lowest-``(wear, col)`` selection over a lane batch.

    ``wear`` / ``avail`` are ``(L, G, W)`` int32, ``eligible`` ``(L, G)``
    int32 0/1, ``by_wear`` / ``take_eff`` / ``per_group_eff`` ``(L,)``
    int32, all contiguous on one device.  Returns ``(cols, ok, cost,
    sel)`` as :func:`.ref.zns_alloc_rows_ref` defines them; ``sel`` is
    ``None`` unless ``with_sel``."""
    global launches
    _check(wear, avail, eligible, by_wear, take_eff, per_group_eff, take)
    if wear.device.type == "cpu":
        cols, ok, cost, sel = zns_alloc_rows_ref(
            wear, avail, eligible, by_wear, take_eff, per_group_eff,
            take=take)
        return cols, ok, cost, sel if with_sel else None
    if wear.device.type != "cuda":
        raise ValueError(f"zns_alloc_rows runs on cpu or cuda tensors, "
                         f"not {wear.device}")
    L, G, W = wear.shape
    cols = torch.empty((L, G, take), dtype=torch.int32, device=wear.device)
    ok = torch.empty((L, G), dtype=torch.int32, device=wear.device)
    cost = torch.empty((L, G), dtype=torch.float32, device=wear.device)
    sel = (torch.empty((L, G, W), dtype=torch.int32, device=wear.device)
           if with_sel else None)
    with torch.cuda.device(wear.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().zns_alloc_rows(
            wear.data_ptr(), avail.data_ptr(), eligible.data_ptr(),
            by_wear.data_ptr(), take_eff.data_ptr(),
            per_group_eff.data_ptr(), cols.data_ptr(), ok.data_ptr(),
            cost.data_ptr(), None if sel is None else sel.data_ptr(),
            L, G, W, take, stream)
    if err != 0:
        raise RuntimeError(f"zns_alloc kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return cols, ok, cost, sel


def zns_alloc(wear2d: torch.Tensor, avail2d: torch.Tensor,
              eligible: torch.Tensor, *, take: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas contract: ``(sel bool (G, W), feasible bool ())`` --
    per eligible row the ``take`` lowest-wear free elements (avail in
    {0, 3}), ties to the lowest column; feasible when every eligible row
    has at least ``take`` of them."""
    G, W = wear2d.shape
    dev = wear2d.device
    elig = eligible.to(torch.int32).contiguous()
    one = torch.ones(1, dtype=torch.int32, device=dev)
    take_k = min(take, W)      # picks past the row width cannot exist
    _, ok, _, sel = zns_alloc_rows(
        wear2d.to(torch.int32).contiguous()[None],
        avail2d.to(torch.int32).contiguous()[None], elig[None], one,
        one * take_k, one * W, take=take_k, with_sel=True)
    feasible = torch.all((ok[0] >= take) | (elig == 0))
    return sel[0].bool(), feasible
