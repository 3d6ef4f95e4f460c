"""Public entry points of the zns_alloc selection kernels.

:func:`alloc_select` and :func:`grow_select` are the engine's whole ALLOC
and silent-grow selections, one launch per call; :func:`zns_alloc_rows`
is the per-row selection on its own, and :func:`zns_alloc` the Pallas
contract of ``repro.kernels.zns_alloc.ops.zns_alloc`` on top of it.  On
CUDA tensors each launches its hand-written Hopper kernel
(``csrc/zns_alloc.cu``, built at first use), on CPU tensors it runs the
plain version in :mod:`.ref`.  The choice is made by the tensors' device
alone, and a CUDA call either launches the kernel or raises.

The engine calls :func:`alloc_select` and :func:`grow_select` once per op
step each, so their host time is the step's: the checks of shapes,
strides, dtypes and devices, and the launch's fixed integers, are kept
per argument signature, and the current stream is read through the
raw-pointer lookup PyTorch's own generated launchers use.

``counts`` holds each kernel's launches (never plain-version calls), so
a run can show that it went through them; :func:`reset_launches` zeroes
them.
:func:`empty_launch` launches an empty kernel through the same route, a
yardstick of what any launch costs, and counts nowhere.
"""

from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.zns_alloc.ref import (LANE_FIELDS,
                                               alloc_select_ref,
                                               grow_select_ref,
                                               zns_alloc_rows_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "zns_alloc.cu"
MAX_WIDTH = 2048       # the row kernel's columns (4 warps' rows: 98 KB)
MAX_TAKE = 64          # picks per row: two per lane of the sorting warp
MAX_GROUPS = 32        # the fused kernels: one warp per group, one CTA
MAX_SMEM = 232448      # shared memory a CTA may use on sm_90

counts = {"alloc_select": 0, "grow_select": 0, "rows": 0}
_lib_cache: list = []      # the loaded library, once per process
_plans: dict = {}          # argument signature -> launch integers


def reset_launches() -> None:
    for name in counts:
        counts[name] = 0


def _lib() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once: later
    calls neither hash the source nor touch the file system."""
    if not _lib_cache:
        lib = _build.load(SOURCE)
        # every pointer and the stream as c_void_p: an undeclared
        # argument would pass as a 32-bit int and cut the pointer
        ints = ctypes.POINTER(ctypes.c_int)
        lib.zns_alloc_rows.argtypes = [ctypes.c_void_p] * 10 + [
            ints, ctypes.c_void_p]
        lib.zns_alloc_select.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [
            ints, ctypes.c_void_p]
        lib.zns_grow_select.argtypes = [ctypes.c_void_p] * 8 + [
            ints, ctypes.c_void_p]
        lib.zns_alloc_empty.argtypes = [ctypes.c_void_p]
        for fn in (lib.zns_alloc_rows, lib.zns_alloc_select,
                   lib.zns_grow_select, lib.zns_alloc_empty):
            fn.restype = ctypes.c_int
        _lib_cache.append(lib)
    return _lib_cache[0]


def _stream(index: int) -> int:
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return (get(index) if get is not None
            else torch.cuda.current_stream(index).cuda_stream)


def _launch(name: Optional[str], fn, device: torch.device, *args) -> None:
    """``fn(*args, stream)`` on ``device``'s current stream; raises on a
    refused launch and counts the one that was made under ``name``."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    on_device = (contextlib.nullcontext()
                 if index == torch.cuda.current_device()
                 else torch.cuda.device(index))
    with on_device:
        err = fn(*args, _stream(index))
    if err != 0:
        raise RuntimeError(f"zns_alloc kernel launch failed: CUDA error "
                           f"{err}")
    if name is not None:
        counts[name] += 1


def empty_launch(device="cuda") -> None:
    """Launch an empty kernel (one warp) through the same route as the
    selection kernels: the host's and the device's cost of any launch."""
    _launch(None, _lib().zns_alloc_empty, torch.device(device))


def _keep(sig: tuple, ints: ctypes.Array) -> ctypes.Array:
    if len(_plans) > 4096:
        _plans.clear()
    _plans[sig] = ints
    return ints


def _sig(*tensors) -> tuple:
    return tuple((t.shape, t.stride(), t.dtype, t.device) for t in tensors)


def _check_common(named, device) -> None:
    _build.refuse_dtensor("zns_alloc", *(t for _, t in named))
    for name, t in named:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, wear on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"zns_alloc runs on cpu or cuda tensors, not "
                         f"{device}")


def _ints(*values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


# --------------------------------------------------------------------- #
# the per-row selection and the Pallas contract
# --------------------------------------------------------------------- #
def _rows_plan(wear, avail, eligible, by_wear, take_eff, per_group_eff,
               take: int) -> ctypes.Array:
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
    named = (("wear", wear), ("avail", avail), ("eligible", eligible),
             ("by_wear", by_wear), ("take_eff", take_eff),
             ("per_group_eff", per_group_eff))
    _check_common(named, wear.device)
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= take <= min(W, MAX_TAKE):
        raise ValueError(f"take {take} must be in [1, min(width {W}, "
                         f"{MAX_TAKE})]")
    if W > MAX_WIDTH:
        raise ValueError(f"width {W} exceeds the kernel's {MAX_WIDTH}")
    if L * G == 0:
        raise ValueError("empty batch")
    return _ints(L, G, W, take)


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
    args = (wear, avail, eligible, by_wear, take_eff, per_group_eff)
    sig = ("rows", take) + _sig(*args)
    ints = _plans.get(sig)
    if ints is None:
        ints = _keep(sig, _rows_plan(*args, take))
    if wear.device.type == "cpu":
        cols, ok, cost, sel = zns_alloc_rows_ref(*args, take=take)
        return cols, ok, cost, sel if with_sel else None
    L, G, W = wear.shape
    dev = wear.device
    cols = torch.empty((L, G, take), dtype=torch.int32, device=dev)
    ok = torch.empty((L, G), dtype=torch.int32, device=dev)
    cost = torch.empty((L, G), dtype=torch.float32, device=dev)
    sel = (torch.empty((L, G, W), dtype=torch.int32, device=dev)
           if with_sel else None)
    _launch("rows", _lib().zns_alloc_rows, dev,
            *(t.data_ptr() for t in args), cols.data_ptr(), ok.data_ptr(),
            cost.data_ptr(), None if sel is None else sel.data_ptr(), ints)
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


# --------------------------------------------------------------------- #
# the engine's fused selections
# --------------------------------------------------------------------- #
def _fused_smem(n_groups: int, per_group: int, take: int) -> int:
    """Shared memory of one fused CTA, as the CUDA launcher sizes it:
    per warp two 8-byte keys and a column per pick, and the row's wear,
    availability and selection values (4 bytes each a column, the row
    padded to whole 16-byte vectors)."""
    return n_groups * (take * 20 + -(-per_group // 4) * 48)


def _check_fused(wear, avail, lanes, n_groups: int, per_group: int,
                 take: int, zone_groups: int) -> None:
    if wear.dim() != 2 or avail.shape != wear.shape:
        raise ValueError(f"wear/avail must share one (L, n) shape, got "
                         f"{tuple(wear.shape)} and {tuple(avail.shape)}")
    L, n = wear.shape
    if L == 0:
        raise ValueError("empty batch")
    if n < n_groups * per_group:
        raise ValueError(f"element arrays of {n} columns hold no "
                         f"{n_groups} x {per_group} grid")
    if (wear.stride(1) != 1 or avail.stride() != wear.stride()):
        raise ValueError("wear/avail must share one layout with "
                         "contiguous rows")
    if tuple(lanes.shape) != (L, len(LANE_FIELDS)) \
            or not lanes.is_contiguous():
        raise ValueError(f"lanes must be a contiguous ({L}, "
                         f"{len(LANE_FIELDS)}) table, got "
                         f"{tuple(lanes.shape)}")
    if not 1 <= zone_groups <= n_groups or not 1 <= take <= per_group:
        raise ValueError(f"zone_groups {zone_groups} must be in [1, "
                         f"n_groups {n_groups}] and take {take} in [1, "
                         f"per_group {per_group}]")
    if wear.device.type != "cuda":
        return                 # the plain version takes any grid
    _build.refuse_dtensor("zns_alloc", wear, avail, lanes)
    if not 1 <= n_groups <= MAX_GROUPS:
        raise ValueError(f"n_groups {n_groups} must be in [1, "
                         f"{MAX_GROUPS}]: the kernel runs a warp per group")
    if take > MAX_TAKE:
        raise ValueError(f"take {take} exceeds the kernel's {MAX_TAKE}")
    if _fused_smem(n_groups, per_group, take) > MAX_SMEM:
        raise ValueError(f"a {n_groups} x {per_group} grid needs more "
                         f"than the {MAX_SMEM} bytes of shared memory "
                         f"of one CTA")


def _per_lane(L: int, named) -> None:
    for name, t in named:
        if tuple(t.shape) != (L,):
            raise ValueError(f"{name} must have shape ({L},), got "
                             f"{tuple(t.shape)}")


def alloc_select(wear: torch.Tensor, avail: torch.Tensor,
                 lanes: torch.Tensor, rr_next: torch.Tensor,
                 hint: torch.Tensor, *, n_groups: int, per_group: int,
                 take: int, zone_groups: int):
    """The engine's ALLOC selection for every lane, one launch (see
    :func:`.ref.alloc_select_ref` for the arguments and the result).
    ``wear`` / ``avail`` are read in place through their lane stride;
    ``hint`` may be a strided column of the op program."""
    sig = ("alloc", n_groups, per_group, take, zone_groups) + _sig(
        wear, avail, lanes, rr_next) + ((hint.shape, hint.dtype,
                                         hint.device),)
    ints = _plans.get(sig)
    if ints is None:
        _check_fused(wear, avail, lanes, n_groups, per_group, take,
                     zone_groups)
        _per_lane(wear.shape[0], (("rr_next", rr_next), ("hint", hint)))
        _check_common((("wear", wear), ("avail", avail), ("lanes", lanes),
                       ("rr_next", rr_next), ("hint", hint)),
                      wear.device)
        if not rr_next.is_contiguous():
            raise ValueError("rr_next must be contiguous")
        ints = _keep(sig, _ints(wear.shape[0], n_groups, per_group, take,
                                zone_groups, wear.stride(0)))
    if wear.device.type == "cpu":
        return alloc_select_ref(wear, avail, lanes, rr_next, hint,
                                n_groups=n_groups, per_group=per_group,
                                take=take, zone_groups=zone_groups)
    L = wear.shape[0]
    dev = wear.device
    win = torch.empty((L, zone_groups), dtype=torch.int32, device=dev)
    eids = torch.empty((L, zone_groups, take), dtype=torch.int32,
                       device=dev)
    feasible = torch.empty(L, dtype=torch.bool, device=dev)
    lane_out = torch.empty((2, L), dtype=torch.int32, device=dev)
    _launch("alloc_select", _lib().zns_alloc_select, dev, wear.data_ptr(),
            avail.data_ptr(), lanes.data_ptr(), rr_next.data_ptr(),
            hint.data_ptr(), hint.stride(0), win.data_ptr(),
            eids.data_ptr(), feasible.data_ptr(), lane_out.data_ptr(), ints)
    rr, rank_lim = lane_out.unbind(0)
    return win, eids, feasible, rr, rank_lim


def grow_select(wear: torch.Tensor, avail: torch.Tensor,
                lanes: torch.Tensor, zone_cols: torch.Tensor,
                zone: torch.Tensor, k: torch.Tensor, *, n_groups: int,
                per_group: int, take: int, zone_groups: int):
    """The silent policy's grow selection for every lane, one launch
    (see :func:`.ref.grow_select_ref`).  ``zone`` must index a zone
    (the engine clamps it)."""
    sig = ("grow", n_groups, per_group, take, zone_groups) + _sig(
        wear, avail, lanes, zone_cols, zone, k)
    ints = _plans.get(sig)
    if ints is None:
        _check_fused(wear, avail, lanes, n_groups, per_group, take,
                     zone_groups)
        L = wear.shape[0]
        _per_lane(L, (("zone", zone), ("k", k)))
        _check_common((("wear", wear), ("avail", avail), ("lanes", lanes),
                       ("zone_cols", zone_cols), ("zone", zone),
                       ("k", k)), wear.device)
        if zone_cols.dim() != 3 or zone_cols.shape[0] != L \
                or 0 in zone_cols.shape or not zone_cols.is_contiguous():
            raise ValueError(f"zone_cols must be a contiguous ({L}, "
                             f"n_zones, P) map, got "
                             f"{tuple(zone_cols.shape)}")
        if not (zone.is_contiguous() and k.is_contiguous()):
            raise ValueError("zone and k must be contiguous")
        ints = _keep(sig, _ints(L, n_groups, per_group, take, zone_groups,
                                wear.stride(0), zone_cols.shape[1],
                                zone_cols.shape[2]))
    if wear.device.type == "cpu":
        return grow_select_ref(wear, avail, lanes, zone_cols, zone, k,
                               n_groups=n_groups, per_group=per_group,
                               take=take, zone_groups=zone_groups)
    L = wear.shape[0]
    dev = wear.device
    eids = torch.empty((L, zone_groups, take), dtype=torch.int32,
                       device=dev)
    feasible = torch.empty(L, dtype=torch.bool, device=dev)
    _launch("grow_select", _lib().zns_grow_select, dev, wear.data_ptr(),
            avail.data_ptr(),
            lanes.data_ptr(), zone_cols.data_ptr(), zone.data_ptr(),
            k.data_ptr(), eids.data_ptr(), feasible.data_ptr(), ints)
    return eids, feasible
