"""Public entry point of the sLSTM scan.

:func:`slstm_scan` with ``impl="kernel"`` (the default) launches a
hand-written Hopper kernel (``csrc/slstm_scan.cu``, built at first use)
on CUDA tensors and runs the plain version in :mod:`.ref` on CPU tensors
-- the choice is made by the tensors' device alone, and a CUDA call
either launches the kernel or raises.  ``impl="ref"`` runs the plain
version on any device (the card's comparison path).

The input projection ``pre_x = x @ w_in`` is the caller's (one product
for every step, before the loop); the kernel reads it through its batch
and time strides.  The source holds two designs, one launch a call each;
:func:`launch_plan`, a pure function of the width, heads and dtype,
picks one:

* ``"cluster"`` (bf16): a thread-block cluster of 8 CTAs a sequence (16
  where 8 would give a CTA more than 96 units), each CTA holding its
  units' gate columns of ``r_rec`` in registers as tensor-core fragments
  and sending its ``h`` and the stabiliser's per-head maxima into every
  CTA's shared memory, each receiver waiting on its own mbarrier for the
  step's bytes;
* ``"l2"``: one CTA a sequence, ``r_rec`` read from L2 every step, for
  f32 and the bf16 shapes the cluster kernel does not take; d at most
  :data:`MAX_D` of the dtype and ``r_rec``'s rows a multiple of 16 bytes.

:func:`launch` runs one launch of a given plan (the card's check of the
L2 kernel at a shape the plan gives the cluster, ``Plan("l2")``); the
source refuses a plan the shape does not allow.  A cluster that the card
cannot schedule raises: the wrapper never quietly takes the other
kernel.

``launches`` counts kernel launches (never plain-version calls) and
``designs`` the launches of each design; :func:`reset_launches` zeroes
both.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "slstm_scan.cu"
MAX_D = {torch.float32: 1024, torch.bfloat16: 2048}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: row blocks of 16 (ph / 16) the tensor-core product is built for, and
#: its most threads (4U; the slice takes 8 x blocks registers a thread)
MMA_BLOCKS = (4, 8, 12)
MMA_THREADS = 384
CLUSTER_SIZES = (8, 16)          # 16 is a non-portable cluster size


@dataclass(frozen=True)
class Plan:
    """How :func:`slstm_scan` launches at one shape.  ``design`` is
    ``"cluster"`` or ``"l2"``; the rest describe the cluster kernel (0
    for the L2 kernel): ``cluster`` CTAs a sequence, ``units`` of d a
    CTA, ``kb`` row blocks of 16 of its tensor-core product, ``threads``
    a CTA (4 ``units``), ``smem`` dynamic shared bytes a CTA, and
    ``r_bytes`` its slice of r_rec, held in registers."""
    design: str
    cluster: int = 0
    units: int = 0
    kb: int = 0
    threads: int = 0
    smem: int = 0
    r_bytes: int = 0


def cluster_smem(d: int, n_heads: int, cluster: int) -> int:
    """The cluster kernel's dynamic shared bytes a CTA (the source's
    ``cluster_smem``): three mbarriers, f32 h_prev twice, the CTA's
    recurrent sums and the cluster's per-head maxima, a slot per (CTA,
    warp of unit threads, head)."""
    units = d // cluster
    warps = -(-units // 32)
    return 32 + 4 * (2 * d + 4 * units + 2 * cluster * warps * n_heads)


def launch_plan(d: int, n_heads: int, dtype: torch.dtype) -> Plan:
    """In bf16, the smallest cluster in :data:`CLUSTER_SIZES` whose CTAs
    take a multiple of 16 units and at most a quarter of
    :data:`MMA_THREADS` each, where a head's rows are 16 x
    :data:`MMA_BLOCKS`: the tensor-core cluster kernel.  Else (f32, or
    no such cluster) the L2 kernel."""
    if dtype not in DTYPES:
        raise TypeError(f"slstm_scan takes float32 or bfloat16, not {dtype}")
    if d < 1 or n_heads < 1 or d % n_heads:
        raise ValueError(f"d {d} is not a multiple of {n_heads} heads")
    ph = d // n_heads
    if dtype != torch.bfloat16 or ph % 16 or ph // 16 not in MMA_BLOCKS:
        return Plan("l2")
    for c in CLUSTER_SIZES:
        units = d // c
        if d % c or units % 16 or 4 * units > MMA_THREADS:
            continue
        return Plan("cluster", c, units, kb=ph // 16, threads=4 * units,
                    smem=cluster_smem(d, n_heads, c),
                    r_bytes=ph * 4 * units * 2)
    return Plan("l2")

launches = 0
designs = {"cluster": 0, "l2": 0}
_lib_cache: list = []      # the loaded library, once per process


def reset_launches() -> None:
    global launches
    launches = 0
    designs.update(cluster=0, l2=0)


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load(SOURCE)
        lib.slstm_scan_fwd.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
        lib.slstm_scan_fwd.restype = ctypes.c_int
        lib.slstm_scan_cluster_fwd.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
            + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        lib.slstm_scan_cluster_fwd.restype = ctypes.c_int
        _lib_cache.append(lib)
    return _lib_cache[0]


def _check(pre_x, r_rec) -> None:
    if pre_x.dim() != 3 or r_rec.dim() != 3:
        raise ValueError(f"pre_x must be (B, S, 4d) and r_rec (H, ph, "
                         f"4 ph), got {tuple(pre_x.shape)}, "
                         f"{tuple(r_rec.shape)}")
    h, ph, w4 = r_rec.shape
    if w4 != 4 * ph or pre_x.shape[-1] != 4 * h * ph:
        raise ValueError(f"r_rec {tuple(r_rec.shape)} is not (H, ph, 4 ph) "
                         f"for pre_x's width {pre_x.shape[-1]}")
    if min(pre_x.shape) == 0 or min(r_rec.shape) == 0:
        raise ValueError("empty batch, sequence or width")
    if r_rec.device != pre_x.device:
        raise ValueError(f"r_rec is on {r_rec.device}, pre_x on "
                         f"{pre_x.device}")
    if r_rec.dtype != pre_x.dtype:
        raise TypeError(f"r_rec is {r_rec.dtype}, pre_x {pre_x.dtype}")
    if pre_x.dtype not in DTYPES:
        raise TypeError(f"slstm_scan takes float32 or bfloat16, not "
                        f"{pre_x.dtype}")


def slstm_scan(pre_x: torch.Tensor, r_rec: torch.Tensor, *,
               impl: str = "kernel") -> torch.Tensor:
    """pre_x ``(B, S, 4d)``, r_rec ``(H, ph, 4 ph)`` -> h ``(B, S, d)`` in
    pre_x's dtype (see :mod:`.ref` for the semantics), on the kernel
    :func:`launch_plan` picks."""
    _check(pre_x, r_rec)
    n_heads = r_rec.shape[0]
    if impl == "ref" or (impl == "kernel" and pre_x.device.type == "cpu"):
        return slstm_scan_ref(pre_x, r_rec, n_heads)
    if impl != "kernel":
        raise ValueError(f"unknown ssm impl: {impl}")
    if pre_x.device.type != "cuda":
        raise ValueError(f"slstm_scan runs on cpu or cuda tensors, not "
                         f"{pre_x.device}")
    return launch(pre_x, r_rec,
                  launch_plan(pre_x.shape[-1] // 4, n_heads, pre_x.dtype))


def launch(pre_x: torch.Tensor, r_rec: torch.Tensor,
           plan: Plan) -> torch.Tensor:
    """One launch of the kernel ``plan`` describes, on CUDA tensors
    (:func:`slstm_scan` passes :func:`launch_plan`'s; a tool may pass
    another, which the source checks)."""
    global launches
    _check(pre_x, r_rec)
    _build.refuse_dtensor("slstm_scan", pre_x, r_rec)
    _build.refuse_autograd("slstm_scan", 'impl="ref"', pre_x, r_rec)
    b, s, d4 = pre_x.shape
    d, n_heads = d4 // 4, r_rec.shape[0]
    if pre_x.stride(-1) != 1:
        raise ValueError("pre_x's last dimension must be contiguous")
    use_l2 = plan.design == "l2"
    if use_l2:
        if d > MAX_D[pre_x.dtype]:
            raise ValueError(f"slstm_scan's L2 kernel takes d up to "
                             f"{MAX_D[pre_x.dtype]} in {pre_x.dtype}, not "
                             f"{d}")
        if (r_rec.shape[2] * r_rec.element_size()) % 16:
            raise ValueError(f"slstm_scan's L2 kernel needs r_rec rows of "
                             f"a multiple of 16 bytes, not {r_rec.shape[2]}"
                             f" x {r_rec.element_size()}")
    r = r_rec.contiguous()
    if r.data_ptr() % 16:            # the L2 kernel's 16-byte loads
        r = r.clone()
    out = torch.empty((b, s, d), dtype=pre_x.dtype, device=pre_x.device)
    active = ctypes.c_int(0)
    with torch.cuda.device(pre_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if use_l2:
            err = _lib().slstm_scan_fwd(
                pre_x.data_ptr(), r.data_ptr(), out.data_ptr(),
                DTYPES[pre_x.dtype], b, s, d, n_heads, *pre_x.stride()[:2],
                stream)
        else:
            err = _lib().slstm_scan_cluster_fwd(
                pre_x.data_ptr(), r.data_ptr(), out.data_ptr(),
                DTYPES[pre_x.dtype], b, s, d, n_heads, *pre_x.stride()[:2],
                plan.cluster, plan.kb, ctypes.byref(active), stream)
    if err == -1:
        raise RuntimeError(f"slstm_scan: the card cannot schedule a "
                           f"cluster of {plan.cluster} CTAs with "
                           f"{plan.smem} bytes of shared memory each")
    if err != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    designs[plan.design] += 1
    return out
