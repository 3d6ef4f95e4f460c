"""Public entry point of the mLSTM scan.

:func:`mlstm_scan` with ``impl="kernel"`` (the default) launches a
hand-written Hopper kernel on CUDA tensors and runs the plain version in
:mod:`.ref` on CPU tensors -- the choice is made by the tensors' device
alone, and a CUDA call either launches a kernel or raises.  ``impl="ref"``
runs the plain version on any device (the card's comparison path).

Two designs, each its own source built at first use, one launch a call;
:func:`launch_plan`, a pure function of the head size and dtype, picks
one:

* ``"chunkwise"`` (bf16, P a multiple of 32 up to :data:`CHUNKWISE_MAX_P`;
  ``csrc/mlstm_chunkwise.cu``): chunks of :data:`CHUNK` steps on the
  tensor cores, 96 rows of a head's C a CTA in registers as ``mma.sync``
  accumulators, the f32 operands as bf16 hi/mid/lo triples; its plain
  version is :func:`.ref.mlstm_chunkwise_ref`;
* ``"recurrent"`` (f32, whose 5e-5 bar bf16 operands would not keep, and
  every other shape; ``csrc/mlstm_scan.cu``): the stepped recurrence, a
  CTA 32 rows of a head's C in registers, P a multiple of 32 up to
  :data:`MAX_P`.

Both read q, k and v through their batch, time and head strides (the
last dimension contiguous), so they may be views of the projections, and
the log gates through theirs.  :func:`launch` runs one launch of a given
plan (the card's check of the recurrent kernel at a shape the plan gives
the chunkwise one, ``Plan("recurrent")``); it refuses a plan the shape
does not allow.

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
from repro_torch.kernels.mlstm_scan.ref import CHUNKWISE_L, mlstm_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_scan.cu"
CHUNKWISE_SOURCE = SOURCE.parent / "mlstm_chunkwise.cu"
MAX_P = 512
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the chunkwise kernel's steps a chunk, rows of C a CTA, and the
#: head-size tiles it is built for (a P pads up to the next)
CHUNK = CHUNKWISE_L
CHUNKWISE_ROWS = 96
CHUNKWISE_TILES = (32, 128, 384)
CHUNKWISE_MAX_P = CHUNKWISE_TILES[-1]


@dataclass(frozen=True)
class Plan:
    """How :func:`mlstm_scan` launches at one shape.  ``design`` is
    ``"chunkwise"`` or ``"recurrent"``; for the chunkwise kernel (0 for
    the recurrent one) ``tile`` is the head-size tile it runs P on and
    ``ctas`` its CTAs a (batch, head)."""
    design: str
    tile: int = 0
    ctas: int = 0


def launch_plan(p: int, dtype: torch.dtype) -> Plan:
    """bf16 with P a multiple of 32 up to :data:`CHUNKWISE_MAX_P`: the
    chunkwise kernel on the narrowest tile of :data:`CHUNKWISE_TILES`
    that holds P, ``ceil(P / 96)`` CTAs a (batch, head).  Else (f32, or
    another P) the recurrent kernel."""
    if dtype not in DTYPES:
        raise TypeError(f"mlstm_scan takes float32 or bfloat16, not {dtype}")
    if p < 1:
        raise ValueError(f"head size must be positive, not {p}")
    if dtype != torch.bfloat16 or p % 32 or p > CHUNKWISE_MAX_P:
        return Plan("recurrent")
    tile = min(t for t in CHUNKWISE_TILES if t >= p)
    return Plan("chunkwise", tile, -(-p // CHUNKWISE_ROWS))


launches = 0
designs = {"chunkwise": 0, "recurrent": 0}
_lib_cache: dict = {}      # the loaded libraries, once per process


def reset_launches() -> None:
    global launches
    launches = 0
    designs.update(chunkwise=0, recurrent=0)


def _lib(design: str) -> ctypes.CDLL:
    if design not in _lib_cache:
        if design == "chunkwise":
            lib = _build.load(CHUNKWISE_SOURCE)
            lib.mlstm_chunkwise_fwd.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
            lib.mlstm_chunkwise_fwd.restype = ctypes.c_int
            lib.mlstm_chunkwise_tile.argtypes = [ctypes.c_int]
            lib.mlstm_chunkwise_tile.restype = ctypes.c_int
        else:
            lib = _build.load(SOURCE)
            lib.mlstm_scan_fwd.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
            lib.mlstm_scan_fwd.restype = ctypes.c_int
        _lib_cache[design] = lib
    return _lib_cache[design]


def _check(q, k, v, log_i, log_f) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be one (B, S, H, P) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if log_i.shape != q.shape[:3] or log_f.shape != q.shape[:3]:
        raise ValueError(f"log_i and log_f must be (B, S, H) = "
                         f"{tuple(q.shape[:3])}, got {tuple(log_i.shape)}, "
                         f"{tuple(log_f.shape)}")
    if min(q.shape) == 0:
        raise ValueError("empty batch, sequence, heads or head size")
    for name, t in (("k", k), ("v", v), ("log_i", log_i), ("log_f", log_f)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
    if q.dtype not in DTYPES:
        raise TypeError(f"mlstm_scan takes float32 or bfloat16, not "
                        f"{q.dtype}")
    for name, t in (("log_i", log_i), ("log_f", log_f)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_i: torch.Tensor, log_f: torch.Tensor, *,
               impl: str = "kernel") -> torch.Tensor:
    """q/k/v ``(B, S, H, P)``, log_i/log_f ``(B, S, H)`` f32 -> h ``(B, S,
    H, P)`` in q's dtype (see :mod:`.ref` for the semantics), on the
    kernel :func:`launch_plan` picks."""
    _check(q, k, v, log_i, log_f)
    if impl == "ref" or (impl == "kernel" and q.device.type == "cpu"):
        return mlstm_scan_ref(q, k, v, log_i, log_f)
    if impl != "kernel":
        raise ValueError(f"unknown mlstm_scan impl: {impl}")
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan runs on cpu or cuda tensors, not "
                         f"{q.device}")
    return launch(q, k, v, log_i, log_f, launch_plan(q.shape[-1], q.dtype))


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           log_i: torch.Tensor, log_f: torch.Tensor,
           plan: Plan) -> torch.Tensor:
    """One launch of the kernel ``plan`` describes, on CUDA tensors
    (:func:`mlstm_scan` passes :func:`launch_plan`'s; a tool may pass
    ``Plan("recurrent")`` at any shape that kernel takes)."""
    global launches
    _check(q, k, v, log_i, log_f)
    _build.refuse_dtensor("mlstm_scan", q, k, v, log_i, log_f)
    _build.refuse_autograd("mlstm_scan", 'impl="ref"', q, k, v, log_i,
                           log_f)
    b, s, h, p = q.shape
    if p % 32 or p > MAX_P:
        raise ValueError(f"mlstm_scan's kernel takes a head size that is a "
                         f"multiple of 32 up to {MAX_P}, not {p}")
    if b * h > 65535:
        raise ValueError(f"batch x heads {b * h} exceeds the kernel's grid "
                         f"limit of 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    chunkwise = plan.design == "chunkwise"
    if chunkwise and (q.dtype != torch.bfloat16 or p > CHUNKWISE_MAX_P):
        raise ValueError(f"mlstm_scan's chunkwise kernel takes bf16 with a "
                         f"head size up to {CHUNKWISE_MAX_P}, not "
                         f"{q.dtype} at {p}")
    if plan.design not in designs:
        raise ValueError(f"unknown mlstm_scan design {plan.design!r}")
    out = torch.empty((b, s, h, p), dtype=q.dtype, device=q.device)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *log_i.stride(), *log_f.stride())
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
            log_f.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if chunkwise:
            err = _lib("chunkwise").mlstm_chunkwise_fwd(
                *ptrs, b, s, h, p, *strides, stream)
        else:
            err = _lib("recurrent").mlstm_scan_fwd(
                *ptrs, DTYPES[q.dtype], b, s, h, p, *strides, stream)
    if err != 0:
        raise RuntimeError(f"mlstm_scan {plan.design} kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    designs[plan.design] += 1
    return out
