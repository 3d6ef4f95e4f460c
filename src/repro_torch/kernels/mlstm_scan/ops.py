"""Public entry point of the mLSTM scan.

:func:`mlstm_scan` with ``impl="kernel"`` (the default) launches the
hand-written Hopper kernel (``csrc/mlstm_scan.cu``, built at first use)
on CUDA tensors and runs the plain version in :mod:`.ref` on CPU tensors
-- the choice is made by the tensors' device alone, and a CUDA call
either launches the kernel or raises.  ``impl="ref"`` runs the plain
version on any device (the card's comparison path).

The kernel reads q, k and v through their batch, time and head strides
(the last dimension contiguous), so they may be views of the
projections, and the log gates through theirs.  A CTA holds 32 rows of
one head's state in registers; the head size P must be a multiple of 32
up to :data:`MAX_P`.

``launches`` counts kernel launches (never plain-version calls);
:func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_scan.cu"
MAX_P = 512
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_lib_cache: list = []      # the loaded library, once per process


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load(SOURCE)
        lib.mlstm_scan_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
        lib.mlstm_scan_fwd.restype = ctypes.c_int
        _lib_cache.append(lib)
    return _lib_cache[0]


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
    H, P)`` in q's dtype (see :mod:`.ref` for the semantics)."""
    global launches
    _check(q, k, v, log_i, log_f)
    if impl == "ref" or (impl == "kernel" and q.device.type == "cpu"):
        return mlstm_scan_ref(q, k, v, log_i, log_f)
    if impl != "kernel":
        raise ValueError(f"unknown ssm impl: {impl}")
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan runs on cpu or cuda tensors, not "
                         f"{q.device}")
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
    out = torch.empty((b, s, h, p), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().mlstm_scan_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
            log_f.data_ptr(), out.data_ptr(), DTYPES[q.dtype], b, s, h, p,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *log_i.stride(), *log_f.stride(), stream)
    if err != 0:
        raise RuntimeError(f"mlstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
