"""Public entry point of the sLSTM scan.

:func:`slstm_scan` with ``impl="kernel"`` (the default) launches the
hand-written Hopper kernel (``csrc/slstm_scan.cu``, built at first use)
on CUDA tensors and runs the plain version in :mod:`.ref` on CPU tensors
-- the choice is made by the tensors' device alone, and a CUDA call
either launches the kernel or raises.  ``impl="ref"`` runs the plain
version on any device (the card's comparison path).

The input projection ``pre_x = x @ w_in`` is the caller's (one product
for every step, before the loop); the kernel reads it through its batch
and time strides.  One CTA steps one sequence, the whole ``h_prev``
exchanged through its shared memory; d is at most :data:`MAX_D` of the
dtype (a thread for each 16 bytes of a gate row) and ``r_rec``'s rows
must be a multiple of 16 bytes (an even head size in bf16).

``launches`` counts kernel launches (never plain-version calls);
:func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "slstm_scan.cu"
MAX_D = {torch.float32: 1024, torch.bfloat16: 2048}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_lib_cache: list = []      # the loaded library, once per process


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load(SOURCE)
        lib.slstm_scan_fwd.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
        lib.slstm_scan_fwd.restype = ctypes.c_int
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
    pre_x's dtype (see :mod:`.ref` for the semantics)."""
    global launches
    _check(pre_x, r_rec)
    n_heads = r_rec.shape[0]
    if impl == "ref" or (impl == "kernel" and pre_x.device.type == "cpu"):
        return slstm_scan_ref(pre_x, r_rec, n_heads)
    if impl != "kernel":
        raise ValueError(f"unknown ssm impl: {impl}")
    if pre_x.device.type != "cuda":
        raise ValueError(f"slstm_scan runs on cpu or cuda tensors, not "
                         f"{pre_x.device}")
    _build.refuse_dtensor("slstm_scan", pre_x, r_rec)
    _build.refuse_autograd("slstm_scan", 'impl="ref"', pre_x, r_rec)
    b, s, d4 = pre_x.shape
    d = d4 // 4
    if d > MAX_D[pre_x.dtype]:
        raise ValueError(f"slstm_scan's kernel takes d up to "
                         f"{MAX_D[pre_x.dtype]} in {pre_x.dtype}, not {d}")
    if (r_rec.shape[2] * r_rec.element_size()) % 16:
        raise ValueError(f"slstm_scan's kernel needs r_rec rows of a "
                         f"multiple of 16 bytes, not {r_rec.shape[2]} x "
                         f"{r_rec.element_size()}")
    if pre_x.stride(-1) != 1:
        raise ValueError("pre_x's last dimension must be contiguous")
    r = r_rec.contiguous()
    if r.data_ptr() % 16:            # the kernel's 16-byte loads
        r = r.clone()
    out = torch.empty((b, s, d), dtype=pre_x.dtype, device=pre_x.device)
    with torch.cuda.device(pre_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().slstm_scan_fwd(
            pre_x.data_ptr(), r.data_ptr(), out.data_ptr(),
            DTYPES[pre_x.dtype], b, s, d, n_heads, *pre_x.stride()[:2],
            stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
