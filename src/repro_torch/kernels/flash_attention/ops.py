"""Public entry point of the flash-attention (prefill) kernel.

:func:`attention` with ``impl="kernel"`` (the default) launches the
hand-written Hopper kernel (``csrc/flash_attention.cu``, built at first
use) on CUDA tensors and runs the plain version in :mod:`.ref` on CPU
tensors -- the choice is made by the tensors' device alone, and a CUDA
call either launches the kernel or raises (among other reasons when
autograd would need the output's gradient: the kernel has no backward).
``impl="ref"`` runs the plain version on any device (the card's
comparison path), ``impl="qchunk"`` the training path,
:func:`.ref.attention_qchunk`.

The kernel reads q, k and v through their strides (the last dimension
must be contiguous), so a ``(B, S, H, D)`` projection viewed as
``(B, H, S, D)`` needs no copy; the output takes q's layout.

The source holds two kernels, chosen here by dtype: bf16 (the serving
dtype) runs on the tensor cores (wgmma, with cp.async copies of
16-byte chunks, so its pointers and batch/head/row strides must be
multiples of 16 bytes -- a ``ValueError`` names what is not; the source
picks one of two tile plans by head_dim, D <= 128 or 128 < D <=
:data:`MAX_HEAD_DIM`, MLA's nope + rope); f32 runs
the SIMT kernel on the f32 FMA pipes, because tensor-core operands (bf16
or tf32) cannot meet the f32 tolerance of 5e-5.

``launches`` counts kernel launches (never plain-version calls);
:func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_qchunk,
                                                      attention_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 192
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_lib_cache: list = []      # the loaded library, once per process


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load(SOURCE)
        # every pointer and the stream as c_void_p, every stride as a
        # 64-bit int: undeclared arguments would pass as 32-bit ints
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_float,
                                          ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        _lib_cache.append(lib)
    return _lib_cache[0]


def _check(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Hq, S, D) and k/v one (B, Hkv, "
                         f"Sk, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    bk, hkv, sk, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head_dim")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be in [1, {MAX_HEAD_DIM}]")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq {hq} must be a multiple of Hkv {hkv}")
    if causal and s > sk:
        raise ValueError(f"causal attention needs S <= Sk, got S {s} > "
                         f"Sk {sk}")
    if min(b, s, sk) == 0:
        raise ValueError("empty batch or sequence")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16, not "
                        f"{q.dtype}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, impl: str = "kernel") -> torch.Tensor:
    """q ``(B, Hq, S, D)``, k/v ``(B, Hkv, Sk, D)`` -> ``(B, Hq, S, D)``
    in q's dtype (see :mod:`.ref` for the semantics)."""
    global launches
    _check(q, k, v, causal)
    if impl == "qchunk":
        return attention_qchunk(q, k, v, causal=causal)
    if impl == "ref" or (impl == "kernel" and q.device.type == "cpu"):
        return attention_ref(q, k, v, causal=causal)
    if impl != "kernel":
        raise ValueError(f"unknown attention impl: {impl}")
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda tensors, not "
                         f"{q.device}")
    _build.refuse_dtensor("attention", q, k, v)
    _build.refuse_autograd("attention", 'impl="qchunk" or impl="ref"', q, k,
                           v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    b, hq, s, d = q.shape
    _, hkv, sk, _ = k.shape
    out = torch.empty_like(q)      # q's layout when dense, else contiguous
    if q.dtype == torch.bfloat16:
        if d % 8:
            raise ValueError(f"flash_attention's bf16 kernel copies 16-byte "
                             f"chunks: head_dim {d} must be a multiple of 8")
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
            if t.data_ptr() % 16 or any(x % 8 for x in t.stride()[:3]):
                raise ValueError(
                    f"flash_attention's bf16 kernel copies 16-byte chunks: "
                    f"{name}'s data pointer and batch/head/row strides "
                    f"{t.stride()[:3]} must be multiples of 16 bytes")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], b, hq, hkv, s, sk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), 1.0 / (d ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
