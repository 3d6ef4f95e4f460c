"""Public entry point of the decode-attention kernel.

:func:`decode_attention` with ``impl="kernel"`` (the default) launches
the hand-written Hopper kernel (``csrc/decode_attention.cu``, built at
first use) on CUDA tensors and runs the plain version in :mod:`.ref` on
CPU tensors -- the choice is made by the tensors' device alone, and a
CUDA call either launches the kernel or raises.  ``impl="ref"`` runs the
plain version on any device (the card's comparison path).

``launches`` counts kernel launches (never plain-version calls);
:func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
MAX_HEAD_DIM = 128
MAX_GROUP_WIDTH = 4096     # G * D: 256 threads x 16 register pairs
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_lib_cache: list = []      # the loaded library, once per process


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load(SOURCE)
        # every pointer and the stream as c_void_p: an undeclared
        # argument would pass as a 32-bit int and cut the pointer
        lib.decode_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p])
        lib.decode_attention_fwd.restype = ctypes.c_int
        _lib_cache.append(lib)
    return _lib_cache[0]


def _check(q, k, v, lengths) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Hq, D) and k/v one (B, S, Hkv, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, d = q.shape
    bk, s, hkv, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head_dim")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} must be in [1, {MAX_HEAD_DIM}]")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq {hq} must be a multiple of Hkv {hkv}")
    if (hq // hkv) * d > MAX_GROUP_WIDTH:
        raise ValueError(f"group {hq // hkv} x head_dim {d} exceeds the "
                         f"kernel's {MAX_GROUP_WIDTH}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must have shape ({b},), got "
                         f"{tuple(lengths.shape)}")
    if min(b, s) == 0:
        raise ValueError("empty batch or cache")
    for name, t in (("q", q), ("k", k)):
        if t.dtype not in DTYPES:
            raise TypeError(f"decode_attention takes float32 or bfloat16 "
                            f"{name}, not {t.dtype}")
    if v.dtype != k.dtype:
        raise TypeError(f"v is {v.dtype}, k {k.dtype}")
    for name, t in (("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     impl: str = "kernel") -> torch.Tensor:
    """q ``(B, Hq, D)``, k/v ``(B, S, Hkv, D)``, lengths ``(B,)`` ->
    ``(B, Hq, D)`` in q's dtype (see :mod:`.ref` for the semantics)."""
    global launches
    _check(q, k, v, lengths)
    if impl == "ref" or (impl == "kernel" and q.device.type == "cpu"):
        return decode_attention_ref(q, k, v, lengths)
    if impl != "kernel":
        raise ValueError(f"unknown decode attention impl: {impl}")
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, "
                         f"not {q.device}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), DTYPES[q.dtype], DTYPES[k.dtype], b, s, hkv,
            hq // hkv, d, 1.0 / (d ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
