"""Public entry point of the decode-attention kernel.

:func:`decode_attention` with ``impl="kernel"`` (the default) launches
the hand-written Hopper kernel (``csrc/decode_attention.cu``, built at
first use) on CUDA tensors and runs the plain version in :mod:`.ref` on
CPU tensors -- the choice is made by the tensors' device alone, and a
CUDA call either launches the kernel or raises.  ``impl="ref"`` runs the
plain version on any device (the card's comparison path).

The source holds two kernels, chosen by dtype: bf16 q over a bf16 cache
(the serving path) runs its products on the tensor cores (``mma.sync``,
bf16 operands); any f32 input runs the SIMT kernel on the f32 FMA pipes,
because bf16 operands cannot meet the f32 tolerance of 5e-5.  Both copy
16-byte chunks, so q, k and v must be 16-byte aligned and a head's row
a multiple of 16 bytes (a ``ValueError`` says so).

Each kernel splits each sequence's cache rows over several CTAs
(flash-decoding) by :func:`split_plan`, which reads only shapes and the
SM count, never ``lengths``; the CTAs' partials are combined inside the
same launch by the last one to finish.  The partials' scratch and the
per-(sequence, KV head) arrival counters are held here, one buffer each
per device, grown as needed (the counters zeroed once); launches that
share them must run in stream order (the port decodes on one stream).

``launches`` counts kernel launches (never plain-version calls);
:func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_dense, decode_attention_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
MAX_HEAD_DIM = 128
MAX_GROUP = 128            # query heads per KV head
MAX_GROUP_WIDTH = 4096     # G * D: the SIMT kernel's q and P V registers
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                  # cache rows per tile, as in the CUDA kernel
MAX_SPLITS = 32            # CTAs per (sequence, KV head)
CTAS_PER_SM = 8            # what split_plan aims at

launches = 0
_lib_cache: list = []      # the loaded library, once per process
_devices: dict = {}        # device index -> _Device
_plans: dict = {}          # argument signature -> checked launch plan


class _Device:
    """A device's SM count and the kernels' scratch: f32 partials and
    int32 arrival counters (zero between launches), each grown as
    needed, with their addresses kept for the launches."""

    def __init__(self, index: int):
        self.n_sm = torch.cuda.get_device_properties(
            index).multi_processor_count
        self.scratch = self.counters = None
        self.scratch_ptr = self.counters_ptr = 0

    def pointers(self, n_floats: int, n_counters: int, device) -> tuple:
        if self.scratch is None or self.scratch.numel() < n_floats:
            self.scratch = torch.empty(n_floats, dtype=torch.float32,
                                       device=device)
            self.scratch_ptr = self.scratch.data_ptr()
        if self.counters is None or self.counters.numel() < n_counters:
            self.counters = torch.zeros(n_counters, dtype=torch.int32,
                                        device=device)
            self.counters_ptr = self.counters.data_ptr()
        return self.scratch_ptr, self.counters_ptr


def split_plan(b: int, hkv: int, s: int, n_sm: int) -> tuple:
    """``(rows_per_split, n_split)`` for ``b`` sequences of ``hkv`` KV
    heads over an ``s``-row cache on ``n_sm`` SMs: as many splits as give
    about :data:`CTAS_PER_SM` CTAs per SM, at most :data:`MAX_SPLITS` and
    at most one per 64-row tile, each a whole number of tiles.  Shapes
    only: the lengths stay on the device."""
    tiles = -(-s // TILE)
    want = min(tiles, MAX_SPLITS, max(1, -(-CTAS_PER_SM * n_sm // (b * hkv))))
    per = -(-tiles // want)
    return per * TILE, -(-tiles // per)


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load(SOURCE)
        # every pointer and the stream as c_void_p: an undeclared
        # argument would pass as a 32-bit int and cut the pointer
        lib.decode_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_float, ctypes.c_void_p])
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
    if (hq // hkv) * d > MAX_GROUP_WIDTH or hq // hkv > MAX_GROUP:
        raise ValueError(f"group {hq // hkv} x head_dim {d} exceeds the "
                         f"kernel's {MAX_GROUP} heads and width "
                         f"{MAX_GROUP_WIDTH}")
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


def _plan(q: torch.Tensor, k: torch.Tensor) -> tuple:
    """The launch's fixed arguments for one set of shapes, dtypes and
    device, and the scratch it needs: ``(device, ints, scale, n_ml,
    n_floats, pairs)``, ``ints`` the packed integers the C function
    takes."""
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    index = q.device.index
    device = _devices.get(index)
    if device is None:
        device = _devices[index] = _Device(index)
    g = hq // hkv
    # bf16 over bf16 runs the tensor-core kernel: one CTA row per 16
    # query heads of a KV head, partials in slots of min(G, 16) heads
    tc = q.dtype == k.dtype == torch.bfloat16
    tiles = -(-g // 16) if tc else 1
    slot = min(g, 16) if tc else g
    pairs = b * hkv * tiles
    rows_per_split, n_split = split_plan(b, hkv * tiles, s, device.n_sm)
    n_ml = -(-pairs * n_split * slot * 2 // 4) * 4     # float4-aligned
    n_floats = n_ml + pairs * n_split * slot * d if n_split > 1 else 0
    ints = (ctypes.c_int * 9)(DTYPES[q.dtype], DTYPES[k.dtype], b, s, hkv,
                              g, d, rows_per_split, n_split)
    return device, ints, 1.0 / (d ** 0.5), n_ml, n_floats, pairs


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     impl: str = "kernel") -> torch.Tensor:
    """q ``(B, Hq, D)``, k/v ``(B, S, Hkv, D)``, lengths ``(B,)`` ->
    ``(B, Hq, D)`` in q's dtype (see :mod:`.ref` for the semantics).

    The checks of shapes, dtypes and devices, and the launch's fixed
    arguments, are kept per argument signature: a decode step calls this
    once per layer with the same one, and its host time is the step's."""
    global launches
    if impl == "dense":
        _check(q, k, v, lengths)
        return decode_attention_dense(q, k, v, lengths)
    sig = (q.shape, k.shape, v.shape, lengths.shape, q.dtype, k.dtype,
           v.dtype, q.device, k.device, v.device, lengths.device, impl)
    plan = _plans.get(sig)
    if plan is None:
        _check(q, k, v, lengths)
        if len(_plans) > 4096:
            _plans.clear()
        plan = _plans[sig] = (_plan(q, k) if q.device.type == "cuda"
                              and impl == "kernel" else ())
    if impl == "ref" or (impl == "kernel" and q.device.type == "cpu"):
        return decode_attention_ref(q, k, v, lengths)
    if impl != "kernel":
        raise ValueError(f"unknown decode attention impl: {impl}")
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, "
                         f"not {q.device}")
    _build.refuse_dtensor("decode_attention", q, k, v, lengths)
    _build.refuse_autograd("decode_attention", 'impl="ref"', q, k, v)
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    d = q.shape[2]
    if ((d * k.element_size()) % 16
            or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError(f"decode_attention's kernels copy 16-byte chunks "
                         f"of q and of cache rows: q, k and v must be "
                         f"16-byte aligned and head_dim {d} x "
                         f"{k.element_size()} bytes a multiple of 16")
    device, ints, scale, n_ml, n_floats, pairs = plan
    part_ml = part_acc = counters = None
    if n_floats:
        part_ml, counters = device.pointers(n_floats, pairs, q.device)
        part_acc = part_ml + 4 * n_ml
    out = torch.empty_like(q)
    index = q.device.index
    on_device = (contextlib.nullcontext()
                 if index == torch.cuda.current_device()
                 else torch.cuda.device(index))
    with on_device:
        err = _lib().decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part_ml, part_acc, counters, ints, scale,
            torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
