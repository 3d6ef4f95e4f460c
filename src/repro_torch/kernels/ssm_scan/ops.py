"""Public entry points of the selective scan (the port of
``repro.kernels.ssm_scan.ops``).

:func:`ssm_scan` with ``impl="kernel"`` (the default) launches the
hand-written Hopper kernel (``csrc/ssm_scan.cu``, built at first use) on
CUDA tensors and runs the plain version in :mod:`.ref` on CPU tensors --
the choice is made by the tensors' device alone, and a CUDA call either
launches the kernel or raises.  ``impl="ref"`` runs the plain version on
any device (the card's comparison path).

The kernel reads x, dt, b and c through their strides (the last dimension
must be contiguous), so b and c may be column slices of the Mamba layer's
``x_proj`` output without a copy.  It stages them in shared memory
:data:`CHUNK` steps at a time with 16-byte copies where their addresses
and strides are 16-byte aligned (by plain loads where not), and a CTA
covers :data:`TILE` channels of one sequence.

:func:`single_step` is the one-token decode form, plain torch as in the
reference.

``launches`` counts kernel launches (never plain-version calls);
:func:`reset_launches` zeroes it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
MAX_STATE = 16
TILE = 256         # channels per CTA: 128 threads of 2 (csrc constants)
CHUNK = 16         # steps staged in shared memory at a time
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
        lib.ssm_scan_fwd.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])
        lib.ssm_scan_fwd.restype = ctypes.c_int
        _lib_cache.append(lib)
    return _lib_cache[0]


def _check(x, dt, b, c, a, d) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x and dt must be one (BH, T, P) shape, got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}")
    bh, t, p = x.shape
    if b.dim() != 3 or b.shape[:2] != (bh, t) or c.shape != b.shape:
        raise ValueError(f"b and c must be one (BH, T, N) shape matching "
                         f"x {tuple(x.shape)}, got {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    n = b.shape[-1]
    if tuple(a.shape) != (p, n) or tuple(d.shape) != (p,):
        raise ValueError(f"a must be (P, N) = {(p, n)} and d (P,), got "
                         f"{tuple(a.shape)}, {tuple(d.shape)}")
    if min(bh, t, p, n) == 0:
        raise ValueError("empty batch, sequence, channels or state")
    for name, t_ in (("dt", dt), ("b", b), ("c", c), ("a", a), ("d", d)):
        if t_.device != x.device:
            raise ValueError(f"{name} is on {t_.device}, x on {x.device}")
    for name, t_ in (("dt", dt), ("b", b), ("c", c)):
        if t_.dtype != x.dtype:
            raise TypeError(f"{name} is {t_.dtype}, x {x.dtype}")
    if x.dtype not in DTYPES:
        raise TypeError(f"ssm_scan takes float32 or bfloat16, not "
                        f"{x.dtype}")


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor, d: torch.Tensor, *,
             impl: str = "kernel") -> torch.Tensor:
    """x/dt ``(BH, T, P)``, b/c ``(BH, T, N)``, a ``(P, N)``, d ``(P,)``
    -> y ``(BH, T, P)`` in x's dtype (see :mod:`.ref` for the
    semantics)."""
    global launches
    _check(x, dt, b, c, a, d)
    if impl == "ref" or (impl == "kernel" and x.device.type == "cpu"):
        return ssm_scan_ref(x, dt, b, c, a, d)
    if impl != "kernel":
        raise ValueError(f"unknown ssm impl: {impl}")
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cpu or cuda tensors, not "
                         f"{x.device}")
    _build.refuse_dtensor("ssm_scan", x, dt, b, c, a, d)
    _build.refuse_autograd("ssm_scan", 'impl="ref"', x, dt, b, c, a, d)
    bh, t, p = x.shape
    n = b.shape[-1]
    if n > MAX_STATE:
        raise ValueError(f"state size {n} exceeds the kernel's "
                         f"{MAX_STATE}")
    for name, t_ in (("x", x), ("dt", dt), ("b", b), ("c", c)):
        if t_.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    af = a.float().contiguous()
    df = d.float().contiguous()
    out = torch.empty((bh, t, p), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().ssm_scan_fwd(
            x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
            af.data_ptr(), df.data_ptr(), out.data_ptr(), DTYPES[x.dtype],
            bh, t, p, n, *x.stride()[:2], *dt.stride()[:2],
            *b.stride()[:2], *c.stride()[:2], stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


def single_step(h: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
                b_t: torch.Tensor, c_t: torch.Tensor, a: torch.Tensor,
                d: torch.Tensor, x_f32: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: h ``(BH, P, N)`` f32, x_t/dt_t ``(BH, P)``,
    b_t/c_t ``(BH, N)`` -> ``(h, y)`` with y ``(BH, P)`` in x_t's dtype.

    Unlike the reference, ``h`` is updated IN PLACE (the returned ``h``
    is the argument).  Rounding follows the reference's compiled decode
    step, where XLA drops a rounding to x_t's dtype that an f32 convert
    follows at once: ``dt_t * x_t`` is taken in f32, and the skip term
    reads ``x_f32``, x_t before its rounding, where the caller has it."""
    da = torch.exp(dt_t[..., None].float() * a.float())
    h.mul_(da).add_((dt_t.float() * x_t.float())[..., None]
                    * b_t.float()[:, None, :])
    y = (h * c_t.float()[:, None, :]).sum(dim=-1) \
        + d.float() * (x_t.float() if x_f32 is None else x_f32)
    return h, y.to(x_t.dtype)
