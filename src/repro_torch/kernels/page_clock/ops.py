"""Public entry point of the page-granular busy-clock kernel.

:func:`simulate_fleet` with ``impl="kernel"`` (the default) launches the
hand-written Hopper kernel (``csrc/page_clock.cu``, built at first use) on
CUDA tensors and runs the plain version in :mod:`.ref` on CPU tensors --
the choice is made by the tensors' device alone, and a CUDA call either
launches the kernel or raises.  ``impl="ref"`` runs the plain version on
any device (the card's comparison path).

One CTA a device row, one launch a call.  The CTA first reads its row
once: it checks every index and records each LUN's channel.  Where no LUN
of the row meets two channels (and the row has at most
:data:`MAX_CHAINS` channels), each channel's requests form a chain of
their own -- they share no clock with another channel's -- and one
thread steps each chain in stream order (its clocks in registers where
its channel has at most two LUNs); otherwise one thread steps the whole
row in order.  Either way every
clock sees the same f32 operations in the same order as in the plain
version, so the two are equal bit for bit (``csrc/page_clock.cu``'s
header gives the argument).  A request whose LUN, channel or op is out
of range raises ``IndexError`` after the launch (the kernel sets an
error word the wrapper reads back), as the plain version's indexing
does.  The four request arrays are passed contiguous and 16-byte aligned
(the kernel's 16-byte loads); a view that is not is copied first.

``launches`` counts kernel launches (never plain-version calls) and
``rows`` the device rows each path stepped (``"chains"``, ``"whole"``, as
the kernel reports them); :func:`reset_launches` zeroes both.  ``_plans``
keeps one launch plan per argument signature (shape, dtypes, resources,
device), which ``repro_torch.obs.profile`` counts as this kernel's launch
plans.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.page_clock.ref import simulate_fleet_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "page_clock.cu"
MAX_RESOURCES = 1024     # LUNs, and channels: the kernel's shared clocks
MAX_CHAINS = 32          # channels a row stepped one chain a channel

F32 = torch.float32

launches = 0
rows = {"chains": 0, "whole": 0}
_lib_cache: list = []      # the loaded library, once per process
_plans: dict = {}          # argument signature -> launch integers


def reset_launches() -> None:
    global launches
    launches = 0
    rows.update(chains=0, whole=0)


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load(SOURCE)
        # every pointer and the stream as c_void_p: an undeclared argument
        # would pass as a 32-bit int and cut the pointer
        lib.page_clock_fwd.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        lib.page_clock_fwd.restype = ctypes.c_int
        _lib_cache.append(lib)
    return _lib_cache[0]


def _check(ops, luns, channels, valid, n_luns: int, n_channels: int) -> None:
    if ops.dim() != 2:
        raise ValueError(f"ops must be (n_dev, n), got {tuple(ops.shape)}")
    for name, t in (("luns", luns), ("channels", channels),
                    ("valid", valid)):
        if t.shape != ops.shape:
            raise ValueError(f"{name} must have ops' shape "
                             f"{tuple(ops.shape)}, got {tuple(t.shape)}")
        if t.device != ops.device:
            raise ValueError(f"{name} is on {t.device}, ops on "
                             f"{ops.device}")
    if n_luns < 1 or n_channels < 1:
        raise ValueError(f"need at least one LUN and one channel, got "
                         f"{n_luns} and {n_channels}")


def _plan(ops, luns, channels, valid, n_luns: int, n_channels: int
          ) -> ctypes.Array:
    sig = (tuple(ops.shape), ops.dtype, luns.dtype, channels.dtype,
           valid.dtype, n_luns, n_channels, ops.device)
    ints = _plans.get(sig)
    if ints is not None:
        return ints
    for name, t in (("ops", ops), ("luns", luns), ("channels", channels)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if max(n_luns, n_channels) > MAX_RESOURCES:
        raise ValueError(f"{n_luns} LUNs / {n_channels} channels exceed "
                         f"the kernel's {MAX_RESOURCES}")
    if len(_plans) > 4096:
        _plans.clear()
    ints = _plans[sig] = (ctypes.c_int * 4)(ops.shape[0], ops.shape[1],
                                            n_luns, n_channels)
    return ints


def simulate_fleet(ops: torch.Tensor, luns: torch.Tensor,
                   channels: torch.Tensor, valid: torch.Tensor,
                   t_op, t_xfer, n_luns: int, n_channels: int, *,
                   impl: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """Page-granular busy clocks for a batch of independent devices (see
    :func:`.ref.simulate_fleet_ref` for the arguments and the result)."""
    global launches
    _check(ops, luns, channels, valid, n_luns, n_channels)
    dev = ops.device
    if impl == "ref" or (impl == "kernel" and dev.type == "cpu"):
        return simulate_fleet_ref(ops, luns, channels, valid, t_op, t_xfer,
                                  n_luns, n_channels)
    if impl != "kernel":
        raise ValueError(f"unknown page_clock impl: {impl}")
    _build.refuse_dtensor("page_clock", ops, luns, channels, valid)
    if dev.type != "cuda":
        raise ValueError(f"page_clock runs on cpu or cuda tensors, not "
                         f"{dev}")
    ints = _plan(ops, luns, channels, valid, n_luns, n_channels)
    n_dev, n = ops.shape
    done = torch.empty((n_dev, n), dtype=F32, device=dev)
    makespan = torch.empty(n_dev, dtype=F32, device=dev)
    if n_dev == 0:
        return done, makespan
    t_op = torch.as_tensor(t_op, dtype=F32, device=dev).contiguous()
    t_xfer = torch.as_tensor(t_xfer, dtype=F32, device=dev)
    if t_op.shape != (3,) or t_xfer.dim() != 0:
        raise ValueError(f"t_op must be (3,) and t_xfer a scalar, got "
                         f"{tuple(t_op.shape)} and {tuple(t_xfer.shape)}")
    ops, luns, channels, valid = (
        t if t.data_ptr() % 16 == 0 else t.clone()
        for t in (x.contiguous() for x in (ops, luns, channels, valid)))
    err = torch.zeros(1 + n_dev, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = _lib().page_clock_fwd(
            ops.data_ptr(), luns.data_ptr(), channels.data_ptr(),
            valid.data_ptr(), t_op.data_ptr(), t_xfer.data_ptr(),
            done.data_ptr(), makespan.data_ptr(), err.data_ptr(), ints,
            stream)
    if code != 0:
        raise RuntimeError(f"page_clock kernel launch failed: CUDA error "
                           f"{code}")
    launches += 1
    flags = err.cpu()
    rows["chains"] += int((flags[1:] == 1).sum())
    rows["whole"] += int((flags[1:] == 2).sum())
    if int(flags[0]):
        raise IndexError(f"page_clock: a request's LUN, channel or op is "
                         f"out of range ({n_luns} LUNs, {n_channels} "
                         f"channels, 3 ops)")
    return done, makespan
