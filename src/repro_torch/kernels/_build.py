"""Build a kernel's CUDA source into a C-interface shared library.

Each kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/kernels/<name>-<hash>.so`` at the root of the checkout (the hash
covers the source, the headers beside it in its ``csrc/`` and the flags,
so an edited source or header builds anew), and loaded with ``ctypes``.
Nothing here runs when a module is imported: the CPU tests import every
module on a machine with no compiler.  :data:`BUILDS` counts the ``nvcc``
runs of this process and their seconds (``repro_torch.obs.profile``
reads them as compile time).  :func:`refuse_autograd` is the wrappers'
shared guard against launching a forward-only kernel under autograd.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[Path, ctypes.CDLL] = {}
#: ``nvcc`` builds run by :func:`build` in this process, and their wall
#: seconds summed (builds started together overlap, so the sum may exceed
#: the time they took)
BUILDS = {"count": 0, "seconds": 0.0}
_builds_lock = threading.Lock()


def nvcc() -> str:
    """The ``nvcc`` on ``PATH``, else the one under ``$CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.is_file():
        raise RuntimeError(f"nvcc not found on PATH or at {path}; the "
                           f"CUDA kernels build only where the CUDA "
                           f"toolkit is installed")
    return str(path)


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")) + sorted(
            source.parent.glob("*.h")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its library is already built; returns
    the library's path.  The build writes a temporary file and renames
    it, so concurrent builders never load a half-written library."""
    out = library_path(source)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        with _builds_lock:
            BUILDS["count"] += 1
            BUILDS["seconds"] += time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def resource_usage(source: Path) -> Dict[str, dict]:
    """Each kernel's registers, spill bytes and shared memory as ``ptxas
    -v`` reports them, compiling ``source`` for ``sm_90a`` to a
    throw-away cubin: ``{mangled name: {"registers", "spill_stores",
    "spill_loads", "smem"}}``."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [nvcc(), *[f for f in NVCC_FLAGS if f not in ("-shared",
                                                         "-Xcompiler",
                                                         "-fPIC")],
             "-cubin", "-Xptxas", "-v", "-o", str(Path(tmp) / "k.cubin"),
             str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return parse_ptxas(proc.stdout + proc.stderr)


def parse_ptxas(text: str) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(m.group(1)) if m else 0
    return out


def load(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load ``source``'s library, once per
    process."""
    path = build(source)
    lib = _loaded.get(path)
    if lib is None:
        lib = _loaded[path] = ctypes.CDLL(str(path))
    return lib


def refuse_autograd(kernel: str, plain: str, *tensors) -> None:
    """Raise where a launch of ``kernel`` would drop gradients: grad mode
    is on and an input requires grad.  The kernels are forward-only and
    reached through ``ctypes``, so their outputs carry no ``grad_fn``; a
    train step through one would lose every gradient upstream of it
    without an error.  ``plain`` names the differentiable path to use."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward and an input "
            f"requires grad; use {plain} (plain PyTorch under autograd), "
            f"or call it under torch.no_grad()")


def refuse_dtensor(kernel: str, *tensors) -> None:
    """Raise where a launch of ``kernel`` would get a placed tensor (a
    DTensor, ``launch.sharding``): a kernel reads one device's memory
    through raw pointers, and a DTensor's pointer is its local shard, not
    the tensor.  The distributed paths run the plain versions; kernels on
    local shards are later work."""
    from repro_torch.models.shards import is_dtensor
    for t in tensors:
        if is_dtensor(t):
            raise TypeError(f"{kernel}: the CUDA kernel takes plain "
                            f"tensors, not a DTensor; run the plain "
                            f"version (impl=\"ref\") on a sharded path")
