"""Build a kernel's CUDA source into a C-interface shared library.

Each kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/kernels/<name>-<hash>.so`` at the root of the checkout (the hash
covers the source and the flags, so an edited source builds anew), and
loaded with ``ctypes``.  Nothing here runs when a module is imported: the
CPU tests import every module on a machine with no compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[Path, ctypes.CDLL] = {}


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
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


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
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load ``source``'s library, once per
    process."""
    path = build(source)
    lib = _loaded.get(path)
    if lib is None:
        lib = _loaded[path] = ctypes.CDLL(str(path))
    return lib
