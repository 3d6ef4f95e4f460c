"""Device meshes and the process groups behind them (the port of
``repro.launch.mesh``).

``make_production_mesh`` is a function, not a module constant, so that
importing this module starts no process group; the dry run starts a
fake one of 256 or 512 ranks and then calls it.

Mesh semantics (the reference's):
  * ``pod``   -- data-parallel replicas across pods (gradients cross the
    slow links)
  * ``data``  -- in-pod data parallelism
  * ``model`` -- tensor/expert/sequence parallelism inside a pod

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
default process group (NCCL on the card, gloo on the CPU): one rank a
card.  :func:`run_ranks` starts such a group, one process a rank.
"""

from __future__ import annotations

import datetime
import os
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mesh(shape: Sequence[int], names: Sequence[str],
          device_type: str) -> DeviceMesh:
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(data: int = 2, model: int = 2, *,
                   device_type: str = "cuda") -> DeviceMesh:
    """A small (data, model) mesh (needs data * model ranks)."""
    return _mesh((data, model), ("data", "model"), device_type)


def make_mesh(shape: Dict[str, int], *,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of named axes, ``{"pod": 2, "data": 2, "model": 2}``."""
    return _mesh(list(shape.values()), list(shape), device_type)


def dp_axes(mesh) -> tuple:
    """Axes that carry data parallelism (pod joins data when present)."""
    return (("pod", "data") if "pod" in mesh.mesh_dim_names
            else ("data",))


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, or of a ``{axis: size}``
    mapping (the sharding rules take either)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


# --------------------------------------------------------------------- #
# one process a rank
# --------------------------------------------------------------------- #
def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               init_file: str, out_dir: str, timeout_s: float,
               args: tuple) -> None:
    """One rank: join the group, run ``fn(rank, world, *args)``, save its
    result (or its traceback) under ``out_dir``, leave the group."""
    torch.set_num_threads(1)
    out = Path(out_dir) / f"rank{rank}.pt"
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": True, "result": result}, out)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        raise


def run_ranks(fn: Callable, world: int, *args, backend: str = "gloo",
              work_dir: str, timeout_s: float = 90.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes that
    form one process group (``backend``; the rendezvous is a file under
    ``work_dir``, so concurrent callers never share a port).  ``fn`` must
    be importable by the children.  Returns each rank's result in rank
    order; raises if a rank failed or the group did not finish within
    ``timeout_s`` (every process is stopped either way)."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    work = Path(work_dir) / f"ranks-{os.getpid()}-{time.monotonic_ns()}"
    work.mkdir(parents=True)
    init_file = work / "rendezvous"
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, backend, str(init_file), str(work),
                          timeout_s, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout_s} s")
    except ProcessException:
        pass        # a failed rank's traceback is in its result file
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
    results = []
    for rank in range(world):
        path = work / f"rank{rank}.pt"
        if not path.exists():
            raise RuntimeError(f"rank {rank} left no result")
        res = torch.load(path, weights_only=False)
        if not res["ok"]:
            raise RuntimeError(f"rank {rank} failed:\n{res['error']}")
        results.append(res["result"])
    return results
