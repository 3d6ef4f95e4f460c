"""Fault-tolerant checkpointing with a zoned-storage backend (the port of
``repro.train.checkpoint``).

The manager

* serializes the ``{"params": model, "opt": AdamWState}`` tree (or any
  tree of dicts, lists, tuples, tensors and numpy arrays) to per-leaf
  ``.npy`` files under ``<dir>/step_<n>/`` with a ``manifest.json``, in
  the reference's layout and leaf keys -- a checkpoint either package
  writes restores in the other; the manifest is written last and the
  directory published by an atomic rename, so a crash mid-save never
  corrupts the latest restorable checkpoint;
* saves asynchronously: the copy to the host is synchronous, the disk
  I/O runs on a worker thread, double-buffered (at most one save
  outstanding);
* mirrors every byte through a simulated ZNS device (:class:`ZNSTelemetry`,
  ``ZoneFS`` with lifetime hints: checkpoints medium-lived) so the DLWA
  and zone resets of the checkpoint cadence are measured -- the paper's
  workload for a training cluster;
* restores in place: the leaves are read as host numpy arrays and copied
  into the tree it is given;
* shards: a placed (DTensor) tree is gathered whole on the calling
  thread and written by rank 0 alone, and a restore places the state
  on the current mesh by the sharding rules (elastic restore: the mesh
  may differ from the saver's).

Leaf keys are the reference's ``_key_str`` of the JAX tree path: dict
keys and list indices joined by ``.``, and a NamedTuple field printed as
JAX prints it, ``.mu`` -- so the moments' keys read ``opt..mu.slots.0...``.
The model's tree is the reference's (``transformer.params_to_numpy``:
per-slot leaves stacked over repetitions).  bf16 leaves are written as
their uint16 bit patterns with ``"bfloat16"`` in the manifest (the
reference writes them as 2-byte void records; either reads both), so no
``ml_dtypes`` is needed.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import distribute_tensor

from repro_torch.core import SUPERBLOCK, ZNSDevice, zn540
from repro_torch.core.backend import ZoneBackend, set_stream_class
from repro_torch.core.elements import ElementSpec
from repro_torch.models import shards
from repro_torch.models import transformer as T
from repro_torch.storage.zonefs import ZoneFS
from repro_torch.train.optimizer import AdamWState

LIFETIME_CKPT = 2      # medium-lived: deleted when rotated out
LIFETIME_LOG = 0       # short-lived: step logs / WAL-ish appends


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _host(tree, leaf=None, stack=np.stack):
    """``tree`` in the reference's nested layout, each tensor through
    ``leaf``: by default whole, as its numpy array (bf16 as uint16), a
    model as ``transformer.params_to_numpy`` gives it."""
    leaf = leaf or (lambda t: T._to_numpy(shards.whole(t)))
    if isinstance(tree, nn.Module):
        return T.params_to_tree(tree, leaf, stack)
    if isinstance(tree, dict):
        return {k: _host(v, leaf, stack) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_host(v, leaf, stack) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v, leaf, stack) for v in tree)
    if isinstance(tree, torch.Tensor):
        return leaf(tree)
    return np.asarray(tree)


def _gather_only(t: torch.Tensor) -> None:
    """Take part in ``t``'s gather (a collective every rank calls) and
    keep nothing: a rank that does not write holds no host copy."""
    shards.whole(t)


def _shapes(tree):
    """``tree``'s leaves as ``meta`` tensors of their whole shapes (no
    gather)."""
    return _host(tree, lambda t: torch.empty(t.shape, device="meta"),
                 torch.stack)


def _map_leaves(tree, fn, path: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf replaced by ``fn(key, leaf)``,
    visited in ``jax.tree_util.tree_flatten_with_path``'s order (dict
    keys sorted) under the reference's ``_key_str`` keys."""
    if isinstance(tree, dict):
        return {k: _map_leaves(tree[k], fn, path + (str(k),))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_leaves(v, fn, path + (f".{f}",))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(".".join(path), tree)


def _flatten(tree) -> List[Tuple[str, np.ndarray]]:
    """(key, leaf) in the reference's order."""
    out: List[Tuple[str, np.ndarray]] = []
    _map_leaves(tree, lambda key, leaf: out.append((key, leaf)))
    return out


def _copy_into(p: torch.Tensor, full: torch.Tensor) -> None:
    """``p`` takes ``full``'s values: a placed ``p`` (a DTensor) its own
    shard of them, cut locally."""
    if shards.is_dtensor(p):
        local = p.to_local()
        local.copy_(distribute_tensor(
            full.to(local.device), p.device_mesh, p.placements,
            src_data_rank=None).to_local())
    else:
        p.copy_(full)


@torch.no_grad()
def _assign(like, host):
    """Copy the host tree ``host`` into ``like`` in place; returns the
    updated ``like`` (numpy leaves of ``like`` are replaced).  A placed
    leaf takes its shard of the saved whole."""
    if isinstance(like, nn.Module):
        loaded = dict(T.params_from_numpy(like.cfg, host,
                                          device="cpu").named_parameters())
        for name, p in like.named_parameters():
            _copy_into(p, loaded[name])
        return like
    if isinstance(like, dict):
        return {k: _assign(v, host[k]) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_assign(v, h) for v, h in zip(like, host)))
    if isinstance(like, (list, tuple)):
        return type(like)(_assign(v, h) for v, h in zip(like, host))
    if isinstance(like, torch.Tensor):
        _copy_into(like, T._from_numpy(host, "cpu"))
        return like
    return host


def _place(tree, shardings):
    """Place ``tree``'s models and optimizer states on the meshes of
    ``shardings`` (a ``DeviceMesh``, or a prefix of ``tree`` whose leaves
    are meshes or None) by the sharding rules, in place
    (``launch.sharding.shard_model`` / ``shard_opt_state``); a model or
    state already placed keeps its placement."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch import sharding as SH
    if shardings is None:
        return tree
    if isinstance(shardings, DeviceMesh):
        if isinstance(tree, nn.Module):
            placed = any(map(shards.is_dtensor, tree.parameters()))
            return tree if placed else SH.shard_model(tree, shardings)
        if isinstance(tree, AdamWState):
            return SH.shard_opt_state(tree, shardings)
        if isinstance(tree, dict):
            return {k: _place(v, shardings) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_place(v, shardings) for v in tree)
        return tree
    if isinstance(tree, dict):
        return {k: _place(v, shardings.get(k)) for k, v in tree.items()}
    return type(tree)(_place(v, s) for v, s in zip(tree, shardings))


class ZNSTelemetry:
    """Mirrors checkpoint I/O into an emulated SilentZNS/baseline backend.

    ``backend`` accepts any :class:`ZoneBackend` (a ZNS-RAID array, for
    one); the default is one zn540 :class:`ZNSDevice` on ``device``."""

    def __init__(self, element: ElementSpec = SUPERBLOCK,
                 finish_threshold: float = 0.1,
                 backend: Optional[ZoneBackend] = None, *,
                 device="cuda"):
        if backend is None:
            flash, zone = zn540()
            backend = ZNSDevice(flash, zone, element, max_active=14,
                                device=device)
        self.dev = backend
        self.fs = ZoneFS(self.dev, finish_threshold=finish_threshold)
        self._next_file = 0
        self.file_ids: Dict[str, int] = {}

    def write_file(self, name: str, nbytes: int, lifetime: int) -> None:
        set_stream_class(self.dev,
                         "ckpt" if lifetime == LIFETIME_CKPT else "log")
        self._next_file += 1
        pages = max(1, nbytes // self.dev.flash.page_bytes)
        self.fs.create(self._next_file, pages, lifetime)
        self.file_ids[name] = self._next_file

    def delete_file(self, name: str) -> None:
        fid = self.file_ids.pop(name, None)
        if fid is not None:
            self.fs.delete(fid)

    def report(self) -> Dict[str, float]:
        return self.fs.report()


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 async_save: bool = True,
                 zns: Optional[ZNSTelemetry] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self.zns = zns
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.save_seconds = 0.0
        self.saves = 0
        self.bytes_saved = 0

    # ------------------------------------------------------------------ #
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def all_steps(self) -> list:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any, meta: Optional[Dict] = None
             ) -> None:
        """Snapshot ``tree`` at ``step``.  Blocks only for the copy to the
        host (and for the previous save, if it is still writing).  A
        placed (sharded) tree is gathered whole here, on the calling
        thread of every rank -- the writer thread runs no collective --
        and only rank 0 copies it to the host and writes (and mirrors
        through ``zns``), so a
        sharded run's files, bytes and zone traffic are the unsharded
        run's."""
        self.wait()  # double-buffer: at most one outstanding save
        if dist.is_initialized() and dist.get_rank() != 0:
            _host(tree, _gather_only, lambda leaves: None)
            return
        host = _flatten(_host(tree))

        def write() -> None:
            t0 = time.perf_counter()
            sdir = self._step_dir(step)
            tmp = sdir.with_suffix(".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "meta": meta or {}, "leaves": []}
            for i, (key, arr) in enumerate(host):
                fname = f"leaf_{i:05d}.npy"
                np.save(tmp / fname, arr)
                # the port has no uint16 tensors: a uint16 leaf is bf16
                manifest["leaves"].append({
                    "key": key, "file": fname,
                    "shape": list(arr.shape),
                    "dtype": ("bfloat16" if arr.dtype == np.uint16
                              else str(arr.dtype)),
                    "bytes": int(arr.nbytes),
                })
                if self.zns:
                    self.zns.write_file(f"step{step}/{fname}", arr.nbytes,
                                        LIFETIME_CKPT)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if self.zns:
                self.zns.write_file(f"step{step}/manifest", 4096,
                                    LIFETIME_CKPT)
            if sdir.exists():
                shutil.rmtree(sdir)
            os.replace(tmp, sdir)   # atomic publish
            self._gc()
            self.save_seconds += time.perf_counter() - t0
            self.saves += 1
            self.bytes_saved += sum(int(a.nbytes) for _, a in host)

        if self.async_save:
            def run() -> None:
                try:
                    write()
                except BaseException as e:   # re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        """Join the outstanding save; re-raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            sdir = self._step_dir(s)
            if self.zns:
                man = json.loads((sdir / "manifest.json").read_text())
                for leaf in man["leaves"]:
                    self.zns.delete_file(f"step{s}/{leaf['file']}")
                self.zns.delete_file(f"step{s}/manifest")
            shutil.rmtree(sdir)

    # ------------------------------------------------------------------ #
    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[Any, Dict]:
        """Load the checkpoint at ``step`` (the latest by default) into
        ``like`` in place -- its models, optimizer states and tensors take
        the saved values; returns (the tree, the saved meta).  Every leaf
        of ``like`` must be in the checkpoint with its shape.

        Elastic restore: a placed leaf of ``like`` takes its shard of the
        saved whole, and ``shardings`` (a ``DeviceMesh``, or a prefix of
        ``like`` with meshes at its leaves) places the restored models
        and optimizer states on the current mesh by the sharding rules --
        which need not be the mesh that saved them.  In a process group
        every rank calls it; it waits for rank 0's outstanding save."""
        self.wait()
        if dist.is_initialized():
            dist.barrier()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        sdir = self._step_dir(step)
        manifest = json.loads((sdir / "manifest.json").read_text())
        by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}

        def load(key: str, leaf: np.ndarray) -> np.ndarray:
            if key not in by_key:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.load(sdir / by_key[key]["file"])
            if by_key[key]["dtype"] == "bfloat16":
                arr = arr.view(np.uint16)     # uint16 or 2-byte void
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: saved {arr.shape} != expected "
                                 f"{leaf.shape}")
            return arr

        tree = _assign(like, _map_leaves(_shapes(like), load))
        return _place(tree, shardings), manifest["meta"]
