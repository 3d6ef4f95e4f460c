"""GPipe-style pipeline parallelism over a mesh axis (the port of
``repro.train.pipeline``).

Layers are split into S stages; stage s runs on the rank at coordinate s
of the mesh's ``stage`` axis; M microbatches flow stage to stage on the
classic fill-drain schedule (utilization M/(M+S-1)).

The reference's dataflow, tick for tick: microbatches enter at stage 0,
activations hop one stage a tick (``batch_isend_irecv`` to the next
rank of the axis, the reference's ``ppermute``), finished microbatches
are collected at stage S-1 and reach every rank at the end (an
all-reduce of a buffer that is zero off the last stage, the reference's
masked ``psum``).  Every stage runs its block every tick, on zeros when
it is idle: the bubble is in the schedule, as on the reference's mesh.
``torch.distributed.pipelining``'s schedules order the work otherwise,
so they are not used.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist


def _stage_slice(tree: Any, stage: int) -> Any:
    if isinstance(tree, dict):
        return {k: _stage_slice(v, stage) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage_slice(v, stage) for v in tree)
    return tree[stage]


def pipeline_apply(block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *, mesh,
                   axis: str = "stage", n_micro: int = 2) -> torch.Tensor:
    """Run ``x`` through the S pipeline stages of mesh axis ``axis``.

    Args:
      block_fn: (stage_params_slice, acts (Bm, ...)) -> acts (same shape).
      stage_params: tree of tensors with leading stage dim S; this rank
        runs slice ``[s]`` for its coordinate s on ``axis``.
      x: (B, ...), the same on every rank; B % n_micro == 0.
      n_micro: microbatch count M.

    Returns (B, ...) activations after all S stages, on every rank.
    """
    dim = mesh.mesh_dim_names.index(axis)
    n_stages = mesh.size(dim)
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    params = _stage_slice(stage_params, stage)
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} % n_micro {n_micro} != 0")
    micro = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prev = dist.get_global_rank(group, (stage - 1) % n_stages)

    buf = torch.zeros_like(micro[0])
    out = torch.zeros_like(micro)
    for t in range(n_stages + n_micro - 1):
        # stage s processes microbatch (t - s) when 0 <= t - s < M
        idx = t - stage
        active = 0 <= idx < n_micro
        feed = micro[min(max(idx, 0), n_micro - 1)]
        y = block_fn(params, feed if stage == 0 else buf)
        if not active:
            y = torch.zeros_like(y)
        elif stage == n_stages - 1:
            out[idx] = y
        if n_stages == 1:
            buf = y
            continue
        buf = torch.empty_like(y)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, buf, prev, group)]):
            req.wait()
    # only the last stage holds real outputs: mask + all-reduce
    if stage != n_stages - 1:
        out.zero_()
    dist.all_reduce(out, group=group)
    return out.reshape(x.shape)


def pipeline_utilization(n_micro: int, n_stages: int) -> float:
    """GPipe bubble math: M/(M + S - 1)."""
    return n_micro / (n_micro + n_stages - 1)
