"""Gradient machinery (the port of ``repro.train.grad``): microbatch
accumulation, int8 compression with error feedback, and the
pod-hierarchical all-reduce.

Gradients are lists of tensors in the model's ``parameters()`` order
(``transformer.like`` gives them the parameters' layout).

* **Gradient accumulation** -- :func:`accumulate_grads` runs the
  microbatches one backward each; grads are averaged in f32.
* **Int8 compression with error feedback** -- per reference leaf
  symmetric quantization; the quantization error is carried in an f32
  residual and re-added next step.
* **Pod-hierarchical all-reduce** -- :func:`hierarchical_psum`:
  reduce-scatter over the in-pod axis, all-reduce over the pod axis,
  all-gather in-pod, on ``torch.distributed`` (NCCL on the card, gloo
  on the CPU) over the groups of a ``DeviceMesh``'s axes: the two-level
  schedule that keeps the slow cross-pod links carrying 1/|in-pod| of
  the bytes.  :func:`make_hierarchical_grad_sync` averages a manual-DP
  loop's gradients with it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.models import shards


def _grads(loss: torch.Tensor, params: List[nn.Parameter]
           ) -> List[torch.Tensor]:
    """d loss / d params in each parameter's dtype; zeros for a parameter
    the loss does not reach (``jax.grad`` gives those).  A placed
    parameter's gradient (a DTensor) comes back placed as the parameter
    is -- its partial sums over the data-parallel axes reduced here, as
    the reference's sharded step returns gradients in the parameters'
    sharding -- so the optimizer sees no partial placement."""
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    out = []
    for p, g in zip(params, gs):
        if g is None:
            g = torch.zeros_like(p)
        elif shards.is_dtensor(g) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        out.append(g)
    return out


def accumulate_grads(loss_fn: Callable, model: nn.Module,
                     batch: Dict[str, torch.Tensor], n_micro: int
                     ) -> Tuple[torch.Tensor, List[torch.Tensor], Dict]:
    """Split the leading batch dim into ``n_micro`` microbatches, one
    backward each.  ``loss_fn(model, batch) -> (loss, metrics)``.
    Returns (mean loss, mean grads, last metrics): with ``n_micro > 1``
    the grads are averaged in f32 (``a + g.float() / n_micro``), with one
    they stay in the parameters' dtype, as the reference's do."""
    params = [p for p in model.parameters() if p.requires_grad]
    if len(params) != len(list(model.parameters())):
        raise ValueError("every parameter must require grad "
                         "(transformer.set_trainable)")
    if n_micro <= 1:
        loss, metrics = loss_fn(model, batch)
        return (loss.detach(), _grads(loss, params),
                {k: v.detach() for k, v in metrics.items()})

    def micro(x):
        if x.shape[0] == n_micro:
            return x                     # caller pre-shaped (M, Bm, ...)
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} % n_micro {n_micro} "
                             f"!= 0")
        return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])

    mbs = {k: micro(v) for k, v in batch.items()}
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in params]
    loss_acc = torch.zeros((), dtype=torch.float32)
    for i in range(n_micro):
        loss, metrics = loss_fn(model, {k: v[i] for k, v in mbs.items()})
        for a, g in zip(acc, _grads(loss, params)):
            a.add_(g.float() / n_micro)
        loss_acc = loss_acc.to(loss.device) + loss.detach() / n_micro
    return loss_acc, acc, {k: v.detach() for k, v in metrics.items()}


#: f32(1/127): compiled, the reference's ``max / 127.0`` is a multiply by
#: it (XLA rewrites a division by a constant)
_INV_127 = float(torch.tensor(1 / 127.0, dtype=torch.float32))


def compress_int8(g) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of ``g`` (a tensor, or a list of
    tensors sharing one scale). Returns (q, scale): the payload rounded
    half to even and clipped to +-127 (a list for a list)."""
    gs = g if isinstance(g, (list, tuple)) else [g]
    gfs = [x.float() for x in gs]
    top = gfs[0].abs().amax()
    for x in gfs[1:]:
        top = torch.maximum(top, x.abs().amax())
    scale = torch.clamp_min(top, 1e-12) * _INV_127
    qs = [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
          for x in gfs]
    return (qs if isinstance(g, (list, tuple)) else qs[0]), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(model: nn.Module) -> List[torch.Tensor]:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in model.parameters()]


def compress_grads_ef(grads: List[torch.Tensor], ef: List[torch.Tensor],
                      groups: Optional[List[List[int]]] = None
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Quantize (grads + residual); the new residual is the input less
    its dequantized value.  Returns (dequantized grads for the
    optimizer, new residual).  ``groups`` (indices into ``grads``) share
    a scale: the reference quantizes each leaf of its tree, and a
    stacked leaf holds a slot's parameter over every repetition
    (``transformer.leaf_groups``); by default each tensor has its own."""
    if len(grads) != len(ef):
        raise ValueError(f"{len(grads)} grads, {len(ef)} residuals")
    groups = groups if groups is not None else [[i] for i in
                                                range(len(grads))]
    deq: List[Optional[torch.Tensor]] = [None] * len(grads)
    res: List[Optional[torch.Tensor]] = [None] * len(grads)
    for idx in groups:
        targets = [grads[i].float() + ef[i] for i in idx]
        qs, scale = compress_int8(targets)
        for i, t, q in zip(idx, targets, qs):
            deq[i] = decompress_int8(q, scale)
            # compiled, the reference's ``target - q * scale`` is one fused
            # multiply-subtract, rounded once: exact in f64, then f32
            res[i] = (t.double() - q.double() * scale.double()).float()
    return deq, res


# --------------------------------------------------------------------- #
# pod-hierarchical all-reduce
# --------------------------------------------------------------------- #
def hierarchical_psum(x: torch.Tensor, mesh, *, in_pod_axis: str = "data",
                      cross_pod_axis: str = "pod") -> torch.Tensor:
    """reduce_scatter(in-pod) -> all_reduce(cross-pod) ->
    all_gather(in-pod) of this rank's ``x``: the sum of ``x`` over both
    axes of ``mesh``, every rank of them getting it; the cross-pod hop
    carries 1/|in-pod| of the bytes.  As the reference's ``tiled``
    collectives require, dim 0 must divide by |in-pod| (nothing is
    padded)."""
    n = mesh.size(mesh.mesh_dim_names.index(in_pod_axis))
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not divide by "
                         f"|{in_pod_axis}| = {n}")
    in_pod = mesh.get_group(in_pod_axis)
    part = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                       dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(part, x.contiguous(), group=in_pod)
    dist.all_reduce(part, group=mesh.get_group(cross_pod_axis))
    out = torch.empty_like(x)
    dist.all_gather_into_tensor(out, part, group=in_pod)
    return out


def make_hierarchical_grad_sync(mesh, axes=("pod", "data")):
    """``sync(grads) -> grads``: each gradient summed by
    :func:`hierarchical_psum` over ``axes`` (cross-pod, in-pod) and
    divided by |pod| * |data| -- the mean over the data-parallel ranks of
    a manual-DP training loop."""
    names = mesh.mesh_dim_names
    n = mesh.size(names.index(axes[0])) * mesh.size(names.index(axes[1]))

    def sync(grads: List[torch.Tensor]) -> List[torch.Tensor]:
        return [hierarchical_psum(g, mesh, in_pod_axis=axes[1],
                                  cross_pod_axis=axes[0]) / n
                for g in grads]
    return sync
