"""Gradient machinery (the port of ``repro.train.grad``'s single-device
half): microbatch accumulation and int8 compression with error feedback.

Gradients are lists of tensors in the model's ``parameters()`` order
(``transformer.like`` gives them the parameters' layout).  The
reference's pod-hierarchical all-reduce (``hierarchical_psum``,
``make_hierarchical_grad_sync``) needs a mesh: not ported (ROADMAP Queue
1 item 12).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn


def _grads(loss: torch.Tensor, params: List[nn.Parameter]
           ) -> List[torch.Tensor]:
    """d loss / d params in each parameter's dtype; zeros for a parameter
    the loss does not reach (``jax.grad`` gives those)."""
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, gs)]


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
