"""AdamW and its learning-rate schedule over a model's parameters (the
port of ``repro.train.optimizer``).

The moments are f32 whatever the parameters' dtype, the update runs in
f32 and is cast back to each parameter's dtype -- the reference's
mixed-precision recipe, op for op: the clip ``min(1, clip / (gnorm +
1e-9))``, bias corrections ``1 - b**step``, ``delta = mhat / (sqrt(nhat)
+ eps)`` and ``p - lr * (delta + wd * p)``, with the decay on every
parameter.  (``torch.optim.AdamW`` places eps and the decoupled decay
elsewhere, so its numbers differ.)

The parameters are a :class:`~repro_torch.models.transformer.Transformer`
(any ``nn.Module``); the moments ``mu`` and ``nu`` are modules of the same
structure (``transformer.like``), paired with the parameters by name, and
:func:`update` writes all three in place.  :func:`state_to_numpy` /
:func:`state_from_numpy` carry a state to and from the reference's
layout (``AdamWState(step, mu, nu)`` with the parameters' stacked tree).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor        # () int32: updates taken
    mu: nn.Module             # f32 first moments, the parameters' layout
    nu: nn.Module             # f32 second moments


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio``, in f32."""
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def init(params: nn.Module) -> AdamWState:
    """Zero moments in f32 on the parameters' devices (placed as they are,
    for parameters placed on a mesh), step 0."""
    def zeros():
        return T.like(params, [torch.zeros_like(p, dtype=torch.float32)
                               for p in params.parameters()])
    dev = next(params.parameters()).device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      zeros(), zeros())


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


@torch.no_grad()
def update(cfg: AdamWConfig, params: nn.Module, grads: List[torch.Tensor],
           state: AdamWState
           ) -> Tuple[nn.Module, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step; ``grads`` in ``params.parameters()`` order.  The
    parameters and moments are updated in place and returned, with the
    new step and ``{"grad_norm", "lr"}`` (f32 scalars on the device)."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, state.step)
    b1, b2 = cfg.b1, cfg.b2
    step = state.step + 1
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    mus = dict(state.mu.named_parameters())
    nus = dict(state.nu.named_parameters())
    for (name, p), g in zip(params.named_parameters(), grads, strict=True):
        if not p.numel():   # the empty stand-in of a layer read off a stack
            continue
        mu, nu = mus[name], nus[name]
        g = g.float() * clip
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        pf = p.float()
        p.copy_((pf - lr * (delta + cfg.weight_decay * pf)).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr}


def state_to_numpy(state: AdamWState) -> AdamWState:
    """The state in the reference's layout: ``AdamWState(step int32,
    mu, nu)`` with the moments as the parameters' stacked numpy trees
    (``transformer.params_to_numpy``)."""
    return AdamWState(np.asarray(state.step.cpu().numpy(), np.int32),
                      T.params_to_numpy(state.mu),
                      T.params_to_numpy(state.nu))


def state_from_numpy(cfg, state, device="cuda") -> AdamWState:
    """The inverse of :func:`state_to_numpy`, from the reference's
    ``AdamWState`` (``jax.tree.map(np.asarray, opt_state)``)."""
    step, mu, nu = state
    return AdamWState(
        torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                     device=device),
        T.params_from_numpy(cfg, mu, device=device),
        T.params_from_numpy(cfg, nu, device=device))
