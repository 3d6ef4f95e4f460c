"""Model facade for serving (the port of ``repro.models.model``'s serving
half): the prefill and decode step functions and the parameter count.

``attn_impl`` and ``ssm_impl`` are ``"kernel"`` (the Hopper attention
and selective-scan kernels on CUDA tensors, their plain versions on CPU
tensors) or ``"ref"`` (the plain versions everywhere).  The two are
separate knobs to mirror the reference's ``make_prefill_step(cfg,
attn_impl, ssm_impl)``; every caller today sets them alike.  Decode runs no
scan: a Mamba layer steps its state with plain torch, as the reference
does.  Training (``loss_fn``, ``make_train_step``) waits
for ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ArchConfig, attn_impl: str = "kernel",
                      ssm_impl: str = "kernel"):
    def prefill_step(model, tokens, caches):
        return T.forward_prefill(model, cfg, tokens, caches,
                                 attn_impl=attn_impl, ssm_impl=ssm_impl)
    return prefill_step


def make_decode_step(cfg: ArchConfig, attn_impl: str = "kernel"):
    def decode_step(model, token, caches, pos):
        return T.forward_decode(model, cfg, token, caches, pos,
                                attn_impl=attn_impl)
    return decode_step


def param_count(cfg: ArchConfig) -> int:
    """Parameters of ``cfg``, counted on the ``meta`` device (nothing is
    allocated)."""
    model = T.init_params(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())
