"""Model facade for serving (the port of ``repro.models.model``'s serving
half): the prefill and decode step functions, the parameter counts and
the stub frontends' memory length.

``attn_impl`` and ``ssm_impl`` are ``"kernel"`` (the Hopper attention
kernels, and the selective-scan and mLSTM / sLSTM scan kernels, on CUDA
tensors, their plain versions on CPU tensors) or ``"ref"`` (the plain
versions everywhere).  The two are separate knobs to mirror the
reference's ``make_prefill_step(cfg, attn_impl, ssm_impl)``; every
caller today sets them alike.  Decode runs no
scan: a Mamba or xLSTM layer steps its state with plain torch, as the
reference does.  Training (``loss_fn``, ``make_train_step``) waits
for ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ArchConfig, attn_impl: str = "kernel",
                      ssm_impl: str = "kernel"):
    def prefill_step(model, tokens, caches, memory=None, encoded=False):
        return T.forward_prefill(model, cfg, tokens, caches, memory=memory,
                                 encoded=encoded, attn_impl=attn_impl,
                                 ssm_impl=ssm_impl)
    return prefill_step


def make_decode_step(cfg: ArchConfig, attn_impl: str = "kernel"):
    def decode_step(model, token, caches, pos):
        return T.forward_decode(model, cfg, token, caches, pos,
                                attn_impl=attn_impl)
    return decode_step


def memory_len(cfg: ArchConfig, shape: ShapeCell) -> int:
    """Stub modality-token count for VLM/audio frontends."""
    if cfg.family == "audio":
        # speech frames after the (stubbed) frontend: seq/4
        return max(16, shape.seq_len // 4)
    if cfg.family == "vlm":
        return cfg.frontend_tokens
    return 0


def param_count(cfg: ArchConfig) -> int:
    """Parameters of ``cfg``, counted on the ``meta`` device (nothing is
    allocated)."""
    model = T.init_params(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())


def active_param_count(cfg: ArchConfig) -> int:
    """Active parameters per token (MoE: the top-k and shared experts of
    the routed pool)."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    per_expert = 3 * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff)
    n_moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    return total - (cfg.n_experts - cfg.top_k) * per_expert * n_moe_layers
