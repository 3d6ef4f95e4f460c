"""Model facade (the port of ``repro.models.model``): the loss and the
train step, the prefill and decode step functions, the parameter counts
and the stub frontends' memory length.

Serving: ``attn_impl`` and ``ssm_impl`` are ``"kernel"`` (the Hopper
attention kernels, and the selective-scan and mLSTM / sLSTM scan kernels,
on CUDA tensors, their plain versions on CPU tensors) or ``"ref"`` (the
plain versions everywhere).  The two are separate knobs to mirror the
reference's ``make_prefill_step(cfg, attn_impl, ssm_impl)``; every
caller today sets them alike.  Decode runs no scan: a Mamba or xLSTM
layer steps its state with plain torch, as the reference does.

Training: :func:`make_train_step` runs the reference's defaults,
``attn_impl="qchunk"`` (``kernels/flash_attention/ref.attention_qchunk``)
and ``ssm_impl="ref"`` -- plain PyTorch under autograd, as the reference
trains through no Pallas kernel (the kernels have no backward, and their
wrappers refuse inputs that require grad).  The train step makes the
model's parameters trainable (``transformer.set_trainable``) and updates
them in place.

Distributed: the same step runs on a model, batch and optimizer state
placed on a ``DeviceMesh`` by ``launch.sharding`` (DTensors); it runs
under ``implicit_replication`` (a plain tensor beside a DTensor counts
as replicated), DTensor's sharding propagation calls the collectives,
and ``metrics`` come back whole.  The plain paths only: no kernel takes
a DTensor.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import layers as L
from repro_torch.models import shards
from repro_torch.models import transformer as T
from repro_torch.train import grad as G
from repro_torch.train import optimizer as OPT

AUX_WEIGHT = 0.01


# --------------------------------------------------------------------- #
# loss / train step
# --------------------------------------------------------------------- #
def loss_fn(model, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            attn_impl: str = "qchunk", ssm_impl: str = "ref",
            remat: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(nll + AUX_WEIGHT * aux, {"nll", "aux"}) of ``batch``'s
    ``tokens`` against its ``labels`` (and its ``memory`` for a model
    with cross layers)."""
    logits, aux = T.forward_train(model, cfg, batch["tokens"],
                                  memory=batch.get("memory"),
                                  attn_impl=attn_impl, ssm_impl=ssm_impl,
                                  remat=remat)
    nll = L.cross_entropy(logits, batch["labels"])
    return nll + AUX_WEIGHT * aux, {"nll": nll, "aux": aux}


def make_train_step(cfg: ArchConfig, opt_cfg: OPT.AdamWConfig,
                    attn_impl: str = "qchunk", ssm_impl: str = "ref",
                    n_micro: int = 1, remat: bool = True,
                    compress_grads: bool = False):
    """``train_step(state, opt_state, batch) -> (state, opt_state,
    metrics)``: ``n_micro > 1`` accumulates microbatch gradients in f32;
    ``remat`` checkpoints every repetition of the layer pattern;
    ``compress_grads`` quantizes the gradients to int8 with error
    feedback before the optimizer, and the state is then ``(model,
    ef)`` (``grad.init_error_feedback``).  The model is updated in
    place; ``metrics`` holds ``loss``, ``nll``, ``aux``, ``grad_norm``
    and ``lr`` as device scalars."""
    def lfn(model, batch):
        return loss_fn(model, cfg, batch, attn_impl, ssm_impl, remat=remat)

    def train_step(state, opt_state, batch):
        model, ef = state if compress_grads else (state, None)
        T.set_trainable(model)
        with implicit_replication():
            loss, grads, metrics = G.accumulate_grads(lfn, model, batch,
                                                      n_micro)
            if compress_grads:
                grads, ef = G.compress_grads_ef(grads, ef,
                                                T.leaf_groups(model))
            model, opt_state, opt_metrics = OPT.update(opt_cfg, model,
                                                       grads, opt_state)
            metrics = {k: shards.whole(v) for k, v in
                       dict(metrics, loss=loss, **opt_metrics).items()}
        return ((model, ef) if compress_grads else model), opt_state, \
            metrics
    return train_step


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


# --------------------------------------------------------------------- #
# stand-ins on the meta device (the dry run's inputs)
# --------------------------------------------------------------------- #
def param_specs(cfg: ArchConfig) -> T.Transformer:
    """The model on the ``meta`` device: every parameter's shape and
    dtype, nothing drawn or allocated (``transformer.params_to_tree``
    gives the reference's ``param_specs`` tree)."""
    return T.init_params(cfg, device="meta")


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int,
                mem_len: int = 0) -> Dict[str, torch.Tensor]:
    """:func:`transformer.init_caches`' caches on the ``meta`` device."""
    return T.init_caches(cfg, batch, max_seq, memory_len=mem_len,
                         device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeCell) -> Dict:
    """Every input of the cell's step but the model and its optimizer
    state, on the ``meta`` device: ``{"batch": {"tokens", "labels"[,
    "memory"]}}`` to train, ``{"tokens", "caches"[, "memory"]}`` to
    prefill, ``{"token", "caches", "pos"}`` to decode."""
    b, s = shape.global_batch, shape.seq_len
    mem = memory_len(cfg, shape)

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")
    memory = ({"memory": meta((b, mem, cfg.d_model), torch.bfloat16)}
              if mem else {})
    if shape.kind == "train":
        return {"batch": {"tokens": meta((b, s)), "labels": meta((b, s)),
                          **memory}}
    if shape.kind == "prefill":
        return {"tokens": meta((b, s)),
                "caches": cache_specs(cfg, b, s, mem), **memory}
    if shape.kind == "decode":
        return {"token": meta((b,)), "caches": cache_specs(cfg, b, s, mem),
                "pos": meta((b,))}
    raise ValueError(shape.kind)


def opt_state_specs(cfg: ArchConfig) -> OPT.AdamWState:
    """The AdamW state of :func:`param_specs`' model on ``meta``."""
    return OPT.init(param_specs(cfg))


def param_count(cfg: ArchConfig) -> int:
    """Parameters of ``cfg``, counted on the ``meta`` device (nothing is
    allocated)."""
    return sum(p.numel() for p in param_specs(cfg).parameters())


def active_param_count(cfg: ArchConfig) -> int:
    """Active parameters per token (MoE: the top-k and shared experts of
    the routed pool)."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    per_expert = 3 * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff)
    n_moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    return total - (cfg.n_experts - cfg.top_k) * per_expert * n_moe_layers
