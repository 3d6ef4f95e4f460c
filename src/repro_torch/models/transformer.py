"""Architecture assembly: stacks of ``"attn"``, ``"cross"``, ``"mamba"``,
``"mlstm"`` and ``"slstm"`` blocks with dense or MoE FFNs, and the encoder
of an encoder-decoder (the port of ``repro.models.transformer``): the
serving path (:func:`forward_prefill`, :func:`forward_decode`) and the
training forward (:func:`forward_train`).

The reference stacks parameters per pattern slot and runs
``jax.lax.scan`` over repetitions; the port holds one :class:`Block` per
layer in an ``nn.ModuleList`` and loops over them in Python
(:func:`layer_plan` gives every layer's kind and FFN).  Global layer
``n_prefix + r * len(pattern) + j`` is the reference's slot ``j``,
repetition ``r``; with ``first_layer_dense`` layer 0 is the reference's
``"first"`` block, an attention layer with the ``dense_d_ff`` FFN before
the pattern.  :func:`params_from_numpy` / :func:`params_to_numpy` map
between the two.

Supported: ``"attn"`` (self-attention, or multi-head latent attention
when ``cfg.mla``), ``"cross"`` (self-attention, ``norm_c``, then
cross-attention over a memory), ``"mamba"``, ``"mlstm"`` and ``"slstm"``
(``models/xlstm.py``) blocks, each with a dense FFN (SwiGLU or GELU,
RMSNorm or LayerNorm), an MoE FFN (:class:`MoEFFN`, ``models/moe.py``)
on the layers ``cfg.is_moe_layer`` picks, or none;
the dense first layer; and with ``cfg.encoder_layers`` a bidirectional
encoder of ``"attn"`` blocks (:func:`encode`) that turns the memory into
the decoder's.  Each kind's mixer init, cache, prefill and decode, and
its names in the reference's trees, are one entry of :data:`KINDS`;
:func:`layer_plan` gives an ``"attn"`` layer of an MLA config the kind
``"mla"`` (the dense first layer too, as in the reference), while
:func:`slot_kinds` keeps the reference's pattern names.

Caches hold the kinds' state side by side, each stacked over the
layers of its kind (:func:`cache_slots` maps a layer to its kind and its
index there): ``{"k", "v"}`` of shape ``(n_attn, B, max_seq, Hkv, D)`` in
bf16 for the attention layers (the dense first layer's at index 0), the
latent ``{"c_kv", "k_rope"}`` of shapes ``(n_mla, B, max_seq, kv_lora)``
and ``(n_mla, B, max_seq, rope)`` in bf16 for the MLA layers, and
``{"conv", "ssm"}`` of shapes ``(n_mamba, B, K-1, d_inner)`` bf16 and
``(n_mamba, B, d_inner, N)`` f32 for the Mamba layers, and the
reference's ``{"c", "n", "m"}`` of the mLSTM layers and ``{"c", "n", "m",
"h"}`` of the sLSTM layers under the names ``mlstm_c``, ... and
``slstm_c``, ... -- ``(n_mlstm, B, H, P, P)``, ``(n_mlstm, B, H, P)``,
``(n_mlstm, B, H)`` in f32, ``(n_slstm, B, d)`` f32 for ``c`` and ``n``,
``(n_slstm, B, H)`` f32 and ``(n_slstm, B, d)`` bf16 for ``h``; a dense
model has only ``k`` and ``v``, one per layer.  A cross layer's
self-attention K/V sit in the attention stack; with
``init_caches(memory_len=M)`` the cross layers' memory K/V are
``memory_k`` / ``memory_v`` of shape ``(n_cross, B, M, Hkv, D)`` in the
projection's dtype (the reference's prefill
replaces its bf16 zeros with ``build_memory_kv``'s output, the same
products its cross layers' prefill computes, so the port's cross layers
write them as they attend), and ``memory_len`` ``(B,)`` int32 holds M
for every sequence, the cross decode's lengths.  Prefill writes the KV,
latent and memory caches in place and, like the reference, leaves the
Mamba and xLSTM states as they were
(``repro.models.transformer`` skips the terminal state: decode starts
every Mamba and xLSTM layer from its cached state, zero after
:func:`init_caches`).  Decode writes the KV and recurrent caches in
place.

Rounding follows the reference's compiled program: within a step of its
layer scan a norm reads the residual stream's f32 sum (:func:`_add`),
while the scan's carry, between steps and into the norm after the scan,
is rounded to the activation dtype (:func:`carry_rounds`).  Training
runs the same scan, so :func:`forward_train` rounds alike.

Parameters are frozen (``requires_grad=False``) as built, so serving
builds no autograd graph; :func:`set_trainable` makes them trainable,
and the train step (``models/model.make_train_step``) calls it.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as X


# --------------------------------------------------------------------- #
# the layer pattern
# --------------------------------------------------------------------- #
def _check_supported(cfg: ArchConfig) -> None:
    for kind in cfg.pattern:
        if kind not in KINDS:
            raise ValueError(kind)


def slot_kinds(cfg: ArchConfig) -> List[Tuple[str, bool]]:
    """(kind, is_moe) per pattern slot (rep-invariant by construction)."""
    n_prefix = 1 if cfg.first_layer_dense else 0
    out = [(kind, cfg.is_moe_layer(n_prefix + j))
           for j, kind in enumerate(cfg.pattern)]
    reps = (cfg.n_layers - n_prefix) // len(cfg.pattern)
    for r in range(reps):
        for j, _ in enumerate(cfg.pattern):
            gidx = n_prefix + r * len(cfg.pattern) + j
            assert cfg.is_moe_layer(gidx) == out[j][1], (
                "pattern/moe_every mismatch: scan would be heterogeneous")
    return out


def n_scan_reps(cfg: ArchConfig) -> int:
    n_prefix = 1 if cfg.first_layer_dense else 0
    n = cfg.n_layers - n_prefix
    if n % len(cfg.pattern):
        raise ValueError(f"{cfg.name}: {n} layers not divisible by "
                         f"pattern {len(cfg.pattern)}")
    return n // len(cfg.pattern)


def block_kind(cfg: ArchConfig, kind: str) -> str:
    """The :data:`KINDS` entry of a reference pattern kind: ``"attn"``
    runs MLA under ``cfg.mla``."""
    return "mla" if cfg.mla and kind == "attn" else kind


def layer_plan(cfg: ArchConfig) -> List[Tuple[str, bool]]:
    """(kind, is_moe) of every layer in order: the dense first layer,
    then the pattern's slots, repetition by repetition."""
    first = [("attn", False)] if cfg.first_layer_dense else []
    return [(block_kind(cfg, kind), moe)
            for kind, moe in first + slot_kinds(cfg) * n_scan_reps(cfg)]


def moe_dims(cfg: ArchConfig) -> MOE.MoEDims:
    return MOE.MoEDims(cfg.n_experts, cfg.top_k, cfg.d_model,
                       cfg.moe_d_ff or cfg.d_ff, cfg.n_shared_experts,
                       cfg.capacity_factor,
                       route_groups=cfg.route_groups,
                       route_limit=cfg.route_limit,
                       int8_dispatch=cfg.int8_dispatch)


def _mask_padded(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """-1e30 on the vocab-padding tail so sampling ignores it."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    keep = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
    return torch.where(keep, logits, -1e30)


# --------------------------------------------------------------------- #
# modules
# --------------------------------------------------------------------- #
def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def set_trainable(model: nn.Module) -> nn.Module:
    """Make every parameter of ``model`` require grad (serving builds them
    frozen); returns ``model``."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model


#: the residual stream: the activations in their dtype, and the same sum
#: in f32 before its rounding
Residual = Tuple[torch.Tensor, torch.Tensor]


def residual(x: torch.Tensor) -> Residual:
    """The stream from ``x`` alone: also what a scan carry is, since the
    reference's compiled layer scan stores its carry rounded to the
    activation dtype (see :func:`carry_rounds`)."""
    return x, x.float()


def carry_rounds(n_prefix: int, period: int, reps: int) -> List[bool]:
    """For each of ``n_prefix + period * reps`` layers, whether its input
    is the reference's layer-scan carry: the first layer of every
    repetition when the scan runs at least two.  The compiled scan is a
    loop whose carry is stored in the activation dtype, so the layer's
    norm reads the rounded stream; XLA drops a one-trip loop and fuses
    across it, so one repetition rounds nowhere.  The norm after the scan
    (the final norm, the encoder's) reads the carry likewise when
    ``reps >= 2``."""
    out = [False] * (n_prefix + period * reps)
    if reps >= 2:
        for r in range(reps):
            out[n_prefix + r * period] = True
    return out


def _add(res: Residual, o: torch.Tensor) -> Residual:
    """A residual add as the reference's compiled program computes it:
    ``x + o`` rounded to the activation dtype feeds the next add, while
    the next norm reads the f32 sum -- XLA fuses the norm's f32 convert
    into the add and drops the rounding between (within a scan step; a
    scan's carry is rounded, :func:`carry_rounds`)."""
    x = res[0]
    xf = torch.add(x.float(), o)    # f32: the sum before its rounding
    # bf16 + f32 (a bf16 memory entering f32 weights) promotes, as in jnp
    return xf.to(torch.promote_types(x.dtype, o.dtype)), xf


class Norm(nn.Module):
    """RMSNorm (weight ``w``) or LayerNorm (``w`` and ``b``)."""

    def __init__(self, kind: str, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None):
        super().__init__()
        self.kind = kind
        self.w = _frozen(w)
        self.b = _frozen(b) if b is not None else None

    def forward(self, res: Residual) -> torch.Tensor:
        """The norm of the residual stream's unrounded f32 sum, cast to
        the stream's dtype."""
        x, xf = res
        if self.kind == "rmsnorm":
            return L.rmsnorm(xf, self.w, dtype=x.dtype)
        return L.layernorm(xf, self.w, self.b, dtype=x.dtype)


def _params(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in tree.items()})


class MoEFFN(nn.Module):
    """An MoE FFN: the reference's ``ffn`` subtree (``router`` (d, E) f32,
    ``w_gate`` / ``w_up`` (E, d, f), ``w_down`` (E, f, d), and a
    ``shared`` SwiGLU when the config has shared experts) and its
    :class:`~repro_torch.models.moe.MoEDims`.

    ``record`` and ``replay`` are check hooks, not features: with
    ``record`` a list, each call appends its
    :class:`~repro_torch.models.moe.Routing`; with ``replay`` an iterator
    of ``(T, k)`` expert ids, each call routes its tokens to the next
    one's experts (``moe_apply``'s ``routes``).  A call recomputed in
    the backward of a checkpointed repetition (:class:`_Recompute`)
    takes the routes its forward took and records nothing."""

    def __init__(self, dims: MOE.MoEDims, tree: Dict):
        super().__init__()
        self.dims = dims
        self.router = _frozen(tree["router"])
        self.w_gate = _frozen(tree["w_gate"])
        self.w_up = _frozen(tree["w_up"])
        self.w_down = _frozen(tree["w_down"])
        self.shared = _params(tree["shared"]) if "shared" in tree else None
        self.record: Optional[list] = None
        self.replay: Optional[Iterator[torch.Tensor]] = None

    def tree(self) -> Dict:
        p = {"router": self.router, "w_gate": self.w_gate,
             "w_up": self.w_up, "w_down": self.w_down}
        if self.shared is not None:
            p["shared"] = dict(self.shared)
        return p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (T, d), every token of the call."""
        return self.apply_aux(x)[0]

    def apply_aux(self, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(out, the load-balancing aux loss) of x (T, d)."""
        scope = _Recompute.active
        again = scope is not None and scope.again
        if again:
            routes = scope.routes[scope.at]
            scope.at += 1
        else:
            routes = next(self.replay) if self.replay is not None else None
            if scope is not None:
                scope.routes.append(routes)
        out, routing = MOE.moe_forward(self.tree(), x, self.dims, routes)
        if self.record is not None and not again:
            self.record.append(routing)
        return out, routing.aux


class _Recompute:
    """The ``context_fn`` of one checkpointed repetition, so that its MoE
    layers' check hooks act once a forward: the forward notes the routes
    each layer replayed (None where it routed itself), and the backward's
    recompute takes them again in call order (``MoEFFN.replay`` would give
    it the next call's routes, ``record`` would append twice)."""

    #: the repetition running now, if any
    active: Optional["_Recompute"] = None

    def __init__(self):
        self.routes: List[Optional[torch.Tensor]] = []
        self.again, self.at = False, 0

    def __call__(self):
        return self._run(False), self._run(True)

    @contextlib.contextmanager
    def _run(self, again: bool):
        prev, _Recompute.active = _Recompute.active, self
        self.again, self.at = again, 0
        try:
            yield
        finally:
            _Recompute.active = prev


class Block(nn.Module):
    """One layer: a pre-norm mixer -- self-attention (``kind="attn"``),
    self-attention then a pre-norm (``norm_c``) cross-attention over the
    memory (``kind="cross"``, its weights ``cross``), the Mamba mixer
    (``kind="mamba"``) or an xLSTM block (``"mlstm"``, ``"slstm"``) --
    and a dense FFN (a tree of tensors), an MoE FFN or none."""

    def __init__(self, cfg: ArchConfig, kind: str, norm1: Norm,
                 mixer: Dict[str, torch.Tensor], norm2: Optional[Norm],
                 ffn, cross: Optional[Dict[str, torch.Tensor]] = None,
                 norm_c: Optional[Norm] = None):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.norm1 = norm1
        self.mixer = _params(mixer)
        self.norm2 = norm2
        self.ffn = (ffn if ffn is None or isinstance(ffn, MoEFFN)
                    else _params(ffn))
        self.cross = _params(cross) if cross is not None else None
        self.norm_c = norm_c

    def _dims(self) -> dict:
        cfg = self.cfg
        return {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                "head_dim": cfg.resolved_head_dim,
                "rope_theta": cfg.rope_theta}

    def _ffn(self, res: Residual
             ) -> Tuple[Residual, Optional[torch.Tensor]]:
        """The FFN's residual add, and an MoE FFN's aux loss (None for a
        dense FFN or none: the reference adds 0 there)."""
        if self.ffn is None:
            return res, None
        h = self.norm2(res)
        if isinstance(self.ffn, MoEFFN):
            # every token of the call at once: capacity and drops depend
            # on the whole batch
            out, aux = self.ffn.apply_aux(h.reshape(-1, h.shape[-1]))
            return _add(res, out.reshape(h.shape)), aux
        if self.cfg.act == "swiglu":
            return _add(res, L.swiglu(h, self.ffn)), None
        return _add(res, L.gelu_mlp(h, self.ffn)), None

    def forward_train(self, res: Residual, attn_impl: str, ssm_impl: str,
                      memory: Optional[torch.Tensor] = None
                      ) -> Tuple[Residual, Optional[torch.Tensor]]:
        """The layer over a whole sequence with no cache (the reference's
        ``mode="train"``): the residual stream and the MoE aux loss."""
        o = KINDS[self.kind].train(self, self.norm1(res), attn_impl,
                                   ssm_impl)
        res = _add(res, o)
        if self.cross is not None:
            res = _add(res, A.cross_forward(
                self.cross, self.norm_c(res), memory, impl=attn_impl,
                **self._cross_dims()))
        return self._ffn(res)

    def prefill(self, res: Residual, cache: Dict[str, torch.Tensor],
                attn_impl: str, ssm_impl: str,
                memory: Optional[torch.Tensor] = None,
                mem_cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> Residual:
        """``memory`` (B, M, d) and ``mem_cache`` (this layer's memory
        K/V, written here): a cross layer's."""
        o = KINDS[self.kind].prefill(self, self.norm1(res), cache,
                                     attn_impl, ssm_impl)
        res = _add(res, o)
        if self.cross is not None:
            res = _add(res, A.cross_prefill(
                self.cross, self.norm_c(res), memory, mem_cache,
                impl=attn_impl, **self._cross_dims())[0])
        return self._ffn(res)[0]

    def decode(self, res: Residual, cache: Dict[str, torch.Tensor],
               pos: torch.Tensor, attn_impl: str,
               mem_cache: Optional[Dict[str, torch.Tensor]] = None
               ) -> Residual:
        """``mem_cache``: a cross layer's memory K/V and lengths."""
        o = KINDS[self.kind].decode(self, self.norm1(res), cache, pos,
                                    attn_impl)
        res = _add(res, o)
        if self.cross is not None:
            res = _add(res, A.cross_decode(
                self.cross, self.norm_c(res), mem_cache,
                lengths=mem_cache["lengths"], impl=attn_impl,
                **self._cross_dims()))
        return self._ffn(res)[0]

    def encode(self, res: Residual, attn_impl: str) -> Residual:
        """An encoder layer: bidirectional self-attention with RoPE at
        ``arange(S)`` (the reference's ``"attn"`` block in train mode,
        ``causal=False``)."""
        o = A.attn_forward(self.mixer, self.norm1(res), causal=False,
                           impl=attn_impl, **self._dims())
        return self._ffn(_add(res, o))[0]

    def _cross_dims(self) -> dict:
        cfg = self.cfg
        return {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                "head_dim": cfg.resolved_head_dim}


# --------------------------------------------------------------------- #
# the block kinds
# --------------------------------------------------------------------- #
def _attn_init(generator, cfg: ArchConfig, device, dtype):
    return A.attn_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, device=device, dtype=dtype)


def _attn_cache(cfg: ArchConfig, batch: int, max_seq: int, device):
    return A.init_kv_cache(batch, max_seq, cfg.n_kv_heads,
                           cfg.resolved_head_dim, device=device)


def _attn_prefill(blk: Block, h, cache, attn_impl, ssm_impl):
    return A.attn_prefill(blk.mixer, h, cache, impl=attn_impl,
                          **blk._dims())[0]


def _attn_train(blk: Block, h, attn_impl, ssm_impl):
    return A.attn_forward(blk.mixer, h, impl=attn_impl, **blk._dims())


def _attn_decode(blk: Block, h, cache, pos, attn_impl):
    return A.attn_decode(blk.mixer, h, cache, pos, impl=attn_impl,
                         **blk._dims())[0]


def _mamba_init(generator, cfg: ArchConfig, device, dtype):
    return M.mamba_init(generator, cfg.d_model, expand=cfg.ssm_expand,
                        state=cfg.ssm_state, conv=cfg.ssm_conv,
                        device=device, dtype=dtype)


def _mamba_cache(cfg: ArchConfig, batch: int, max_seq: int, device):
    return M.init_mamba_cache(batch, cfg.d_model, expand=cfg.ssm_expand,
                              state=cfg.ssm_state, conv=cfg.ssm_conv,
                              device=device)


def _mamba_prefill(blk: Block, h, cache, attn_impl, ssm_impl):
    # the Mamba cache is left as it was, as in the reference
    return M.mamba_forward(blk.mixer, h, state=blk.cfg.ssm_state,
                           impl=ssm_impl)


def _mamba_decode(blk: Block, h, cache, pos, attn_impl):
    return M.mamba_decode(blk.mixer, h, cache, state=blk.cfg.ssm_state)[0]


def _mla_init(generator, cfg: ArchConfig, device, dtype):
    return MLA.mla_init(generator, cfg, device=device, dtype=dtype)


def _mla_cache(cfg: ArchConfig, batch: int, max_seq: int, device):
    return MLA.init_mla_cache(batch, max_seq, cfg, device=device)


def _mla_prefill(blk: Block, h, cache, attn_impl, ssm_impl):
    return MLA.mla_prefill(blk.mixer, h, cache, blk.cfg, impl=attn_impl)[0]


def _mla_train(blk: Block, h, attn_impl, ssm_impl):
    return MLA.mla_forward(blk.mixer, h, blk.cfg, impl=attn_impl)


def _mla_decode(blk: Block, h, cache, pos, attn_impl):
    # the absorbed decode is plain products in the reference too: no
    # attention kernel, whatever attn_impl
    return MLA.mla_decode(blk.mixer, h, cache, pos, blk.cfg)[0]


def _mlstm_init(generator, cfg: ArchConfig, device, dtype):
    return X.mlstm_init(generator, cfg.d_model, cfg.n_heads, device=device,
                        dtype=dtype)


def _mlstm_cache(cfg: ArchConfig, batch: int, max_seq: int, device):
    return X.init_mlstm_cache(batch, cfg.d_model, cfg.n_heads,
                              device=device)


def _mlstm_prefill(blk: Block, h, cache, attn_impl, ssm_impl):
    # the xLSTM caches are left as they were, as in the reference
    return X.mlstm_forward(blk.mixer, h, blk.cfg.n_heads, impl=ssm_impl)


def _mlstm_decode(blk: Block, h, cache, pos, attn_impl):
    return X.mlstm_decode(blk.mixer, h, cache, blk.cfg.n_heads)[0]


def _slstm_init(generator, cfg: ArchConfig, device, dtype):
    return X.slstm_init(generator, cfg.d_model, cfg.n_heads, device=device,
                        dtype=dtype)


def _slstm_cache(cfg: ArchConfig, batch: int, max_seq: int, device):
    return X.init_slstm_cache(batch, cfg.d_model, cfg.n_heads,
                              device=device)


def _slstm_prefill(blk: Block, h, cache, attn_impl, ssm_impl):
    return X.slstm_forward(blk.mixer, h, blk.cfg.n_heads, impl=ssm_impl)


def _slstm_decode(blk: Block, h, cache, pos, attn_impl):
    return X.slstm_decode(blk.mixer, h, cache, blk.cfg.n_heads)[0]


def _stateless(prefill: Callable) -> Callable:
    """A recurrent kind's train forward: its prefill, which leaves the
    cache as it was (and so needs none)."""
    return lambda blk, h, attn_impl, ssm_impl: prefill(blk, h, None,
                                                       attn_impl, ssm_impl)


@dataclass(frozen=True)
class Kind:
    """Everything the stack knows of one block kind."""
    mixer_key: str      # the reference's name for its mixer parameters
    cache_key: str      # the reference's name for its cache
    cache_names: Tuple[str, ...]
    init: Callable      # (generator, cfg, device, dtype) -> mixer params
    cache: Callable     # (cfg, batch, max_seq, device) -> a layer's cache
    prefill: Callable   # (block, h, cache, attn_impl, ssm_impl) -> out
    decode: Callable    # (block, h, cache, pos, attn_impl) -> out
    stack: str          # the kind whose cache stack holds this one's
    train: Callable     # (block, h, attn_impl, ssm_impl) -> out
    cache_prefix: str = ""   # before a cache name in the flat caches
    cache_fill: Tuple[Tuple[str, float], ...] = ()   # non-zero starts

    def flat(self, name: str) -> str:
        """The caches' key of the reference's cache ``name``."""
        return self.cache_prefix + name


KINDS: Dict[str, Kind] = {
    "attn": Kind("self", "kv", ("k", "v"), _attn_init, _attn_cache,
                 _attn_prefill, _attn_decode, "attn", _attn_train),
    # a cross layer's self-attention; its cross half is the Block's
    "cross": Kind("self", "kv", ("k", "v"), _attn_init, _attn_cache,
                  _attn_prefill, _attn_decode, "attn", _attn_train),
    "mamba": Kind("mamba", "mamba", ("conv", "ssm"), _mamba_init,
                  _mamba_cache, _mamba_prefill, _mamba_decode, "mamba",
                  _stateless(_mamba_prefill)),
    "mla": Kind("self", "kv", ("c_kv", "k_rope"), _mla_init, _mla_cache,
                _mla_prefill, _mla_decode, "mla", _mla_train),
    "mlstm": Kind("mlstm", "mlstm", ("c", "n", "m"), _mlstm_init,
                  _mlstm_cache, _mlstm_prefill, _mlstm_decode, "mlstm",
                  _stateless(_mlstm_prefill), "mlstm_", (("m", X.M0),)),
    "slstm": Kind("slstm", "slstm", ("c", "n", "m", "h"), _slstm_init,
                  _slstm_cache, _slstm_prefill, _slstm_decode, "slstm",
                  _stateless(_slstm_prefill), "slstm_", (("m", X.M0),)),
}


class Transformer(nn.Module):
    """Embedding (tied unembedding), the layers, the final norm; with
    ``cfg.encoder_layers``, the encoder's layers and its final norm."""

    def __init__(self, cfg: ArchConfig, embed: torch.Tensor,
                 blocks: List[Block], final_norm: Norm,
                 encoder: Optional[List[Block]] = None,
                 enc_norm: Optional[Norm] = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.encoder = nn.ModuleList(encoder or [])
        self.enc_norm = enc_norm


# --------------------------------------------------------------------- #
# parameters and caches
# --------------------------------------------------------------------- #
def _norm_params(cfg: ArchConfig, device, dtype) -> Norm:
    w = torch.ones(cfg.d_model, dtype=dtype, device=device)
    if cfg.norm == "rmsnorm":
        return Norm("rmsnorm", w)
    return Norm("layernorm", w, torch.zeros_like(w))


def _ffn_params(generator, cfg: ArchConfig, device, dtype):
    d_ff = cfg.dense_d_ff or cfg.d_ff
    if d_ff == 0:
        return None
    init = L.swiglu_init if cfg.act == "swiglu" else L.gelu_mlp_init
    return init(generator, cfg.d_model, d_ff, device=device, dtype=dtype)


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device="cuda",
                dtype: torch.dtype = torch.bfloat16,
                on_block: Optional[Callable[[int, "Block"], None]] = None
                ) -> Transformer:
    """Random parameters with the reference's distributions (N(0, 1/d_in)
    dense weights, N(0, 0.02^2) embedding, unit norms), drawn on
    ``device`` from ``generator``.  The draws are not the reference's
    (``jax.random`` and torch generators differ): tests carry the
    reference's parameters over with :func:`params_from_numpy`.  On the
    ``meta`` device nothing is drawn or allocated.  ``on_block(i,
    block)`` is called on each layer as soon as it is drawn (before the
    next draw; ``launch.serve.build`` places it there, so that a model
    larger than one card is never whole on one)."""
    _check_supported(cfg)
    device = torch.device(device)
    embed = L.embedding_init(generator, cfg.padded_vocab, cfg.d_model,
                             device=device, dtype=dtype)

    def block(kind, moe):
        mixer = KINDS[kind].init(generator, cfg, device, dtype)
        cross = norm_c = None
        if kind == "cross":
            cross = A.cross_init(generator, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.resolved_head_dim,
                                 device=device, dtype=dtype)
            norm_c = _norm_params(cfg, device, dtype)
        ffn = (MoEFFN(moe_dims(cfg), MOE.moe_init(
            generator, moe_dims(cfg), device=device, dtype=dtype))
            if moe else _ffn_params(generator, cfg, device, dtype))
        return Block(cfg, kind, _norm_params(cfg, device, dtype), mixer,
                     _norm_params(cfg, device, dtype)
                     if ffn is not None else None, ffn, cross, norm_c)

    blocks = []
    for i, (kind, moe) in enumerate(layer_plan(cfg)):
        blocks.append(block(kind, moe))
        if on_block is not None:
            on_block(i, blocks[-1])
    encoder = [block(block_kind(cfg, "attn"), False)
               for _ in range(cfg.encoder_layers)]
    return Transformer(cfg, embed, blocks, _norm_params(cfg, device, dtype),
                       encoder, _norm_params(cfg, device, dtype)
                       if encoder else None)


def cache_slots(cfg: ArchConfig) -> List[Tuple[str, int]]:
    """(kind, index in its kind's cache stack) for every layer."""
    seen = dict.fromkeys(KINDS, 0)
    out = []
    for kind, _ in layer_plan(cfg):
        out.append((kind, seen[KINDS[kind].stack]))
        seen[KINDS[kind].stack] += 1
    return out


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, *,
                memory_len: int = 0,
                memory_dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Fresh caches, each stack's over the layers it holds (a layer's
    shapes and dtypes read off its kind's cache on ``meta``), zero but
    for a kind's ``cache_fill`` (the xLSTM stabilisers' -1e30); with
    ``memory_len`` and cross layers, the memory K/V in ``memory_dtype``
    (the memory projection's, ``memory @ W`` promoted) and their
    lengths."""
    _check_supported(cfg)
    stacks = [KINDS[kind].stack for kind, _ in layer_plan(cfg)]
    caches = {}
    for name, kind in KINDS.items():
        n = stacks.count(name) if kind.stack == name else 0
        if n:
            fill = dict(kind.cache_fill)
            caches.update({kind.flat(c): torch.full(
                (n,) + t.shape, fill.get(c, 0), dtype=t.dtype,
                device=device)
                           for c, t in kind.cache(cfg, batch, max_seq,
                                                  "meta").items()})
    n_cross = [kind for kind, _ in layer_plan(cfg)].count("cross")
    if memory_len and n_cross:
        shape = (n_cross, batch, memory_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        caches["memory_k"] = torch.zeros(shape, dtype=memory_dtype,
                                         device=device)
        caches["memory_v"] = torch.zeros_like(caches["memory_k"])
        caches["memory_len"] = torch.full((batch,), memory_len,
                                          dtype=torch.int32, device=device)
    return caches


def _layer_cache(caches: Dict[str, torch.Tensor], slot: Tuple[str, int]
                 ) -> Dict[str, torch.Tensor]:
    kind, j = slot
    return {name: caches[KINDS[kind].flat(name)][j]
            for name in KINDS[kind].cache_names}


def _memory_caches(caches: Dict[str, torch.Tensor], cfg: ArchConfig
                   ) -> List[Optional[Dict[str, torch.Tensor]]]:
    """Every layer's memory K/V (and lengths): a cross layer's, None for
    the others."""
    out, j = [], 0
    for kind, _ in layer_plan(cfg):
        if kind == "cross":
            out.append({"k": caches["memory_k"][j],
                        "v": caches["memory_v"][j],
                        "lengths": caches["memory_len"]})
            j += 1
        else:
            out.append(None)
    return out


def _logits(model: Transformer, cfg: ArchConfig,
            res: Residual) -> torch.Tensor:
    return _mask_padded(L.unembed(model.final_norm(res), model.embed), cfg)


def _layer_rounds(cfg: ArchConfig) -> List[bool]:
    return carry_rounds(1 if cfg.first_layer_dense else 0,
                        len(cfg.pattern), n_scan_reps(cfg))


def encode(model: Transformer, cfg: ArchConfig, frames: torch.Tensor,
           attn_impl: str = "kernel") -> torch.Tensor:
    """The bidirectional encoder over precomputed frontend embeddings
    ``frames`` (B, M, d), then its final norm (the reference scans its
    layers: the carry is rounded between them, :func:`carry_rounds`)."""
    n = len(model.encoder)
    res = residual(frames)
    for blk, rounds in zip(model.encoder, carry_rounds(0, 1, n)):
        res = blk.encode(residual(res[0]) if rounds else res, attn_impl)
    return model.enc_norm(residual(res[0]) if n >= 2 else res)


def _has_cross(cfg: ArchConfig) -> bool:
    return "cross" in cfg.pattern


def forward_prefill(model: Transformer, cfg: ArchConfig,
                    tokens: torch.Tensor, caches: Dict[str, torch.Tensor],
                    memory: Optional[torch.Tensor] = None,
                    attn_impl: str = "kernel", ssm_impl: str = "kernel",
                    encoded: bool = False
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: returns (last-token logits (B, Vp) f32, the caches, the
    KV caches filled in place).  A model with cross layers takes
    ``memory`` (B, M, d) -- run through the encoder first when it has one
    and ``encoded`` is false (a caller that times the encoder apart passes
    :func:`encode`'s output and ``encoded=True``) -- and writes its
    memory K/V into caches made with ``memory_len=M``."""
    if _has_cross(cfg):
        if memory is None or "memory_k" not in caches:
            raise ValueError(f"{cfg.name} cross-attends: prefill needs a "
                             f"memory and caches made with memory_len")
        if cfg.encoder_layers and not encoded:
            memory = encode(model, cfg, memory, attn_impl)
        mems = _memory_caches(caches, cfg)
    else:
        mems = [None] * len(model.blocks)
    res = residual(L.embed(tokens, model.embed))
    rounds = _layer_rounds(cfg)
    for blk, slot, mem, rnd in zip(model.blocks, cache_slots(cfg), mems,
                                   rounds):
        res = blk.prefill(residual(res[0]) if rnd else res,
                          _layer_cache(caches, slot), attn_impl, ssm_impl,
                          memory, mem)
    last = res[0][:, -1]
    return _logits(model, cfg, residual(last) if n_scan_reps(cfg) >= 2
                   else (last, res[1][:, -1])), caches


def forward_decode(model: Transformer, cfg: ArchConfig, token: torch.Tensor,
                   caches: Dict[str, torch.Tensor], pos: torch.Tensor,
                   attn_impl: str = "kernel"
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. token (B,), pos (B,) int32 -> (logits (B, Vp)
    f32, the caches, appended in place)."""
    mems = (_memory_caches(caches, cfg) if _has_cross(cfg)
            else [None] * len(model.blocks))
    res = residual(L.embed(token, model.embed))
    rounds = _layer_rounds(cfg)
    for blk, slot, mem, rnd in zip(model.blocks, cache_slots(cfg), mems,
                                   rounds):
        res = blk.decode(residual(res[0]) if rnd else res,
                         _layer_cache(caches, slot), pos, attn_impl, mem)
    return _logits(model, cfg, residual(res[0]) if n_scan_reps(cfg) >= 2
                   else res), caches


def _train_layers(blocks, res: Residual, aux: torch.Tensor,
                  attn_impl: str, ssm_impl: str,
                  memory: Optional[torch.Tensor]
                  ) -> Tuple[Residual, torch.Tensor]:
    for blk in blocks:
        res, a = blk.forward_train(res, attn_impl, ssm_impl, memory)
        if a is not None:
            aux = aux + a
    return res, aux


def forward_train(model: Transformer, cfg: ArchConfig, tokens: torch.Tensor,
                  memory: Optional[torch.Tensor] = None,
                  attn_impl: str = "qchunk", ssm_impl: str = "ref",
                  remat: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, Vp) f32 with the vocab tail at
    -1e30, the MoE layers' aux loss summed, f32 ()), every layer over the
    whole sequence with no cache.  A model with cross layers takes
    ``memory`` (B, M, d), run through the encoder first when it has one.
    With ``remat`` each repetition of the pattern is checkpointed
    (``torch.utils.checkpoint``, non-reentrant), as the reference wraps
    its scan body in ``jax.checkpoint``: the backward keeps the stream
    between repetitions and recomputes a repetition's activations.

    Differentiable through the plain paths only: ``attn_impl="qchunk"``
    or ``"ref"`` and ``ssm_impl="ref"`` (a kernel refuses inputs that
    require grad)."""
    if _has_cross(cfg) and memory is None:
        raise ValueError(f"{cfg.name} cross-attends: training needs a "
                         f"memory")
    if cfg.encoder_layers and memory is not None:
        memory = encode(model, cfg, memory, attn_impl)
    res = residual(L.embed(tokens, model.embed))
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    n_prefix = 1 if cfg.first_layer_dense else 0
    period, reps = len(cfg.pattern), n_scan_reps(cfg)
    blocks = list(model.blocks)
    res, aux = _train_layers(blocks[:n_prefix], res, aux, attn_impl,
                             ssm_impl, memory)
    for r in range(reps):
        rep = blocks[n_prefix + r * period:n_prefix + (r + 1) * period]
        if reps >= 2:                   # the scan's carry (carry_rounds)
            res = residual(res[0])
        args = (rep, res, aux, attn_impl, ssm_impl, memory)
        res, aux = (checkpoint(_train_layers, *args, use_reentrant=False,
                               context_fn=_Recompute())
                    if remat else _train_layers(*args))
    return _logits(model, cfg, residual(res[0]) if reps >= 2 else res), aux


def like(model: nn.Module, tensors) -> nn.Module:
    """A module of ``model``'s structure whose parameters are ``tensors``
    (in ``model.parameters()`` order, any dtype, not trainable):
    gradients and optimizer moments in the parameters' layout, so
    :func:`params_to_numpy` gives them in the reference's tree."""
    memo = {id(p): nn.Parameter(t, requires_grad=False)
            for p, t in zip(model.parameters(), tensors, strict=True)}
    for m in model.modules():      # check hooks are not copied
        if isinstance(m, MoEFFN):
            memo[id(m.record)] = memo[id(m.replay)] = None
    return copy.deepcopy(model, memo)


def leaf_groups(model: Transformer) -> List[List[int]]:
    """For each leaf of the reference's parameter tree, the indices into
    ``model.parameters()`` of the parameters it stacks: a pattern slot's
    parameter over the repetitions, an encoder parameter over the
    encoder's layers, any other alone (per-tensor statistics, such as
    the int8 gradient scale, are per reference leaf)."""
    cfg = model.cfg
    n_prefix = 1 if cfg.first_layer_dense else 0
    groups: Dict[tuple, List[int]] = {}
    for i, (name, _) in enumerate(model.named_parameters()):
        parts = name.split(".")
        if parts[0] == "blocks":
            layer = int(parts[1])
            slot = ("first" if layer < n_prefix
                    else (layer - n_prefix) % len(cfg.pattern))
            key = ("blocks", slot, *parts[2:])
        elif parts[0] == "encoder":
            key = ("encoder", *parts[2:])
        else:
            key = tuple(parts)
        groups.setdefault(key, []).append(i)
    return list(groups.values())


# --------------------------------------------------------------------- #
# carry-over from the reference's parameter tree (numpy arrays)
# --------------------------------------------------------------------- #
def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, bit for bit; a bf16 array (``ml_dtypes``, which
    ``np.asarray`` of a bf16 JAX array gives) travels as int16, and a
    uint16 array is taken as bf16 bit patterns (what :func:`_to_numpy`
    gives without ``bf16_dtype``; no tensor of the port is uint16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _to_numpy(t: torch.Tensor, bf16_dtype=None) -> np.ndarray:
    """torch -> numpy, bit for bit.  bf16 comes back as ``bf16_dtype``
    (pass the reference array's dtype) or, without it, as the uint16 bit
    patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        a = t.view(torch.int16).numpy().view(np.uint16)
        return a.view(bf16_dtype) if bf16_dtype is not None else a
    return t.numpy()


def _norm_from(cfg: ArchConfig, tree, device) -> Norm:
    if cfg.norm == "rmsnorm":
        return Norm("rmsnorm", _from_numpy(tree, device))
    return Norm("layernorm", _from_numpy(tree["w"], device),
                _from_numpy(tree["b"], device))


def _rep(tree, r: int):
    """Repetition ``r`` of a (sub)tree of stacked leaves."""
    if isinstance(tree, dict):
        return {k: _rep(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def _tree_from(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_from(v, device) for k, v in tree.items()}
    return _from_numpy(tree, device)


def _block_from(cfg: ArchConfig, kind: str, moe: bool, p, device) -> Block:
    """One layer from one (unstacked) block of the reference's tree."""
    mixer = _tree_from(p["mixer"][KINDS[kind].mixer_key], device)
    cross = norm_c = None
    if kind == "cross":
        cross = _tree_from(p["mixer"]["cross"], device)
        norm_c = _norm_from(cfg, p["mixer"]["norm_c"], device)
    n2 = ffn = None
    if "ffn" in p:
        ffn = _tree_from(p["ffn"], device)
        if moe:
            ffn = MoEFFN(moe_dims(cfg), ffn)
        n2 = _norm_from(cfg, p["norm2"], device)
    return Block(cfg, kind, _norm_from(cfg, p["norm1"], device), mixer, n2,
                 ffn, cross, norm_c)


def params_from_numpy(cfg: ArchConfig, tree, device="cuda") -> Transformer:
    """The reference's parameter tree (``jax.tree.map(np.asarray,
    params)``: per-slot leaves stacked over repetitions, the dense first
    layer under ``"first"``, the encoder's layers stacked under
    ``"encoder"`` and its norm under ``"enc_norm"``) as the port's
    :class:`Transformer`, bit for bit."""
    blocks = ([_block_from(cfg, block_kind(cfg, "attn"), False,
                           tree["first"], device)]
              if cfg.first_layer_dense else [])
    for r in range(n_scan_reps(cfg)):
        for j, (kind, moe) in enumerate(slot_kinds(cfg)):
            blocks.append(_block_from(cfg, block_kind(cfg, kind), moe,
                                      _rep(tree["slots"][j], r), device))
    encoder = [_block_from(cfg, block_kind(cfg, "attn"), False,
                           _rep(tree["encoder"], r), device)
               for r in range(cfg.encoder_layers)]
    return Transformer(cfg, _from_numpy(tree["embed"], device), blocks,
                       _norm_from(cfg, tree["final_norm"], device), encoder,
                       _norm_from(cfg, tree["enc_norm"], device)
                       if encoder else None)


def params_to_tree(model: Transformer, leaf: Callable = lambda t: t,
                   stack: Callable = torch.stack):
    """The port's parameters in the reference's tree (per-slot leaves
    stacked over repetitions, ``"first"``, ``"encoder"``, ...): each
    parameter through ``leaf``, a slot's or the encoder's repetitions
    through ``stack`` (a list of ``leaf``'s results).  On the ``meta``
    device the defaults give the reference's ``param_specs`` tree."""
    cfg = model.cfg

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        return leaf(t)

    def norm(n: Norm):
        return tree(n.w) if n.kind == "rmsnorm" else tree({"w": n.w,
                                                           "b": n.b})

    def stacked(trees):
        if isinstance(trees[0], dict):
            return {k: stacked([t[k] for t in trees]) for k in trees[0]}
        return stack(trees)

    def one(b: Block):
        p = {"norm1": norm(b.norm1),
             "mixer": {KINDS[b.kind].mixer_key: tree(dict(b.mixer))}}
        if b.cross is not None:
            p["mixer"]["cross"] = tree(dict(b.cross))
            p["mixer"]["norm_c"] = norm(b.norm_c)
        if b.ffn is not None:
            p["norm2"] = norm(b.norm2)
            p["ffn"] = tree(b.ffn.tree() if isinstance(b.ffn, MoEFFN)
                            else dict(b.ffn))
        return p

    blocks = list(model.blocks)
    out = {"embed": leaf(model.embed), "final_norm": norm(model.final_norm)}
    if cfg.first_layer_dense:
        out["first"] = one(blocks.pop(0))
    n = len(cfg.pattern)
    out["slots"] = [stacked([one(blocks[r * n + j])
                             for r in range(n_scan_reps(cfg))])
                    for j in range(n)]
    if cfg.encoder_layers:
        out["encoder"] = stacked([one(b) for b in model.encoder])
        out["enc_norm"] = norm(model.enc_norm)
    return out


def params_to_numpy(model: Transformer, bf16_dtype=None):
    """The inverse of :func:`params_from_numpy`: the reference's tree of
    numpy arrays (see :func:`_to_numpy` for bf16)."""
    return params_to_tree(model, lambda t: _to_numpy(t, bf16_dtype),
                          np.stack)


def leaf_names(model: Transformer) -> Dict[str, List[str]]:
    """For each leaf of the reference's parameter tree (its path, dict
    keys and list indices joined by ``/``), the names in
    ``model.named_parameters()`` of the parameters it holds: a stacked
    leaf's repetitions in order, any other leaf's one parameter."""
    names = {id(p): n for n, p in model.named_parameters()}
    tree = params_to_tree(model, lambda t: _Names([names[id(t)]]),
                          lambda ts: _Names(sum((t.names for t in ts), [])))
    return {k: v.names for k, v in tree_paths(tree).items()}


class _Names:
    """A leaf of :func:`leaf_names`' tree (a list would be a subtree)."""

    def __init__(self, names: List[str]):
        self.names = names


def tree_paths(tree, prefix: str = "") -> Dict:
    """``{path: leaf}`` of a tree of dicts, lists and tuples, the path its
    keys and indices joined by ``/`` -- the reference's
    ``launch.sharding._path_str`` -- with a NamedTuple field written as
    JAX writes it, ``.name``."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out: Dict = {}
    for k, v in items:
        out.update(tree_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def caches_to_numpy(cfg: ArchConfig, caches: Dict[str, torch.Tensor],
                    bf16_dtype=None):
    """:func:`caches_to_tree` as numpy arrays (see :func:`_to_numpy` for
    bf16)."""
    return caches_to_tree(cfg, caches, lambda t: _to_numpy(t, bf16_dtype))


def caches_to_tree(cfg: ArchConfig, caches: Dict[str, torch.Tensor],
                   leaf: Callable = lambda t: t):
    """The port's caches in the reference's layout, each leaf through
    ``leaf`` (on the ``meta`` device the reference's ``cache_specs``): ``{"slots": [...]}``
    with ``{"kv": {"k", "v"}}`` (leaves ``(reps, B, S, Hkv, D)``) for an
    attention slot, ``{"kv": {"c_kv", "k_rope"}}`` (leaves ``(reps, B, S,
    kv_lora)`` and ``(reps, B, S, rope)``) for an MLA one and
    ``{"mamba": {"conv", "ssm"}}`` (leaves ``(reps, B, K-1, d_inner)`` and
    ``(reps, B, d_inner, N)``) for a Mamba slot, ``{"mlstm": {"c", "n",
    "m"}}`` and ``{"slstm": {"c", "n", "m", "h"}}`` for the xLSTM slots
    (leaves ``(reps, ...)`` of :func:`init_caches`' shapes), the dense
    first layer's
    ``{"kv": ...}`` under ``"first"``, and with memory K/V the
    reference's ``"memory_kv"``: per slot ``{"k", "v"}`` (leaves ``(reps,
    B, M, Hkv, D)``) for a cross slot, ``{}`` for the others."""
    reps = n_scan_reps(cfg)
    where = cache_slots(cfg)
    n_prefix = 1 if cfg.first_layer_dense else 0

    def layer(kind, idx):
        kind = block_kind(cfg, kind)
        k = KINDS[kind]
        return {k.cache_key: {
            name: leaf(caches[k.flat(name)][idx])
            for name in k.cache_names}}

    out = {"slots": [layer(kind, [where[n_prefix + r * len(cfg.pattern)
                                        + j][1] for r in range(reps)])
                     for j, kind in enumerate(cfg.pattern)]}
    if cfg.first_layer_dense:
        out["first"] = layer("attn", where[0][1])
    if "memory_k" in caches:
        # the cross layers in order are rep-major over the pattern's
        # cross slots
        slots = [j for j, kind in enumerate(cfg.pattern) if kind == "cross"]
        out["memory_kv"] = [
            {name: leaf(caches[f"memory_{name}"][
                [r * len(slots) + slots.index(j) for r in range(reps)]])
             for name in ("k", "v")}
            if kind == "cross" else {}
            for j, kind in enumerate(cfg.pattern)]
    return out
