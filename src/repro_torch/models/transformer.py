"""Architecture assembly for serving: the dense ``"attn"`` block stack
(the port of ``repro.models.transformer``'s dense path).

The reference stacks parameters per pattern slot and runs
``jax.lax.scan`` over repetitions; the port holds one :class:`Block` per
layer in an ``nn.ModuleList`` and loops over them in Python.  Global
layer ``n_prefix + r * len(pattern) + j`` is the reference's slot ``j``,
repetition ``r`` -- :func:`params_from_numpy` / :func:`params_to_numpy`
map between the two.

Supported: ``"attn"`` blocks with a dense FFN (SwiGLU or GELU, RMSNorm or
LayerNorm).  Mamba, mLSTM/sLSTM and cross-attention blocks, MoE FFNs, MLA
and a dense first layer raise ``NotImplementedError`` naming the ROADMAP
item that ports them.

Caches are ``{"k", "v"}`` tensors of shape ``(n_layers, B, max_seq, Hkv,
D)`` in bf16, written in place by prefill and decode.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

_QUEUE = "ROADMAP Queue 1 item 11"


# --------------------------------------------------------------------- #
# what the port serves
# --------------------------------------------------------------------- #
def _check_supported(cfg: ArchConfig) -> None:
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: multi-head latent attention (models/mla.py) is "
            f"not ported yet ({_QUEUE})")
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE FFNs (models/moe.py) are not ported yet "
            f"({_QUEUE})")
    if cfg.first_layer_dense:
        raise NotImplementedError(
            f"{cfg.name}: a dense first layer outside the pattern is not "
            f"ported yet ({_QUEUE}, with models/moe.py)")
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder and cross-attention (VLM/audio) are "
            f"not ported yet ({_QUEUE})")
    for kind in cfg.pattern:
        if kind == "mamba":
            raise NotImplementedError(
                f"{cfg.name}: Mamba blocks (models/mamba.py and the "
                f"ssm_scan kernel) are not ported yet ({_QUEUE}; ROADMAP "
                f"Queue 2 item 4)")
        if kind in ("mlstm", "slstm"):
            raise NotImplementedError(
                f"{cfg.name}: {kind} blocks (models/xlstm.py) are not "
                f"ported yet ({_QUEUE})")
        if kind == "cross":
            raise NotImplementedError(
                f"{cfg.name}: cross-attention blocks (VLM/audio) are not "
                f"ported yet ({_QUEUE})")
        if kind != "attn":
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


class Norm(nn.Module):
    """RMSNorm (weight ``w``) or LayerNorm (``w`` and ``b``)."""

    def __init__(self, kind: str, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None):
        super().__init__()
        self.kind = kind
        self.w = _frozen(w)
        self.b = _frozen(b) if b is not None else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "rmsnorm":
            return L.rmsnorm(x, self.w)
        return L.layernorm(x, self.w, self.b)


class Block(nn.Module):
    """One ``"attn"`` layer: pre-norm self-attention and a dense FFN."""

    def __init__(self, cfg: ArchConfig, norm1: Norm,
                 attn: Dict[str, torch.Tensor], norm2: Optional[Norm],
                 ffn: Optional[Dict[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.norm1 = norm1
        self.attn = nn.ParameterDict({k: _frozen(v) for k, v in
                                      attn.items()})
        self.norm2 = norm2
        self.ffn = (nn.ParameterDict({k: _frozen(v) for k, v in
                                      ffn.items()})
                    if ffn is not None else None)

    def _dims(self) -> dict:
        cfg = self.cfg
        return {"n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                "head_dim": cfg.resolved_head_dim,
                "rope_theta": cfg.rope_theta}

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        if self.ffn is None:
            return x
        h = self.norm2(x)
        if self.cfg.act == "swiglu":
            return x + L.swiglu(h, self.ffn)
        return x + L.gelu_mlp(h, self.ffn)

    def prefill(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                impl: str) -> torch.Tensor:
        o, _ = A.attn_prefill(self.attn, self.norm1(x), cache, impl=impl,
                              **self._dims())
        return self._ffn(x + o)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: torch.Tensor, impl: str) -> torch.Tensor:
        o, _ = A.attn_decode(self.attn, self.norm1(x), cache, pos,
                             impl=impl, **self._dims())
        return self._ffn(x + o)


class Transformer(nn.Module):
    """Embedding (tied unembedding), the layers, the final norm."""

    def __init__(self, cfg: ArchConfig, embed: torch.Tensor,
                 blocks: List[Block], final_norm: Norm):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = _frozen(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm


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
                dtype: torch.dtype = torch.bfloat16) -> Transformer:
    """Random parameters with the reference's distributions (N(0, 1/d_in)
    dense weights, N(0, 0.02^2) embedding, unit norms), drawn on
    ``device`` from ``generator``.  The draws are not the reference's
    (``jax.random`` and torch generators differ): tests carry the
    reference's parameters over with :func:`params_from_numpy`.  On the
    ``meta`` device nothing is drawn or allocated."""
    device = torch.device(device)
    hd = cfg.resolved_head_dim
    embed = L.embedding_init(generator, cfg.padded_vocab, cfg.d_model,
                             device=device, dtype=dtype)
    blocks = []
    for _ in range(cfg.n_layers):
        attn = A.attn_init(generator, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, hd, device=device, dtype=dtype)
        ffn = _ffn_params(generator, cfg, device, dtype)
        blocks.append(Block(cfg, _norm_params(cfg, device, dtype), attn,
                            _norm_params(cfg, device, dtype)
                            if ffn is not None else None, ffn))
    return Transformer(cfg, embed, blocks, _norm_params(cfg, device, dtype))


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, *,
                device="cuda") -> Dict[str, torch.Tensor]:
    _check_supported(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _layer_cache(caches: Dict[str, torch.Tensor], i: int
                 ) -> Dict[str, torch.Tensor]:
    return {"k": caches["k"][i], "v": caches["v"][i]}


def _logits(model: Transformer, cfg: ArchConfig,
            x: torch.Tensor) -> torch.Tensor:
    x = model.final_norm(x)
    return _mask_padded(L.unembed(x, model.embed), cfg)


def forward_prefill(model: Transformer, cfg: ArchConfig,
                    tokens: torch.Tensor, caches: Dict[str, torch.Tensor],
                    attn_impl: str = "kernel"
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: returns (last-token logits (B, Vp) f32, the caches,
    filled in place)."""
    x = L.embed(tokens, model.embed)
    for i, blk in enumerate(model.blocks):
        x = blk.prefill(x, _layer_cache(caches, i), attn_impl)
    return _logits(model, cfg, x[:, -1]), caches


def forward_decode(model: Transformer, cfg: ArchConfig, token: torch.Tensor,
                   caches: Dict[str, torch.Tensor], pos: torch.Tensor,
                   attn_impl: str = "kernel"
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. token (B,), pos (B,) int32 -> (logits (B, Vp)
    f32, the caches, appended in place)."""
    x = L.embed(token, model.embed)
    for i, blk in enumerate(model.blocks):
        x = blk.decode(x, _layer_cache(caches, i), pos, attn_impl)
    return _logits(model, cfg, x), caches


# --------------------------------------------------------------------- #
# carry-over from the reference's parameter tree (numpy arrays)
# --------------------------------------------------------------------- #
def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> torch, bit for bit; a bf16 array (``ml_dtypes``, which
    ``np.asarray`` of a bf16 JAX array gives) travels as int16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
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


def _layer_index(cfg: ArchConfig, j: int, r: int) -> int:
    n_prefix = 1 if cfg.first_layer_dense else 0
    return n_prefix + r * len(cfg.pattern) + j


def _norm_from(cfg: ArchConfig, tree, device) -> Norm:
    if cfg.norm == "rmsnorm":
        return Norm("rmsnorm", _from_numpy(tree, device))
    return Norm("layernorm", _from_numpy(tree["w"], device),
                _from_numpy(tree["b"], device))


def _norm_to(norm: Norm, bf16_dtype):
    if norm.kind == "rmsnorm":
        return _to_numpy(norm.w, bf16_dtype)
    return {"w": _to_numpy(norm.w, bf16_dtype),
            "b": _to_numpy(norm.b, bf16_dtype)}


def _rep(tree, r: int):
    """Repetition ``r`` of a (sub)tree of stacked leaves."""
    if isinstance(tree, dict):
        return {k: _rep(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def params_from_numpy(cfg: ArchConfig, tree, device="cuda") -> Transformer:
    """The reference's parameter tree (``jax.tree.map(np.asarray,
    params)``: per-slot leaves stacked over repetitions) as the port's
    :class:`Transformer`, bit for bit."""
    blocks: List[Optional[Block]] = [None] * cfg.n_layers
    for j, slot in enumerate(tree["slots"]):
        for r in range(n_scan_reps(cfg)):
            p = _rep(slot, r)
            attn = {k: _from_numpy(v, device)
                    for k, v in p["mixer"]["self"].items()}
            n2 = ffn = None
            if "ffn" in p:
                ffn = {k: _from_numpy(v, device)
                       for k, v in p["ffn"].items()}
                n2 = _norm_from(cfg, p["norm2"], device)
            blocks[_layer_index(cfg, j, r)] = Block(
                cfg, _norm_from(cfg, p["norm1"], device), attn, n2, ffn)
    return Transformer(cfg, _from_numpy(tree["embed"], device), blocks,
                       _norm_from(cfg, tree["final_norm"], device))


def params_to_numpy(model: Transformer, bf16_dtype=None):
    """The inverse of :func:`params_from_numpy`: the reference's tree of
    numpy arrays (see :func:`_to_numpy` for bf16)."""
    cfg = model.cfg

    def stacked(trees):
        if isinstance(trees[0], dict):
            return {k: stacked([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    def one(b: Block):
        p = {"norm1": _norm_to(b.norm1, bf16_dtype),
             "mixer": {"self": {k: _to_numpy(v, bf16_dtype)
                                for k, v in b.attn.items()}}}
        if b.ffn is not None:
            p["norm2"] = _norm_to(b.norm2, bf16_dtype)
            p["ffn"] = {k: _to_numpy(v, bf16_dtype)
                        for k, v in b.ffn.items()}
        return p

    slots = [stacked([one(model.blocks[_layer_index(cfg, j, r)])
                      for r in range(n_scan_reps(cfg))])
             for j in range(len(cfg.pattern))]
    return {"embed": _to_numpy(model.embed, bf16_dtype),
            "final_norm": _norm_to(model.final_norm, bf16_dtype),
            "slots": slots}


def caches_to_numpy(cfg: ArchConfig, caches: Dict[str, torch.Tensor],
                    bf16_dtype=None):
    """The port's caches in the reference's layout:
    ``{"slots": [{"kv": {"k", "v"}}]}`` with leaves ``(reps, B, S, Hkv,
    D)`` per pattern slot."""
    reps = n_scan_reps(cfg)
    slots = []
    for j in range(len(cfg.pattern)):
        idx = [_layer_index(cfg, j, r) for r in range(reps)]
        slots.append({"kv": {name: _to_numpy(caches[name][idx],
                                             bf16_dtype)
                             for name in ("k", "v")}})
    return {"slots": slots}
