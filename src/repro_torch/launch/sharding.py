"""Per-architecture sharding rules (DP x TP x EP x SP on the production
mesh; the port of ``repro.launch.sharding``).

Each rule comes in two halves:

* **(a) the spec**, a pure function of the REFERENCE's tree paths and
  shapes (dict keys and list indices joined by ``/``, a scan-stacked
  leaf with its leading repetition dim): a tuple with one entry a
  dimension, each an axis name, a tuple of names or ``None`` -- a
  ``PartitionSpec`` as JAX normalises it (a one-name tuple is the name,
  an empty one ``None``).  ``mesh`` is a ``DeviceMesh`` or an ``{axis:
  size}`` mapping.  ``transformer.params_to_tree`` / ``caches_to_tree``
  give the port's trees in that layout.
* **(b) its realisation** on a ``DeviceMesh`` for the port's own tensors
  (:func:`placements`, :func:`shard_model`, :func:`shard_caches`,
  :func:`shard_batch`, :func:`shard_opt_state`): DTensor ``Shard`` /
  ``Replicate`` placements, a spec entry of several axes sharding one
  dim over each of them in mesh order (``("pod", "data")`` is pod-major,
  as in GSPMD).  The port keeps one tensor a layer: a per-layer tensor
  takes its reference leaf's spec less the leading repetition entry.
  Where the reference's spec shards that repetition entry (FSDP over the
  stacked dim, llama4-scout's at |data| 16), :func:`shard_model` stores
  the slot's layers stacked, placed by the whole spec, and each layer
  reads its repetition off the stack (:class:`StackedParams`).  DTensor
  splits a dim that the mesh does not divide unevenly where GSPMD pads
  (granite's 49,155-row vocabulary pads to ``padded_vocab`` first, so
  it divides).

Key decisions (the reference's):

* params: column-sharded in-projections / row-sharded out-projections
  (Megatron TP); expert dimension over ``data`` and the expert FFN dim
  over ``model`` (EP x TP); embeddings sharded on vocab; norms, routers
  and small vectors replicated; xLSTM blocks replicated (DP-only).
* KV caches: heads over ``model`` when ``n_kv_heads % |model| == 0``,
  otherwise sequence-sharded (SP: the masked append writes only the
  shard holding the row).
* MLA latent cache: sequence-sharded.
* batch dims over ``('pod', 'data')``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
# a plain tensor beside a DTensor counts as replicated: the context the
# placed paths (the train step, prefill, decode) run in
from torch.distributed.tensor.experimental import (  # noqa: F401
    implicit_replication)

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models import shards
from repro_torch.models import transformer as T

Spec = Tuple


def _dp(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def _entry(axes):
    """A spec entry as ``PartitionSpec`` normalises it."""
    if isinstance(axes, (tuple, list)):
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else tuple(axes)
    return axes


def spec(*entries) -> Spec:
    return tuple(_entry(e) for e in entries)


def fit_batch_axes(mesh, batch: int, include_model: bool = False
                   ) -> tuple:
    """Largest prefix of the DP axes (optionally + model) whose product
    divides ``batch`` -- small serving batches (or batch=1 long-context
    decode) simply use fewer DP axes."""
    shape = mesh_shape(mesh)
    axes, prod = [], 1
    for ax in _dp(mesh) + (("model",) if include_model else ()):
        if batch % (prod * shape[ax]) == 0:
            axes.append(ax)
            prod *= shape[ax]
        else:
            break
    return tuple(axes)


def _pad(s: Spec, ndim: int) -> Spec:
    """Left-pad a spec with None up to ndim (scan-stacked leading dims)."""
    missing = ndim - len(s)
    if missing < 0:
        raise ValueError(f"spec {s} longer than ndim {ndim}")
    return (None,) * missing + tuple(s)


# --------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------- #
def _is_stacked(path: str) -> bool:
    """Scan-stacked leaves (slots / encoder / memory_kv) carry a leading
    repetition dim; 'first'-layer and top-level leaves do not."""
    return ("slots/" in path or path.startswith("slots")
            or "encoder" in path or "memory_kv" in path)


def _param_spec(path: str, ndim: int, cfg: ArchConfig, mesh) -> Spec:
    m = "model"
    base = ndim - (1 if _is_stacked(path) else 0)
    if "mlstm" in path or "slstm" in path:        # DP-only: replicate
        return _pad((), ndim)
    if "embed" in path:
        return _pad((m, None), ndim)
    if base <= 1 or "norm" in path:               # norms, scalars, biases
        return _pad((), ndim)
    if "router" in path:
        return _pad((), ndim)
    # MoE expert stacks (E, d_in, d_out): E over data (EP), ff over model
    if base == 3 and any(k in path for k in ("w_gate", "w_up")):
        return _pad(("data", None, m), ndim)
    if base == 3 and "w_down" in path:
        return _pad(("data", m, None), ndim)
    # MLA
    if any(k in path for k in ("w_dq", "w_dkv", "w_krope")):
        return _pad((None, None), ndim)
    if any(k in path for k in ("w_uq", "w_uk", "w_uv")):
        return _pad((None, m), ndim)
    # attention projections
    if any(k in path for k in ("wq", "wk", "wv")):
        hkv = cfg.n_kv_heads * cfg.resolved_head_dim
        if ("wk" in path or "wv" in path) and hkv % mesh_shape(mesh)[m]:
            return _pad((None, None), ndim)        # kv too narrow to shard
        return _pad((None, m), ndim)
    if "wo" in path:
        return _pad((m, None), ndim)
    # dense FFN (base ndim 2)
    if any(k in path for k in ("w_in", "w_gate", "w_up", "in_proj",
                                "dt_proj", "conv_w")):
        return _pad((None, m), ndim)
    if any(k in path for k in ("w_out", "w_down", "x_proj", "out_proj",
                                "a_log")):
        return _pad((m, None), ndim)
    if path.endswith("up") or "/up" in path:
        return _pad((None, m), ndim)
    if path.endswith("down") or "/down" in path:
        return _pad((m, None), ndim)
    return _pad((), ndim)


FSDP_PARAM_THRESHOLD = 20e9  # params above this also shard over 'data'


def _needs_fsdp(cfg: ArchConfig) -> bool:
    from repro_torch.models.model import param_count
    return param_count(cfg) > FSDP_PARAM_THRESHOLD


def _uses_data(s: Spec) -> bool:
    return any(ax == "data" or (isinstance(ax, tuple) and "data" in ax)
               for ax in s)


def _add_fsdp(s: Spec, shape, mesh) -> Spec:
    """ZeRO-3/FSDP: also shard big weights over 'data' for storage
    (gathered at use): the first un-sharded dim whose size |data|
    divides."""
    data = mesh_shape(mesh)["data"]
    dims = list(s) + [None] * (len(shape) - len(s))
    for i, (d, sz) in enumerate(zip(dims, shape)):
        if d is None and sz % data == 0 and sz >= data:
            dims[i] = "data"
            return tuple(dims)
    return s


def _weight_spec(path: str, shape, cfg: ArchConfig, mesh,
                 fsdp: bool) -> Spec:
    s = _param_spec(path, len(shape), cfg, mesh)
    if fsdp and len(shape) >= 2 and "norm" not in path \
            and not _uses_data(s):       # EP-sharded weights stay put
        s = _add_fsdp(s, shape, mesh)
    return s


def _shapes(tree) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in T.tree_paths(tree).items()}


def param_shardings(cfg: ArchConfig, mesh, specs) -> Dict[str, Spec]:
    """{path: spec} of a parameter tree in the reference's layout
    (``transformer.params_to_tree``)."""
    fsdp = _needs_fsdp(cfg)
    return {p: _weight_spec(p, shp, cfg, mesh, fsdp)
            for p, shp in _shapes(specs).items()}


def opt_state_shardings(cfg: ArchConfig, mesh, specs) -> Dict[str, Spec]:
    """Optimizer state mirrors the parameters (mu/nu); the step scalar is
    replicated."""
    fsdp = _needs_fsdp(cfg)
    return {p: (() if len(shp) == 0 or p.endswith("step") or "/step" in p
                else _weight_spec(p, shp, cfg, mesh, fsdp))
            for p, shp in _shapes(specs).items()}


# --------------------------------------------------------------------- #
# inputs / caches
# --------------------------------------------------------------------- #
def _fit(s: Spec, ndim: int, stacked: bool) -> Spec:
    """Right-pad a *base* (batch-leading) spec with None to the base rank,
    then left-pad for the scan-stacking rep dim."""
    base = ndim - (1 if stacked else 0)
    body = list(s) + [None] * (base - len(s))
    if len(body) > base:
        raise ValueError(f"spec {s} longer than base rank {base}")
    return spec(*([None] if stacked else []), *body)


def _cache_spec(path: str, ndim: int, cfg: ArchConfig, mesh,
                dp: tuple) -> Spec:
    m = "model"
    head_shard = cfg.n_kv_heads % mesh_shape(mesh)[m] == 0
    stacked = "slots" in path or "memory_kv" in path
    if "mlstm" in path or "slstm" in path:
        return _fit((dp,), ndim, stacked)          # batch-only
    if "memory_kv" in path:
        # (B, M, Hkv, D): heads if divisible else replicated M
        s = (dp, None, m, None) if head_shard else (dp,)
        return _fit(s, ndim, stacked)
    if "c_kv" in path or "k_rope" in path:
        # MLA latent cache (B, S, L): sequence-sharded
        return _fit((dp, m, None), ndim, stacked)
    if path.endswith("/k") or path.endswith("/v") or "/kv/" in path:
        # (B, S, Hkv, D)
        s = (dp, None, m, None) if head_shard else (dp, m, None, None)
        return _fit(s, ndim, stacked)
    if "conv" in path:
        return _fit((dp, None, m), ndim, stacked)   # (B, K-1, d_inner)
    if "ssm" in path:
        return _fit((dp, m, None), ndim, stacked)   # (B, d_inner, N)
    return _fit((dp,), ndim, stacked)


def cache_shardings(cfg: ArchConfig, mesh, specs, batch: int
                    ) -> Dict[str, Spec]:
    """{path: spec} of a cache tree in the reference's layout
    (``transformer.caches_to_tree``)."""
    dp = fit_batch_axes(mesh, batch)
    return {p: _cache_spec(p, len(shp), cfg, mesh, dp)
            for p, shp in _shapes(specs).items()}


def batch_shardings(mesh, specs, batch: int, include_model: bool = False,
                    micro_leading: bool = False) -> Dict[str, Spec]:
    """Batch-dim sharding over as many DP axes as divide ``batch``;
    ``include_model`` folds the (otherwise idle) model axis into DP
    (xLSTM); ``micro_leading`` marks batches pre-shaped (n_micro,
    B_micro, ...) -- the microbatch dim stays unsharded."""
    dp = fit_batch_axes(mesh, batch, include_model)

    def one(ndim: int) -> Spec:
        if not dp:
            return ()
        lead = [None] if micro_leading else []
        return spec(*lead, dp, *([None] * (ndim - 1 - len(lead))))
    return {p: one(len(shp)) for p, shp in _shapes(specs).items()}


def batch_includes_model(cfg: ArchConfig) -> bool:
    return cfg.family == "ssm"  # xlstm: params replicated, model axis idle


def scalar_sharding(mesh) -> Spec:
    return ()


# --------------------------------------------------------------------- #
# (b) DTensor placements for the port's tensors
# --------------------------------------------------------------------- #
def placements(s: Spec, mesh) -> List:
    """The DTensor placements of spec ``s`` on ``mesh``: ``Shard(d)`` on
    each mesh dim that an entry ``d`` names, ``Replicate()`` on the
    others."""
    out: List = [Replicate()] * mesh.ndim
    for d, e in enumerate(s):
        for ax in ((e,) if isinstance(e, str) else (e or ())):
            out[mesh.mesh_dim_names.index(ax)] = Shard(d)
    return out


def place(t: torch.Tensor, s: Spec, mesh) -> DTensor:
    """``t`` (the same full tensor on every rank) as a DTensor by ``s``:
    each rank keeps a copy of its shard (so the full tensor can be
    freed), nothing is communicated."""
    pls = placements(s, mesh)
    if all(mesh.size(i) == 1 for i, p in enumerate(pls) if p.is_shard()):
        # whole on every rank: no split, no copy
        return DTensor.from_local(t, mesh, pls, run_check=False,
                                  shape=t.shape, stride=t.stride())
    d = distribute_tensor(t, mesh, pls, src_data_rank=None)
    local = d.to_local()
    if not local.is_meta and local.numel() < t.numel() and (
            local.untyped_storage().data_ptr()
            == t.untyped_storage().data_ptr()):
        d = DTensor.from_local(local.clone(), mesh, d.placements,
                               run_check=False, shape=d.shape,
                               stride=d.stride())
    return d


class StackedParams(nn.Module):
    """The layers' parameters of one reference leaf, stored stacked over
    the repetitions and placed by the leaf's whole spec -- where that
    spec shards the repetition dim, which no per-layer placement can
    express: each data rank holds the reference's repetitions, with its
    per-rank bytes."""

    def __init__(self, stack: DTensor, mesh):
        super().__init__()
        self.stack = nn.Parameter(stack, requires_grad=False)
        self.mesh = mesh
        self.axis = next(i for i, p in enumerate(stack.placements)
                         if isinstance(p, Shard) and p.dim == 0)
        self.rep_placements = [
            Shard(p.dim - 1) if isinstance(p, Shard) else p
            for p in stack.placements]
        self.rep_placements[self.axis] = Replicate()

    def view(self, r: int) -> DTensor:
        """Repetition ``r`` on every rank of the repetition axis: the rank
        whose shard holds it contributes its row and the others zeros,
        summed over that axis (one all-reduce of this repetition's
        bytes, which the collective record sees) -- the FSDP gather at
        use, of the one repetition the layer reads.  Its gradient (summed
        over the axis where the ranks' uses were partial, by the
        returned DTensor's backward) goes to the owner's row, zeros to
        the other ranks' stacks: every rank takes the same backward."""
        per_rank = -(-self.stack.shape[0] // self.mesh.size(self.axis))
        owner, row = divmod(r, per_rank)
        part = _OwnerRow.apply(
            self.stack.to_local(), row,
            self.mesh.get_local_rank(self.axis) == owner,
            self.mesh.get_group(self.axis))
        shape = self.stack.shape[1:]
        return DTensor.from_local(
            part, self.mesh, self.rep_placements, run_check=False,
            shape=shape, stride=torch.empty(shape, device="meta").stride())


class _OwnerRow(torch.autograd.Function):
    """Row ``row`` of the owner's local stack, summed over ``group`` with
    the other ranks' zeros (an all-reduce); backward, the (whole)
    gradient into that row on the owner, zeros elsewhere."""

    @staticmethod
    def forward(ctx, mine, row: int, owner: bool, group):
        ctx.row, ctx.owner, ctx.shape = row, owner, mine.shape
        part = mine[row] if owner else mine.new_zeros(mine.shape[1:])
        return shards.summed(part.contiguous(), [group])

    @staticmethod
    def backward(ctx, grad):
        out = grad.new_zeros(ctx.shape)
        if ctx.owner:
            out[ctx.row] = grad
        return out, None, None, None


class _Repetition(nn.Module):
    """A parametrization standing a layer's parameter for repetition
    ``r`` of a :class:`StackedParams` (the layer's own tensor is dropped:
    ``right_inverse`` keeps an empty one)."""

    def __init__(self, holder: StackedParams, r: int):
        super().__init__()
        self.holder, self.r = [holder], r      # a list: not a submodule

    def forward(self, _empty: torch.Tensor) -> torch.Tensor:
        return self.holder[0].view(self.r)

    def right_inverse(self, t: torch.Tensor) -> torch.Tensor:
        return t.new_empty(0)


def _module_of(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    parts = name.split(".")
    mod = model
    for p in parts[:-1]:
        mod = getattr(mod, p) if not p.isdigit() else mod[int(p)]
    return mod, parts[-1]


def model_shardings(model: T.Transformer, mesh
                    ) -> Tuple[Dict[str, Spec], Dict[str, Spec]]:
    """({parameter name: spec}, {reference path: spec}): the spec of each
    parameter's reference leaf, less the repetition entry for a layer of
    a stacked leaf; and the leaves whose spec shards that repetition
    entry over more than one rank, which are placed stacked
    (:class:`StackedParams`), with their whole spec."""
    cfg = model.cfg
    fsdp = _needs_fsdp(cfg)
    params = dict(model.named_parameters())
    per_layer, stacked = {}, {}
    for path, names in T.leaf_names(model).items():
        shape = tuple(params[names[0]].shape)
        is_stacked = _is_stacked(path)
        s = _weight_spec(path, ((len(names),) if is_stacked else ())
                         + shape, cfg, mesh, fsdp)
        for n in names:
            per_layer[n] = s[1:] if is_stacked else s
        if is_stacked and _size(s[0], mesh) > 1:
            stacked[path] = s
    return per_layer, stacked


def _size(entry, mesh) -> int:
    """The number of shards a spec entry makes on ``mesh`` (1 for None:
    a dim split over axes of size 1 is whole on every rank)."""
    shape = mesh_shape(mesh)
    out = 1
    for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
        out *= shape[ax]
    return out


def place_module(mod: nn.Module, specs: Dict[str, Spec], mesh,
                 prefix: str = "", skip=frozenset()) -> nn.Module:
    """Place each parameter of ``mod`` that is not placed yet, nor named
    in ``skip``, by ``specs[prefix + name]`` (:func:`model_shardings`'
    per-layer specs), in place; returns ``mod``."""
    for name, p in list(mod.named_parameters()):
        if shards.is_dtensor(p) or prefix + name in skip:
            continue
        sub, attr = _module_of(mod, name)
        sub._parameters[attr] = nn.Parameter(
            place(p.detach(), specs[prefix + name], mesh),
            requires_grad=p.requires_grad)
    return mod


def shard_model(model: T.Transformer, mesh) -> T.Transformer:
    """Place ``model``'s parameters on ``mesh`` by the rules, in place:
    each becomes a DTensor parameter holding this rank's shard (every
    rank passes the same full model).  A leaf whose spec shards the
    repetition dim is stored stacked under ``model.stacked``
    (:class:`StackedParams`), and its layers' entries read their
    repetition off the stack at use."""
    from torch.nn.utils import parametrize
    specs, stacked_specs = model_shardings(model, mesh)
    names = T.leaf_names(model)
    params = dict(model.named_parameters())
    place_module(model, specs, mesh, skip={
        n for path in stacked_specs for n in names[path]})
    stacked = {}
    for path, s in stacked_specs.items():
        holder = StackedParams(place(torch.stack(
            [params[n].detach() for n in names[path]]), s, mesh), mesh)
        stacked[path.replace("/", "_")] = holder
        for r, n in enumerate(names[path]):
            mod, attr = _module_of(model, n)
            parametrize.register_parametrization(
                mod, attr, _Repetition(holder, r), unsafe=True)
    if stacked:
        model.stacked = nn.ModuleDict(stacked)
    return model


def shard_caches(cfg: ArchConfig, caches: Dict[str, torch.Tensor], mesh,
                 batch: int) -> Dict[str, torch.Tensor]:
    """The port's caches (``transformer.init_caches``) placed by the
    reference's cache rules: each kind's stack takes its reference
    leaf's spec, the repetition entry unsharded in both layouts."""
    dp = fit_batch_axes(mesh, batch)
    out = {}
    for key, c in caches.items():
        if key == "memory_len":
            s = spec(dp)
        else:
            path = _cache_path(cfg, key)
            s = _cache_spec(path, c.dim(), cfg, mesh, dp)
        out[key] = place(c, s, mesh)
    return out


def _cache_path(cfg: ArchConfig, key: str) -> str:
    """A reference path of the port's stacked cache ``key`` (the rules
    read only its last names and whether it is stacked)."""
    if key.startswith("memory_"):
        return f"memory_kv/0/{key[len('memory_'):]}"
    for kind in T.KINDS.values():
        for name in kind.cache_names:
            if kind.flat(name) == key:
                return f"slots/0/{kind.cache_key}/{name}"
    raise KeyError(key)


def shard_batch(batch: Dict[str, torch.Tensor], mesh, size: int,
                include_model: bool = False) -> Dict[str, torch.Tensor]:
    """Inputs (the same on every rank) placed by
    :func:`batch_shardings`."""
    specs = batch_shardings(mesh, batch, size, include_model)
    return {k: place(v, specs[k], mesh) for k, v in batch.items()}


def shard_opt_state(state, mesh):
    """An AdamW state (``train.optimizer.init``) with its moments placed
    like the parameters of the model they mirror and its step
    replicated, in place."""
    from repro_torch.train.optimizer import AdamWState

    def moments(mod: nn.Module) -> nn.Module:
        # placed already: moments of a placed model (zeros_like keeps the
        # placements), and the empty stand-ins of stacked layers
        todo = [(n, p) for n, p in mod.named_parameters()
                if not shards.is_dtensor(p) and p.numel()]
        specs = model_shardings(mod, mesh)[0] if todo else {}
        for name, p in todo:
            sub, attr = _module_of(mod, name)
            sub._parameters[attr] = nn.Parameter(
                place(p.detach(), specs[name], mesh), requires_grad=False)
        return mod
    step = (state.step if shards.is_dtensor(state.step)
            else place(state.step, (), mesh))
    return AdamWState(step, moments(state.mu), moments(state.nu))
