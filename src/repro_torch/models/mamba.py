"""Mamba-1 (S6) selective-SSM block, Jamba's sequence mixer (the port of
``repro.models.mamba``).

Block: in_proj -> (x, z); causal depthwise conv + SiLU on x; the
data-dependent (dt, B, C) projections; the diagonal selective scan (the
``ssm_scan`` kernel on CUDA tensors, its plain version on CPU tensors);
gate by SiLU(z); out_proj.

Rounding follows the reference step by step: the projections and the
split run in the activation dtype, the conv accumulates in f32 and is
cast back before SiLU, ``dt_bias`` is cast to the activation dtype
before the add, SiLU's sigmoid and softplus round op by op in that dtype
as XLA lowers them, the scan runs in f32 and returns the activation
dtype, and the gate is taken in that dtype.  Decode follows the
reference's compiled step, which keeps two products in f32 (see
:func:`mamba_decode`).

Serving state per layer: the conv tail ``(B, K-1, d_inner)`` in bf16 and
the SSM state ``(B, d_inner, N)`` in f32.  :func:`mamba_decode` updates
both IN PLACE (the reference returns new arrays).

On placed tensors (``launch.sharding``: batch over the data axes, d_inner
over ``model``) the block is local along batch and channels but for its
projections, so the same code runs its conv, scan or decode step, dt's
softplus and gate as regions on each rank's shards under ``local_map``
(:class:`_Local`; unplaced, :func:`_whole` runs them as they are) --
DTensor would step ~10 dispatches a step and turn the plain scan's slice
writes into writes to gathered copies -- and the decode step's writes
land in each rank's shard of the cache; the projections are DTensor
matmuls (the row-parallel x and out projections summed in f32,
``shards.row_parallel``).  The kernel takes no DTensor
(``kernels/_build.refuse_dtensor``): placed, the scan runs its plain version.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import layers as L
from repro_torch.models import shards


def mamba_init(generator, d_model: int, *, expand: int = 2,
               state: int = 16, conv: int = 4, device,
               dtype: torch.dtype = torch.bfloat16
               ) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    d_inner = expand * d_model
    dt_rank = max(1, math.ceil(d_model / 16))

    def dense(d_in, d_out):
        return L.dense_init(generator, d_in, d_out, device=device,
                            dtype=dtype)
    a = torch.arange(1, state + 1, dtype=torch.float32,
                     device=device).repeat(d_inner, 1)
    return {
        "in_proj": dense(d_model, 2 * d_inner),
        "conv_w": L.dense_init(generator, conv, d_inner, device=device,
                               dtype=dtype, scale=0.1),
        "x_proj": dense(d_inner, dt_rank + 2 * state),
        "dt_proj": dense(dt_rank, d_inner),
        "dt_bias": torch.zeros(d_inner, dtype=torch.float32, device=device),
        "a_log": torch.log(a),                       # (d_inner, N) f32
        "d_skip": torch.ones(d_inner, dtype=torch.float32, device=device),
        "out_proj": dense(d_inner, d_model),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``jnp.logaddexp(x, 0)``: ``max(x, 0)
    + log1p(exp(-|x|))`` with no threshold
    (``torch.nn.functional.softplus`` returns ``x`` itself above
    ``threshold=20``), each op rounded to x's dtype as in the reference
    (``torch.logaddexp`` rounds once, which in bf16 lands an ulp away
    from the reference on some inputs)."""
    return (torch.clamp(x, min=0)
            + torch.log1p(torch.exp(-torch.abs(x))))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x ``(B, S, C)``, w ``(K, C)``: K explicit
    taps accumulated in f32, then cast to x's dtype.  (Not ``conv1d``: a
    float32 convolution goes through cuDNN in TF32 by default.)"""
    k, s = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].float() * w[i].float()
    return out.to(x.dtype)


class _Local:
    """``local_map`` for the Mamba block's channel-local regions on a mesh:
    ``batch`` the mesh dims that split the batch, ``chan`` those that
    split d_inner (the in-projection's columns).  An argument's dims are
    ``(batch dim, channel dim)``, either None where it has none; its
    placement shards those dims over those mesh dims (inputs placed
    otherwise are redistributed), and its gradient is a partial sum over
    the mesh dims it is whole on but the region is split (a weight over
    the batch shards, b and c over the channel shards)."""

    def __init__(self, mesh, batch, chan):
        self.mesh, self.batch, self.chan = mesh, batch, chan

    def placements(self, dims, grad=False):
        bd, cd = dims
        out = []
        for i in range(self.mesh.ndim):
            if i in self.batch:
                out.append(Shard(bd) if bd is not None
                           else Partial() if grad else Replicate())
            elif i in self.chan:
                out.append(Shard(cd) if cd is not None
                           else Partial() if grad else Replicate())
            else:
                out.append(Replicate())
        return out

    def __call__(self, fn, args, dims, out_dims, in_place=()):
        """``fn(*args)`` on each rank's shards; ``in_place``: the indices
        of arguments ``fn`` writes, which must be placed as the region
        splits them already (a redistributed copy would take the write)."""
        for i in in_place:
            if list(args[i].placements) != self.placements(dims[i]):
                raise ValueError(f"mamba: a state placed "
                                 f"{args[i].placements} is written on "
                                 f"shards placed {self.placements(dims[i])}")
        out_pl = (self.placements(out_dims) if isinstance(out_dims[0], int)
                  or out_dims[0] is None
                  else tuple(self.placements(d) for d in out_dims))
        return local_map(
            fn, out_placements=out_pl,
            in_placements=tuple(self.placements(d) for d in dims),
            in_grad_placements=tuple(self.placements(d, grad=True)
                                     for d in dims),
            device_mesh=self.mesh, redistribute_inputs=True)(
            *(shards._placed(a, self.mesh) for a in args))


def _whole(fn, args, dims, out_dims, in_place=()):
    """The region of an unplaced block: ``fn`` on the whole tensors."""
    return fn(*args)


def _parts(p, x, state=None):
    """(the block's region -- :func:`_whole`, or a :class:`_Local` on a
    placed x --, x @ in_proj, d_inner).  Placed, x's pending sums are
    summed and the projection's channels gathered whole on every rank
    (the x and z halves do not follow the columns' shards; GSPMD
    reshards there too); the region splits the channels where the
    in-projection's columns are, and the batch where ``state`` (a cache
    the region writes) splits it, else where x does."""
    if not shards.is_dtensor(x):
        return _whole, x @ p["in_proj"], p["in_proj"].shape[1] // 2
    x = shards.reduced(x)
    mesh = x.device_mesh
    w = shards._placed(p["in_proj"], mesh)
    chan = [i for i, q in enumerate(w.placements) if q.is_shard(1)]
    region = _Local(mesh, [i for i, q in enumerate(
        (state if state is not None else x).placements)
        if q.is_shard(0) and i not in chan], chan)
    return region, shards.whole_dim(x @ w, x.dim() - 1), w.shape[1] // 2


def _dt_b_c(p, xc: torch.Tensor, state: int):
    """dt's linear part and b, c: column views of the ``x_proj`` output
    (row stride ``dt_rank + 2 * state``; on a mesh the x-projection is
    row-parallel, its partial sums summed in f32)."""
    dt_rank = p["dt_proj"].shape[0]
    xdbc = shards.row_parallel(xc, p["x_proj"])
    return (xdbc[..., :dt_rank] @ p["dt_proj"],
            xdbc[..., dt_rank:dt_rank + state], xdbc[..., dt_rank + state:])


def _dt(dt_lin: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    return softplus(dt_lin + dt_bias.to(dt_lin.dtype))


def _conv_silu(xc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return L.silu(_causal_conv(xc, w))


def _conv_step(tail, xc, w):
    """A decode step's conv: the window is the cached ``tail`` followed by
    this token's pre-conv ``xc``, the new tail (the window without its
    first row, in the tail's dtype) is written into ``tail``; returns
    (SiLU of the conv in xc's dtype, the same before its rounding -- its
    last product kept in f32 for the scan's skip term, see
    ``ssm_ops.single_step``)."""
    # cat promotes the bf16 tail to x's dtype, as jnp.concatenate does
    window = torch.cat([tail, xc[:, None]], dim=1)
    xs = (window.float() * w.float()[None]).sum(dim=1).to(xc.dtype)
    x_f32 = xs.float() * L.sigmoid(xs).float()
    tail.copy_(window[:, 1:])
    return x_f32.to(xc.dtype), x_f32


def mamba_forward(p, x: torch.Tensor, *, state: int = 16,
                  impl: str = "kernel") -> torch.Tensor:
    """Prefill: x ``(B, S, d)`` -> ``(B, S, d)``, one selective scan."""
    if shards.is_dtensor(x) and impl == "kernel" and x.is_cuda:
        _build.refuse_dtensor("ssm_scan", x)
    region, xz, d_inner = _parts(p, x)
    xc = region(_conv_silu, (xz[..., :d_inner], p["conv_w"]),
                [(0, 2), (None, 1)], (0, 2))               # (B, S, d_inner)
    dt_lin, b, c = _dt_b_c(p, xc, state)

    def scan(xc, dt_lin, dt_bias, b, c, a_log, d, z):
        y = ssm_ops.ssm_scan(xc, _dt(dt_lin, dt_bias), b, c,
                             -torch.exp(a_log), d, impl=impl)
        return y * L.silu(z)
    y = region(scan, (xc, dt_lin, p["dt_bias"], b, c, p["a_log"],
                      p["d_skip"], xz[..., d_inner:]),
               [(0, 2), (0, 2), (None, 0), (0, None), (0, None), (None, 0),
                (None, 0), (0, 2)], (0, 2))
    return shards.row_parallel(y, p["out_proj"])


def init_mamba_cache(batch: int, d_model: int, *, expand: int = 2,
                     state: int = 16, conv: int = 4, device,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    d_inner = expand * d_model
    return {"conv": torch.zeros((batch, conv - 1, d_inner), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, d_inner, state),
                               dtype=torch.float32, device=device)}


def mamba_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], *,
                 state: int = 16
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: x ``(B, d)`` -> ``(B, d)``.  The new conv tail and SSM
    state are written into ``cache`` in place (:func:`_conv_step`,
    ``ssm_ops.single_step``; on a placed cache each rank's shard), and
    ``cache`` is returned."""
    region, xz, d_inner = _parts(p, x, cache["ssm"])
    xc, x_f32 = region(_conv_step, (cache["conv"], xz[:, :d_inner],
                                    p["conv_w"]),
                       [(0, 2), (0, 1), (None, 1)], [(0, 1), (0, 1)],
                       in_place=(0,))
    dt_lin, b, c = _dt_b_c(p, xc, state)

    def step(h, xc, dt_lin, dt_bias, b, c, a_log, d, x_f32, z):
        y = ssm_ops.single_step(h, xc, _dt(dt_lin, dt_bias), b, c,
                                -torch.exp(a_log), d, x_f32=x_f32)[1]
        return y * L.silu(z)
    y = region(step, (cache["ssm"], xc, dt_lin, p["dt_bias"], b, c,
                      p["a_log"], p["d_skip"], x_f32, xz[:, d_inner:]),
               [(0, 1), (0, 1), (0, 1), (None, 0), (0, None), (0, None),
                (None, 0), (None, 0), (0, 1), (0, 1)], (0, 1), in_place=(0,))
    return shards.row_parallel(y, p["out_proj"]), cache
