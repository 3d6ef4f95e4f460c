"""Rank functions of ``tests/test_torch_distributed.py``: each runs in a
process of a gloo group started by ``repro_torch.launch.mesh.run_ranks``.
This module imports ``repro_torch`` and never JAX: the parent runs the
reference and hands the ranks numpy arrays."""

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.models import model as MDL
from repro_torch.models import shards
from repro_torch.models import transformer as T
from repro_torch.train import grad as G
from repro_torch.train import optimizer as OPT
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import LoopConfig, fit
from repro_torch.train.pipeline import pipeline_apply, pipeline_utilization


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


_whole = shards.whole


def _ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest elementwise |a - b| / |b|: at most 2**-7 where bf16
    ``a`` and ``b`` are at most one rounding apart."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())


def _model(cfg, tree):
    return T.set_trainable(T.params_from_numpy(cfg, tree, device="cpu"))


def loss_and_grads(cfg, tree, batch, mesh):
    """(unsharded loss, sharded loss, max gradient leaf rel err, the
    sharded logits' rel err) of ``MDL.loss_fn``, the sharded run on
    ``mesh`` by the production rules."""
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    model = _model(cfg, tree)
    loss0, _ = MDL.loss_fn(model, cfg, b)
    g0 = torch.autograd.grad(loss0, list(model.parameters()))
    SH.shard_model(model, mesh)
    bs = SH.shard_batch(b, mesh, batch["tokens"].shape[0])
    with SH.implicit_replication():
        loss, _ = MDL.loss_fn(model, cfg, bs)
        g = torch.autograd.grad(loss, list(model.parameters()))
    return (float(loss0), float(_whole(loss.detach())),
            max(_rel(_whole(a), b) for a, b in zip(g, g0)))


def train_step(cfg, tree, batch, mesh):
    """Max rel err of every parameter and moment after one
    ``make_train_step`` step, sharded against unsharded, and the two
    steps' metrics."""
    opt_cfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    step = MDL.make_train_step(cfg, opt_cfg)
    ref, ref_opt, ref_m = step(_model(cfg, tree), OPT.init(
        _model(cfg, tree)), b)
    model = SH.shard_model(_model(cfg, tree), mesh)
    opt = SH.shard_opt_state(OPT.init(_model(cfg, tree)), mesh)
    model, opt, m = step(model, opt, SH.shard_batch(
        b, mesh, batch["tokens"].shape[0]))
    errs = [_rel(_whole(p), q) for p, q in zip(model.parameters(),
                                              ref.parameters())]
    errs += [_rel(_whole(p), q) for mod, rmod in ((opt.mu, ref_opt.mu),
                                                 (opt.nu, ref_opt.nu))
             for p, q in zip(mod.parameters(), rmod.parameters())]
    return max(errs), {k: float(v) for k, v in m.items()}, \
        {k: float(v) for k, v in ref_m.items()}


def decode(cfg, tree, prompt, steps, mesh, impl="ref", cache_dtype=None):
    """Sharded prefill + ``steps`` decode steps (decode attention
    ``impl``; caches in ``cache_dtype``, bf16 as made by default)
    against the same run unsharded.  Returns the max rel err of the
    logits, the max rel err of the caches (gathered) after the last step
    and their largest elementwise rel err (:func:`_ulps`), the sharded
    first decode step from fresh bf16 caches at position 0 (the
    reference test's call), and the placements of those caches."""
    b, s = prompt.shape
    model = T.params_from_numpy(cfg, tree, device="cpu")

    def caches_of(max_seq, dtype):
        return {k: c.to(dtype or c.dtype) for k, c in
                T.init_caches(cfg, b, max_seq, device="cpu").items()}

    def run(model, caches, wrap):
        outs = []
        with SH.implicit_replication():
            lg, caches = T.forward_prefill(model, cfg,
                                           wrap(torch.as_tensor(prompt)),
                                           caches, attn_impl="ref",
                                           ssm_impl="ref")
            outs.append(lg)
            for i in range(steps):
                tok = torch.full((b,), i + 1, dtype=torch.int32)
                pos = torch.full((b,), s + i, dtype=torch.int32)
                lg, caches = T.forward_decode(model, cfg, wrap(tok), caches,
                                              wrap(pos), attn_impl=impl)
                outs.append(lg)
        return [_whole(o) for o in outs], {k: _whole(c)
                                           for k, c in caches.items()}

    def wrap(t):
        return SH.place(t, SH.spec(SH.fit_batch_axes(mesh, b)), mesh)

    with torch.no_grad():
        ref, ref_caches = run(model, caches_of(s + steps, cache_dtype),
                              lambda t: t)
        SH.shard_model(model, mesh)
        got, caches = run(model, SH.shard_caches(
            cfg, caches_of(s + steps, cache_dtype), mesh, b), wrap)
        fresh = SH.shard_caches(cfg, caches_of(16, None), mesh, b)
        with SH.implicit_replication():
            first, _ = T.forward_decode(
                model, cfg, wrap(torch.as_tensor(prompt[:, 0])), fresh,
                wrap(torch.zeros((b,), dtype=torch.int32)), attn_impl=impl)
    return {"logits": max(_rel(g, r) for g, r in zip(got, ref)),
            "caches": max(_rel(caches[k], r) for k, r in ref_caches.items()),
            "cache_ulps": max(_ulps(caches[k], r)
                              for k, r in ref_caches.items()),
            "first": _whole(first).numpy(),
            "placements": {k: [str(pl) for pl in c.placements]
                           for k, c in fresh.items()}}


def hierarchical(shape):
    """``hierarchical_psum`` over (pod, data) = ``shape`` against a flat
    all-reduce of the same per-rank tensors (max rel err), the grad
    sync's mean, and whether a dim 0 that |data| does not divide
    raises."""
    mesh = M.make_mesh(shape, device_type="cpu")
    rank = dist.get_rank()
    x = (torch.arange(128, dtype=torch.float32).reshape(32, 4)
         * (rank + 1) + rank)
    flat = x.clone()
    dist.all_reduce(flat)
    hier = G.hierarchical_psum(x, mesh, in_pod_axis="data",
                               cross_pod_axis="pod")
    mean = G.make_hierarchical_grad_sync(mesh)([x])[0]
    try:
        G.hierarchical_psum(torch.ones(shape["data"] + 1, 4), mesh)
        raised = False
    except ValueError:
        raised = True
    return (float(((hier - flat).abs() / flat.abs()).max()),
            float((mean - flat / dist.get_world_size()).abs().max()),
            raised)


def pipeline(ws, x, n_micro):
    mesh = M.make_mesh({"stage": ws.shape[0]}, device_type="cpu")
    out = pipeline_apply(lambda w, a: torch.tanh(a @ w), torch.as_tensor(ws),
                         torch.as_tensor(x), mesh=mesh, axis="stage",
                         n_micro=n_micro)
    return out.numpy(), pipeline_utilization(n_micro, ws.shape[0])


def checkpoint(cfg, tree, batch, mesh, directory):
    """Bit-for-bit round trips: a state saved unsharded, restored under
    ``mesh`` by ``restore(shardings=)``; then saved sharded and restored
    unsharded; then ``fit`` restarting from the first checkpoint onto
    ``mesh``.  Returns (placed?, equal after the first, equal after the
    second, the step fit restored, its steps, all finite?)."""
    opt_cfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = MDL.make_train_step(cfg, opt_cfg)
    model, opt, _ = step(_model(cfg, tree), OPT.init(_model(cfg, tree)),
                         {k: torch.as_tensor(v) for k, v in batch.items()})
    want = [p.detach().clone() for p in model.parameters()] + \
        [p.detach().clone() for p in opt.mu.parameters()] + \
        [p.detach().clone() for p in opt.nu.parameters()]

    def state_of(model, opt):
        return [_whole(p.detach()) for p in model.parameters()] + \
            [_whole(p.detach()) for p in opt.mu.parameters()] + \
            [_whole(p.detach()) for p in opt.nu.parameters()]

    def same(got):
        return all(torch.equal(a, b) for a, b in zip(got, want))

    a = CheckpointManager(f"{directory}/a", async_save=True)
    a.save(1, {"params": model, "opt": opt}, meta={"step": 1})
    fresh = T.init_params(cfg, torch.Generator().manual_seed(1),
                          device="cpu", dtype=torch.float32)
    state, _ = a.restore({"params": fresh, "opt": OPT.init(fresh)},
                         shardings=mesh)
    placed = shards.is_dtensor(next(state["params"].parameters()))
    first = same(state_of(state["params"], state["opt"]))
    b = CheckpointManager(f"{directory}/b", async_save=True)
    b.save(2, state)
    plain = T.init_params(cfg, torch.Generator().manual_seed(2),
                          device="cpu", dtype=torch.float32)
    back, _ = b.restore({"params": plain, "opt": OPT.init(plain)})
    # the loop's elastic restart: restore step 1 onto the mesh, go on
    data = SyntheticLM(vocab=cfg.vocab, batch=batch["tokens"].shape[0],
                       seq=batch["tokens"].shape[1], seed=0)
    start = T.init_params(cfg, torch.Generator().manual_seed(3),
                          device="cpu", dtype=torch.float32)
    res = fit(step, start, OPT.init(start), data, a,
              LoopConfig(total_steps=3, ckpt_every=100),
              param_shardings=mesh, opt_shardings=mesh)
    return (placed, first, same(state_of(back["params"], back["opt"])),
            res.restored_from, len(res.losses),
            all(map(math.isfinite, res.losses)))


def four_ranks(rank, world, cfg_name, tree, batch, prompt, ws, x, ckpt_dir,
               narrow_tree):
    """Every 4-rank check, on one group (spawning costs more than the
    checks): results from rank 0.  ``narrow_tree`` holds the parameters
    of the config with 2 KV heads, whose caches the (1, 4) mesh shards
    on the sequence (2 % 4 != 0)."""
    cfg = get_arch(cfg_name).reduced()
    mesh = M.make_test_mesh(2, 2, device_type="cpu")
    out = {
        "loss": loss_and_grads(cfg, tree, batch, mesh),
        "train_step": train_step(cfg, tree, batch, mesh),
        "decode": decode(cfg, tree, prompt, 3, mesh),
        "decode_seq": decode(dataclasses.replace(cfg, n_kv_heads=2),
                             narrow_tree, prompt, 3,
                             M.make_test_mesh(1, 4, device_type="cpu"),
                             impl="dense", cache_dtype=torch.float32),
        "hier": hierarchical({"pod": 2, "data": 2}),
        "pipeline": pipeline(ws, x, n_micro=4),
        "checkpoint": checkpoint(cfg, tree, batch, mesh, ckpt_dir),
    }
    return out if rank == 0 else None


def eight_ranks(rank, world):
    """A (2, 2, 2) mesh and its data-parallel axes; the hierarchical
    all-reduce over (pod 2, data 4)."""
    mesh = M.make_mesh({"pod": 2, "data": 2, "model": 2}, device_type="cpu")
    return (M.mesh_shape(mesh), M.dp_axes(mesh),
            hierarchical({"pod": 2, "data": 4}))

