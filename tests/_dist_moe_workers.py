"""Rank functions of ``tests/test_torch_distributed_moe.py``: each runs in
a process of a gloo group started by ``repro_torch.launch.mesh.run_ranks``.
This module imports ``repro_torch`` and never JAX: the parent runs the
reference and hands the ranks numpy arrays."""

import dataclasses

import torch

import _dist_workers as W
from repro_torch.analysis import collectives as CO
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as M
from repro_torch.launch import serve
from repro_torch.launch import sharding as SH
from repro_torch.models import model as MDL
from repro_torch.models import moe as MOE
from repro_torch.models import shards
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as OPT


def placed_params(p, cfg, mesh):
    """The layer's parameters (torch) placed by the production rules, at
    the paths an MoE layer's leaves have in the reference's tree."""
    def place(v, path):
        return SH.place(v, SH._param_spec(path, v.dim(), cfg, mesh), mesh)
    out = {n: place(v, f"first/ffn/{n}") for n, v in p.items()
           if n != "shared"}
    if "shared" in p:
        out["shared"] = {n: place(v, f"first/ffn/shared/{n}")
                         for n, v in p["shared"].items()}
    return out


def moe_layer(cfg_name, dims, p, x, mesh):
    """One placed MoE call on ``x`` (T, d) split over ``data``: its routes,
    kept mask, positions and margin gathered, its output, aux loss, and the
    collectives it called with their mesh axes."""
    cfg = get_arch(cfg_name).reduced()
    pp = placed_params({k: (torch.from_numpy(v) if not isinstance(v, dict)
                            else {n: torch.from_numpy(w)
                                  for n, w in v.items()})
                        for k, v in p.items()}, cfg, mesh)
    xs = SH.place(torch.from_numpy(x), SH.spec(SH.fit_batch_axes(
        mesh, x.shape[0])), mesh)
    axis = {mesh.get_group(i).group_name: n
            for i, n in enumerate(mesh.mesh_dim_names)}
    with CO.CollectiveRecord() as rec, SH.implicit_replication():
        out, r = MOE.moe_forward(pp, xs, dims)
    # the largest expert stack shard this rank holds
    stack = min(w.to_local().numel() * w.to_local().element_size()
                for n, w in pp.items() if n in ("w_gate", "w_up", "w_down"))
    return {"out": shards.whole(out).numpy(),
            "gate_idx": shards.whole(r.gate_idx).numpy(),
            "keep": shards.whole(r.keep).numpy(),
            "pos": shards.whole(r.pos).numpy(),
            "aux": float(r.aux),
            "placements": [str(pl) for pl in out.placements],
            "collectives": [(cat, b, axis.get(g)) for (cat, b), g in
                            zip(rec.ops, rec.groups)],
            "stack_bytes": stack}


def _step(cfg, tree, batch, mesh, eps: float):
    """One ``make_train_step`` step sharded and unsharded (AdamW with
    ``eps``): the worst rel err of the parameters and of the moments
    after it, and both steps' metrics."""
    opt_cfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                              eps=eps)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    step = MDL.make_train_step(cfg, opt_cfg)
    ref, ref_opt, ref_m = step(W._model(cfg, tree),
                               OPT.init(W._model(cfg, tree)), b)
    model = SH.shard_model(W._model(cfg, tree), mesh)
    opt = SH.shard_opt_state(OPT.init(W._model(cfg, tree)), mesh)
    model, opt, m = step(model, opt, SH.shard_batch(
        b, mesh, b["tokens"].shape[0]))
    params = max(W._rel(W._whole(p), q)
                 for p, q in zip(model.parameters(), ref.parameters()))
    moments = max(W._rel(W._whole(p), q)
                  for mod, rmod in ((opt.mu, ref_opt.mu),
                                    (opt.nu, ref_opt.nu))
                  for p, q in zip(mod.parameters(), rmod.parameters()))
    return (params, moments, {k: float(v) for k, v in m.items()},
            {k: float(v) for k, v in ref_m.items()})


def train_step(cfg, tree, batch, mesh):
    """The placed train step against the unplaced one: the unplaced
    forward's smallest routing margin and dropped pairs, whether the
    placed forward routes, keeps and positions every pair alike, the
    losses and the worst gradient leaf, and one step (:func:`_step`,
    AdamW's eps 1e-3)."""
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    model = W._model(cfg, tree)
    ffns = [m for m in model.modules() if isinstance(m, T.MoEFFN)]
    for f in ffns:
        f.record = []
    loss0, _ = MDL.loss_fn(model, cfg, b)
    g0 = torch.autograd.grad(loss0, list(model.parameters()))
    want = [r for f in ffns for r in f.record]
    SH.shard_model(model, mesh)
    for f in ffns:
        f.record = []
    with SH.implicit_replication():
        loss, _ = MDL.loss_fn(model, cfg, SH.shard_batch(
            b, mesh, b["tokens"].shape[0]))
        g = torch.autograd.grad(loss, list(model.parameters()))
    got = [r for f in ffns for r in f.record]
    same = len(got) == len(want) and all(
        torch.equal(shards.whole(getattr(x, k)), getattr(y, k))
        for x, y in zip(got, want) for k in ("gate_idx", "keep", "pos"))
    params, moments, metrics, ref_metrics = _step(cfg, tree, batch, mesh,
                                                  1e-3)
    return {"margin": min(float(r.margin.min()) for r in want),
            "drops": sum(int((~r.keep).sum()) for r in want),
            "routes_equal": same,
            "loss": (float(loss0), float(shards.whole(loss.detach()))),
            "grads": max(W._rel(W._whole(a), c) for a, c in zip(g, g0)),
            "moments": moments, "params": params, "metrics": metrics,
            "ref_metrics": ref_metrics}


def placed_build(mesh):
    """``serve.build(..., mesh=)`` (each layer placed as drawn) against
    ``sharding.shard_model`` of the whole build: the same names, placements
    and local shards, bit for bit."""
    cfg = get_arch("jamba-1.5-large-398b").reduced()

    def build(**kw):
        return serve.build(cfg, seed=0, device="cpu", dtype=torch.float32,
                           **kw)
    a = dict(build(mesh=mesh).named_parameters())
    b = dict(SH.shard_model(build(), mesh).named_parameters())
    return {"names": list(a) == list(b), "n": len(a),
            "placed": all(shards.is_dtensor(p) for p in a.values()),
            "equal": all(a[n].placements == b[n].placements
                         and torch.equal(a[n].to_local(), b[n].to_local())
                         for n in a)}


def stacked_step(batch, mesh):
    """Reduced llama4-scout with FSDP forced on (threshold 0): on |data| 2
    its two repetitions' FSDP'd leaves are placed stacked
    (``sharding.StackedParams``, each layer reading its repetition off the
    stack), as the full model's are on the production meshes.  One train
    step with remat, placed against unplaced: the metrics and every
    parameter after it (AdamW's eps 1e-3, as :func:`_step`)."""
    cfg = get_arch("llama4-scout-17b-a16e").reduced()
    opt_cfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                              eps=1e-3)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    step = MDL.make_train_step(cfg, opt_cfg, remat=True)

    def fresh():
        return T.set_trainable(serve.build(cfg, seed=0, device="cpu",
                                           dtype=torch.float32))
    ref, _, ref_m = step(fresh(), OPT.init(fresh()), b)
    threshold = SH.FSDP_PARAM_THRESHOLD
    SH.FSDP_PARAM_THRESHOLD = 0
    try:
        model = T.set_trainable(SH.shard_model(fresh(), mesh))
        opt = SH.shard_opt_state(OPT.init(model), mesh)
    finally:
        SH.FSDP_PARAM_THRESHOLD = threshold
    model, _, m = step(model, opt, SH.shard_batch(b, mesh,
                                                  b["tokens"].shape[0]))
    errs = []
    with torch.no_grad():
        for name, q in ref.named_parameters():
            mod, attr = SH._module_of(model, name)
            errs.append(W._rel(W._whole(getattr(mod, attr)), q))
    return {"stacked": hasattr(model, "stacked"), "params": max(errs),
            "metrics": {k: float(v) for k, v in m.items()},
            "ref_metrics": {k: float(v) for k, v in ref_m.items()}}


def row_parallel_bf16(mesh):
    """``shards.row_parallel`` in bf16 over ``model`` (2 ranks), on local
    shards and on DTensors, against one process's f32 product of the same
    bf16 inputs rounded once: the share of outputs that differ, and the
    largest difference over the largest output; beside them, the same
    for bf16 partials each rounded and then summed (the product it
    replaces)."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(3, 16, 512, generator=g).bfloat16()
    w = torch.randn(3, 512, 64, generator=g).bfloat16()
    want = torch.bmm(a.float(), w.float())
    m, half = mesh.get_local_rank(1), a.shape[-1] // mesh.size(1)
    cut = slice(m * half, (m + 1) * half)
    groups = [mesh.get_group(1)]
    got = {"local": shards.row_parallel(a[..., cut], w[:, cut], groups),
           "placed": shards.whole(shards.row_parallel(
               SH.place(a[0], SH.spec(None, "model"), mesh),
               SH.place(w[0], SH.spec("model", None), mesh)))[None],
           "bf16_partials": shards.summed(torch.bmm(a[..., cut], w[:, cut]),
                                          groups)}
    out = {}
    for k, v in got.items():
        ref = want[:v.shape[0]]
        out[k] = (float((v != ref.bfloat16()).float().mean()),
                  float((v.float() - ref).abs().max() / ref.abs().max()))
    return out


def four_ranks(rank, world, layer_cases, train_cases, jamba_tree, prompt):
    """Every check on one (data 2, model 2) group: the layer cases, one
    placed call's collectives, the train steps, jamba's decode, the
    placed build and a train step through stacked leaves."""
    mesh = M.make_test_mesh(2, 2, device_type="cpu")
    out = {"layer": {name: moe_layer(cfg_name, MOE.MoEDims(**dims), p, x,
                                     mesh)
                     for name, (cfg_name, dims, p, x) in layer_cases.items()},
           "train": {name: train_step(dataclasses.replace(
               get_arch(cfg_name).reduced(), **over), tree, batch, mesh)
                     for name, (cfg_name, over, tree, batch) in
                     train_cases.items()},
           "decode": W.decode(get_arch("jamba-1.5-large-398b").reduced(),
                              jamba_tree, prompt, 3, mesh,
                              cache_dtype=torch.float32),
           "build": placed_build(mesh),
           "stacked": stacked_step(train_cases["jamba"][3], mesh),
           "row_parallel": row_parallel_bf16(mesh)}
    return out if rank == 0 else None


def placed_row_products(rank, world, cfg_name, seed, prompt):
    """A reduced ``cfg_name`` in bf16 placed on (data 2, model 2) by the
    production rules, prefilled on ``prompt`` and stepped once, with every
    ``shards.row_parallel`` call recorded.  For each call whose ``a`` is
    split along its last dim, this rank's output rows against the same
    rows computed here from the gathered operands: each ``model`` rank's
    half of the contraction as one f32 product, the two summed in f32 and
    rounded to bf16 once.  Returns, a call, the weight's name, the split,
    whether the rows are equal bit for bit, and the share of them that
    bf16 partials (each rounded, then summed in bf16) would change."""
    from torch.distributed.tensor import Replicate

    mesh = M.make_test_mesh(2, 2, device_type="cpu")
    cfg = get_arch(cfg_name).reduced()
    model = serve.build(cfg, seed=seed, device="cpu")
    names = {id(p): n for n, p in model.named_parameters()}
    SH.shard_model(model, mesh)
    names.update({id(p): n for n, p in model.named_parameters()})
    calls, inner = [], shards.row_parallel

    def recorded(a, w, groups=()):
        out = inner(a, w, groups)
        calls.append((a, w, out))
        return out
    b, s = prompt.shape
    caches = SH.shard_caches(cfg, T.init_caches(cfg, b, s + 1,
                                                device="cpu"), mesh, b)

    def wrap(t):
        return SH.place(t, SH.spec(SH.fit_batch_axes(mesh, b)), mesh)
    shards.row_parallel = recorded
    try:
        with torch.no_grad(), SH.implicit_replication():
            T.forward_prefill(model, cfg, wrap(torch.as_tensor(prompt)),
                              caches, attn_impl="ref", ssm_impl="ref")
            T.forward_decode(model, cfg, wrap(torch.full((b,), 1,
                                                         dtype=torch.int32)),
                             caches, wrap(torch.full((b,), s,
                                                     dtype=torch.int32)),
                             attn_impl="ref")
    finally:
        shards.row_parallel = inner
    out = []
    m = mesh.get_local_rank(1)
    for a, w, y in calls:
        last = a.dim() - 1
        split = [i for i, p in enumerate(a.placements)
                 if p.is_shard() and p.dim in (-1, last)]
        rows = [Replicate() if i in split else p
                for i, p in enumerate(a.placements)]
        a_rows = a.redistribute(mesh, rows).to_local()
        y_rows = y.redistribute(mesh, rows).to_local()
        w_all = shards.whole(w)
        k = a_rows.shape[-1] // 2
        halves = [a_rows[..., i * k:(i + 1) * k].float()
                  @ w_all[i * k:(i + 1) * k].float() for i in (0, 1)]
        want = (halves[0] + halves[1]).to(torch.bfloat16)
        bf16 = (halves[0].to(torch.bfloat16)
                + halves[1].to(torch.bfloat16))
        out.append({"weight": names.get(id(w), "?"),
                    "split": [mesh.mesh_dim_names[i] for i in split],
                    "model_rank": m,
                    "equal": bool(torch.equal(y_rows, want)),
                    "dtype": str(y_rows.dtype),
                    "bf16_partials_differ": float(
                        (bf16 != want).float().mean())})
    return out
