"""Multi-pod dry run: place and step every (arch x shape x mesh) cell on
256 or 512 placeholder ranks (the port of ``repro.launch.dryrun``).

For each cell the process starts a fake process group of 256 or 512
ranks (``torch.testing``'s ``FakeStore`` and ``"fake"`` backend: this
process is rank 0 and every collective returns at once), builds the
production mesh, places every parameter, optimizer, cache and input
leaf on the ``meta`` device by the sharding rules (``launch.sharding``,
DTensors: nothing is allocated), and runs ONE microbatch of the cell's
step through the plain versions (``attn_impl="ref"``, ``ssm_impl="ref"``,
:func:`cell_attn_impl`; no kernel takes a DTensor) while :class:`~repro_torch.analysis.
collectives.CollectiveRecord` notes the collectives DTensor calls.
Success shows the distribution config is coherent; the JSON holds the
per-rank bytes of the placed leaves (``memory.argument_bytes``), the
collectives of one microbatch scaled by ``n_micro`` (``collectives`` /
``collective_counts``, ``collective_scale``; the reference's compiler
counts a loop body once and its roofline is analytic for the same
reason, and on ``meta`` the recurrences' plain loops run their body once,
``models.layers.scan_once_on_meta``), and the analytic roofline on H100
constants (``analysis.flops`` / ``analysis.roofline``,
:func:`roofline_terms`).

The reference's ``lower_s`` / ``compile_s`` and XLA's ``cost_analysis``
have no counterpart: ``step_s`` is the meta step's seconds in their
place.  The fake backend is a private module of torch; it is imported
here, inside the dry run's process, never at package import.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape train_4k --mesh single --out results/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.analysis import collectives as CO
from repro_torch.analysis import flops as FL
from repro_torch.analysis import roofline as roof
from repro_torch.configs import applicable_cells, get_arch, get_shape
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_production_mesh, mesh_shape
from repro_torch.models import model as MDL
from repro_torch.models import shards
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as OPT


def pick_n_micro(cfg, cell, mesh) -> int:
    """Gradient-accumulation microbatches: keep per-micro local batch >= 1
    while targeting <= ~8k local tokens per microbatch for big models."""
    if cell.kind != "train":
        return 1
    shape = mesh_shape(mesh)
    dp = 1
    for ax in SH.fit_batch_axes(mesh, cell.global_batch,
                                SH.batch_includes_model(cfg)):
        dp *= shape[ax]
    local_b = max(1, cell.global_batch // dp)
    # ~4k local tokens per microbatch for dense archs; ~8k for FSDP/MoE
    # archs (every extra microbatch re-gathers the FSDP'd weights)
    tgt = 8192 if SH._needs_fsdp(cfg) else 4096
    want = -(-local_b * cell.seq_len // tgt)
    return max(1, min(local_b, want))


def _bytes(tensors) -> int:
    """This rank's bytes of the placed tensors."""
    out = 0
    for t in tensors:
        local = t.to_local() if shards.is_dtensor(t) else t
        out += local.numel() * local.element_size()
    return out


def cell_attn_impl(kind: str, attn_impl: str) -> str:
    """The attention a cell's step runs for ``--attn-impl``: with
    ``"ref"`` (plain), training and prefill attend through
    ``attention_qchunk`` (whole-row score blocks, as the reference's
    ``qchunk`` / ``chunked``) and decode through the one-pass
    ``decode_attention_dense`` (the reference's ``xla`` decode) -- the
    tiled plain versions would slice a sequence-sharded cache."""
    if attn_impl != "ref":
        return attn_impl
    return "dense" if kind == "decode" else "qchunk"


def build_lowerable(cfg, cell, mesh, *, attn_impl="ref", ssm_impl="ref",
                    n_micro=None):
    """(step, placed leaves): ``step()`` runs one microbatch of the cell's
    step on the placed ``meta`` leaves."""
    attn_impl = cell_attn_impl(cell.kind, attn_impl)
    specs = MDL.input_specs(cfg, cell)
    model = SH.shard_model(MDL.param_specs(cfg), mesh)
    leaves = list(model.parameters())

    if cell.kind == "train":
        nm = n_micro or pick_n_micro(cfg, cell, mesh)
        bm = cell.global_batch // nm
        batch = {k: v[:bm] for k, v in specs["batch"].items()}
        batch = SH.shard_batch(batch, mesh, bm,
                               SH.batch_includes_model(cfg))
        opt = SH.shard_opt_state(OPT.init(model), mesh)
        leaves += [opt.step] + list(opt.mu.parameters()) + \
            list(opt.nu.parameters()) + list(batch.values())
        step = MDL.make_train_step(cfg, OPT.AdamWConfig(),
                                   attn_impl=attn_impl, ssm_impl=ssm_impl,
                                   n_micro=1, remat=True)
        return (lambda: step(model, opt, batch)), leaves

    b = cell.global_batch
    caches = SH.shard_caches(cfg, specs["caches"], mesh, b)
    leaves += list(caches.values())
    if cell.kind == "prefill":
        tokens = SH.shard_batch({"t": specs["tokens"]}, mesh, b,
                                SH.batch_includes_model(cfg))["t"]
        memory = (SH.shard_batch({"m": specs["memory"]}, mesh, b)["m"]
                  if "memory" in specs else None)
        leaves += [tokens] + ([memory] if memory is not None else [])

        def step():
            with torch.no_grad(), implicit_replication():
                return T.forward_prefill(model, cfg, tokens, caches,
                                         memory=memory, attn_impl=attn_impl,
                                         ssm_impl=ssm_impl)
        return step, leaves

    if cell.kind == "decode":
        ins = SH.shard_batch({"token": specs["token"], "pos": specs["pos"]},
                             mesh, b)
        leaves += list(ins.values())

        def step():
            with torch.no_grad(), implicit_replication():
                return T.forward_decode(model, cfg, ins["token"], caches,
                                        ins["pos"], attn_impl=attn_impl)
        return step, leaves

    raise ValueError(cell.kind)


def roofline_terms(cfg, cell, shp, n_dev: int, n_micro: int,
                   recorded_coll_bytes: float) -> dict:
    """A cell's ``roofline``, ``analytic`` and ``analytic_detail``: the
    analytic terms (as the reference's) on the mesh ``shp`` (``{axis:
    size}``) of ``n_dev`` ranks, with the recorded collective bytes as a
    floor on the collective term (``tools/recompute_roofline`` re-derives
    a JSON's through this)."""
    dp = 1
    for ax in SH.fit_batch_axes(shp, cell.global_batch,
                                SH.batch_includes_model(cfg)):
        dp *= shp[ax]
    dp = max(1, dp)
    tp = shp["model"] if not SH.batch_includes_model(cfg) else 1
    cost_a = FL.cell_cost(cfg, cell, n_dev, dp=dp, tp=tp, n_micro=n_micro,
                          fsdp=SH._needs_fsdp(cfg), append_impl="scatter",
                          param_dp=shp["data"])
    rl = roof.Roofline(flops=cost_a.flops, hbm_bytes=cost_a.hbm_bytes,
                       coll_bytes=max(cost_a.coll_bytes,
                                      recorded_coll_bytes),
                       model_flops=cost_a.model_flops)
    report = rl.report()
    report["residency_gb"] = round(
        cost_a.detail["residency_bytes"] / 1e9, 2)
    report["n_micro"] = n_micro
    report["dp"] = dp
    report["tp"] = tp
    return {"roofline": report,
            "analytic": {"flops": cost_a.flops,
                         "hbm_bytes": cost_a.hbm_bytes,
                         "coll_bytes": cost_a.coll_bytes,
                         "model_flops": cost_a.model_flops},
            "analytic_detail": cost_a.detail}


def run_cell(arch: str, shape: str, mesh_kind: str, *,
             attn_impl="ref", ssm_impl="ref") -> dict:
    """One cell in a fake process group of the production mesh's size
    (started here, and ended before returning)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = get_arch(arch)
    cell = get_shape(shape)
    multi = mesh_kind == "multi"
    n_dev = 512 if multi else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_dev)
    try:
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        result = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                  "devices": dist.get_world_size(),
                  "mesh_shape": mesh_shape(mesh),
                  "attn_impl": cell_attn_impl(cell.kind, attn_impl),
                  "ssm_impl": ssm_impl}
        t0 = time.perf_counter()
        step, leaves = build_lowerable(cfg, cell, mesh, attn_impl=attn_impl,
                                       ssm_impl=ssm_impl)
        result["place_s"] = round(time.perf_counter() - t0, 1)
        result["memory"] = {"argument_bytes": _bytes(leaves)}
        t1 = time.perf_counter()
        with CO.CollectiveRecord() as rec:
            step()
        result["step_s"] = round(time.perf_counter() - t1, 1)
    finally:
        dist.destroy_process_group()

    n_micro = pick_n_micro(cfg, cell, mesh)
    one = CO.collective_bytes(rec)
    result["collectives_one_micro"] = one
    result["collective_scale"] = n_micro
    result["collectives"] = {k: v * n_micro for k, v in one.items()}
    result["collective_counts"] = {
        k: v * n_micro for k, v in CO.collective_count(rec).items()}

    result.update(roofline_terms(cfg, cell, mesh_shape(mesh), n_dev,
                                 n_micro, result["collectives"]["total"]))
    if cfg.n_experts:
        # the MoE dispatch's recorded all-to-all bytes (equal splits sized
        # to what one rank may send another) beside the analytic EP term
        # (every token's k rows, balanced over the data ranks)
        result["ep_all_to_all"] = {
            "recorded_bytes": result["collectives"].get("all-to-all", 0),
            "analytic_bytes": FL.ep_dispatch_bytes(
                cfg, cell, result["roofline"]["dp"])}
    result["ok"] = True
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--attn-impl", default="ref")
    ap.add_argument("--ssm-impl", default="ref")
    ap.add_argument("--out", type=str, default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = list(applicable_cells())
    else:
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        for mesh_kind in meshes:
            name = f"{arch}__{shape}__{mesh_kind}.json"
            path = outdir / name
            if args.skip_existing and path.exists():
                prev = json.loads(path.read_text())
                if prev.get("ok"):
                    print(f"[skip] {name}")
                    continue
            t0 = time.time()
            try:
                res = run_cell(arch, shape, mesh_kind,
                               attn_impl=args.attn_impl,
                               ssm_impl=args.ssm_impl)
                rl = res["roofline"]
                print(f"[ok] {arch} {shape} {mesh_kind}: "
                      f"step={res['step_s']}s "
                      f"bottleneck={rl['bottleneck']} "
                      f"t={max(rl['t_compute_s'], rl['t_memory_s'], rl['t_collective_s']):.4f}s "
                      f"({time.time()-t0:.0f}s)"
                      + (f" all-to-all={ep['recorded_bytes']}B "
                         f"(analytic EP {ep['analytic_bytes']:.4g}B)"
                         if (ep := res.get("ep_all_to_all")) else ""),
                      flush=True)
            except Exception as e:  # noqa: BLE001 -- record and continue
                res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                failures += 1
                print(f"[FAIL] {arch} {shape} {mesh_kind}: "
                      f"{str(e)[:300]}", flush=True)
            path.write_text(json.dumps(res, indent=1, default=str))
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
