"""The port's sharding rules and meta spec functions against the reference's
(``repro.launch.sharding``, ``repro.models.model``).

Every parameter, optimizer, cache and batch leaf of every architecture
gets, from the port's rules over the port's trees in the reference's
layout (``transformer.params_to_tree`` / ``caches_to_tree``), exactly the
``PartitionSpec`` the reference's rules give the same leaf, on the
abstract meshes (16, 16), (2, 16, 16) and (2, 4) -- caches and batches at
each applicable cell's batch; llama4-scout's repetition-sharded leaves
included.  The meta-device spec functions give the reference's
``eval_shape`` trees leaf by leaf in shape and dtype.  The DTensor
realisation on a production mesh runs in a subprocess with a fake
process group of 512 ranks (it sets the process's default group)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import applicable_cells, get_arch as j_get_arch
from repro.configs import get_shape as j_get_shape, list_archs
from repro.launch import sharding as JS
from repro.models import model as JM
from repro_torch.configs import get_arch, get_shape
from repro_torch.launch import sharding as SH
from repro_torch.models import model as MDL
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as OPT

REPO = Path(__file__).resolve().parent.parent
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")))


def ref_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {JS._path_str(p): tuple(s.spec) for p, s in leaves}


def ref_shapes(tree) -> dict:
    return {JS._path_str(p): (tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def our_shapes(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in TT.tree_paths(tree).items()}


def opt_tree(state):
    return OPT.AdamWState(state.step, TT.params_to_tree(state.mu),
                          TT.params_to_tree(state.nu))


def meshes():
    for shape, names in MESHES:
        yield AbstractMesh(shape, names), dict(zip(names, shape))


def port_inputs(cfg, shape: str):
    """The port's input specs with the caches in the reference's layout,
    and its batch-like leaves (everything but the caches)."""
    ins = MDL.input_specs(cfg, get_shape(shape))
    caches = (TT.caches_to_tree(cfg, ins["caches"]) if "caches" in ins
              else None)
    batch = ins.get("batch", {k: v for k, v in ins.items()
                              if k != "caches"})
    return caches, batch


@pytest.mark.parametrize("arch", list_archs())
def test_meta_specs_match_reference_trees(arch):
    jcfg, cfg = j_get_arch(arch), get_arch(arch)
    assert our_shapes(TT.params_to_tree(MDL.param_specs(cfg))) == \
        ref_shapes(JM.param_specs(jcfg))
    assert our_shapes(opt_tree(MDL.opt_state_specs(cfg))) == \
        ref_shapes(JM.opt_state_specs(jcfg))
    assert MDL.param_count(cfg) == JM.param_count(jcfg)


@pytest.mark.parametrize("arch,shape", applicable_cells())
def test_input_specs_match_reference(arch, shape):
    jcfg, cfg = j_get_arch(arch), get_arch(arch)
    want = JM.input_specs(jcfg, j_get_shape(shape))
    ins = MDL.input_specs(cfg, get_shape(shape))
    if "caches" in ins:
        ins = dict(ins, caches=TT.caches_to_tree(cfg, ins["caches"]))
    assert our_shapes(ins) == ref_shapes(want)


@pytest.mark.parametrize("arch", list_archs())
def test_param_and_opt_specs_match_reference(arch):
    jcfg, cfg = j_get_arch(arch), get_arch(arch)
    jp, jo = JM.param_specs(jcfg), JM.opt_state_specs(jcfg)
    pt = TT.params_to_tree(MDL.param_specs(cfg))
    ot = opt_tree(MDL.opt_state_specs(cfg))
    for am, m in meshes():
        assert SH.param_shardings(cfg, m, pt) == \
            ref_specs(JS.param_shardings(jcfg, am, jp)), m
        assert SH.opt_state_shardings(cfg, m, ot) == \
            ref_specs(JS.opt_state_shardings(jcfg, am, jo)), m


@pytest.mark.parametrize("arch,shape", applicable_cells())
def test_cache_and_batch_specs_match_reference(arch, shape):
    jcfg, cfg = j_get_arch(arch), get_arch(arch)
    cell = j_get_shape(shape)
    want = JM.input_specs(jcfg, cell)
    want_batch = want.get("batch", {k: v for k, v in want.items()
                                    if k != "caches"})
    caches, batch = port_inputs(cfg, shape)
    b = cell.global_batch
    for am, m in meshes():
        assert SH.fit_batch_axes(m, b) == JS.fit_batch_axes(am, b)
        assert SH.fit_batch_axes(m, b, True) == \
            JS.fit_batch_axes(am, b, True)
        if caches is not None:
            assert SH.cache_shardings(cfg, m, caches, b) == \
                ref_specs(JS.cache_shardings(jcfg, am, want["caches"], b))
        for with_model in (False, True):
            assert SH.batch_shardings(m, batch, b, with_model) == \
                ref_specs(JS.batch_shardings(am, want_batch, b,
                                             with_model)), (m, with_model)
    assert SH.batch_includes_model(cfg) == JS.batch_includes_model(jcfg)


def test_llama4_shards_the_repetition_dim():
    """The reference's FSDP rule puts ``data`` on the scan-stacked
    repetition dim of 8 of llama4-scout's 15 leaves on both production
    meshes (48 repetitions, |data| 16); the port's specs say the same."""
    cfg = get_arch("llama4-scout-17b-a16e")
    pt = TT.params_to_tree(MDL.param_specs(cfg))
    for m in ({"data": 16, "model": 16},
              {"pod": 2, "data": 16, "model": 16}):
        specs = SH.param_shardings(cfg, m, pt)
        lead = sorted(p for p, s in specs.items()
                      if p.startswith("slots/") and s[0] == "data")
        assert len(specs) == 15 and len(lead) == 8, lead


REALISE = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_arch
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_production_mesh, make_mesh
from repro_torch.models import model as MDL, transformer as TT
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
out = {}
mesh3 = make_production_mesh(multi_pod=True, device_type="cpu")
out["placements"] = [str(p) for p in SH.placements(
    (("pod", "data"), None, "model"), mesh3)]
mesh = make_mesh({"pod": 2, "data": 16, "model": 16}, device_type="cpu")
cfg = get_arch("llama4-scout-17b-a16e")
specs = SH.param_shardings(cfg, mesh, TT.params_to_tree(MDL.param_specs(cfg)))
want = 0
for path, leaf in TT.tree_paths(TT.params_to_tree(MDL.param_specs(cfg))).items():
    n = leaf.numel() * leaf.element_size()
    for e in specs[path]:
        for ax in ((e,) if isinstance(e, str) else (e or ())):
            n //= mesh.size(mesh.mesh_dim_names.index(ax))
    want += n
model = SH.shard_model(MDL.param_specs(cfg), mesh)
local = [p.to_local() if hasattr(p, "to_local") else p
         for p in model.parameters()]     # + layers' empty placeholders
got = sum(t.numel() * t.element_size() for t in local)
stacks = {k: [str(p) for p in h.stack.placements]
          for k, h in model.stacked.items()}
from repro_torch.analysis.collectives import CollectiveRecord
with CollectiveRecord() as rec:
    view = model.blocks[5].mixer["wq"]
out.update(want=want, got=got, stacks=stacks,
           view=[list(view.shape), [str(p) for p in view.placements]],
           view_ops=rec.ops, view_bytes=view.to_local().numel()
           * view.element_size())
print(json.dumps(out))
"""


def test_placements_and_llama4_stacked_realisation():
    """Spec -> DTensor placements on the (2, 16, 16) mesh, and there
    llama4's repetition-sharded leaves placed stacked: this rank's bytes are the
    reference spec's per-rank bytes (every dim divides here), and a
    layer reads its repetition off the stack by one all-reduce of that
    repetition's bytes alone (not a gather of all 48)."""
    proc = subprocess.run(
        [sys.executable, "-c", REALISE], capture_output=True, text=True,
        timeout=600, cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["placements"] == ["S(0)", "S(0)", "S(2)"]
    assert out["got"] == out["want"]
    assert len(out["stacks"]) == 8
    assert all(p[:2] == ["R", "S(0)"] for p in out["stacks"].values())
    assert out["view"] == [[5120, 5120], ["R", "R", "S(1)"]]
    assert out["view_ops"] == [["all-reduce", out["view_bytes"]]]
    assert out["view_bytes"] == 5120 * 5120 // 16 * 2
