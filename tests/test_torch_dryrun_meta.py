"""The dry run's recurrences on ``meta``: the step body once, standing for
the T steps (``models.layers.scan_once_on_meta``).

On ``meta`` no value exists, so the dry run records shapes, placements,
the autograd graph and the collectives only.  These tests hold the body-
once path to the stepped one: the plain scans give the same output
shapes, dtypes and strides and a gradient of the same shape to every
input; and a reduced Jamba and xLSTM train step and prefill, placed on
small fake meshes, record the same collectives (count and bytes by
kind), give outputs of the same shapes, dtypes and placements, and
reach the same leaves with gradients of the same shapes and placements
whether the leaves lie on ``meta`` (body once) or on the CPU (stepped).

Each placed run goes in a subprocess: the fake process group is the
process's default group.  ``python tests/test_torch_dryrun_meta.py ARCH
KIND MESH`` prints the two runs' records as JSON.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import layers as L

REPO = Path(__file__).resolve().parent.parent


def _inputs(name, t, dtype):
    """The scan ``name``'s inputs at T ``t``, drawn from seed 0."""
    rng = np.random.default_rng(0)

    def draw(*shape, dt=dtype, scale=1.0):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * scale).to(dt)
    if name == "ssm":
        return (draw(2, t, 8), draw(2, t, 8, scale=0.1).abs(), draw(2, t, 4),
                draw(2, t, 4), -draw(8, 4, dt=torch.float32).abs(),
                draw(8, dt=torch.float32))
    if name == "mlstm":
        return (draw(2, t, 2, 8), draw(2, t, 2, 8), draw(2, t, 2, 8),
                draw(2, t, 2, dt=torch.float32),
                -draw(2, t, 2, dt=torch.float32).abs())
    return draw(2, t, 32), draw(2, 4, 16)


SCANS = {"ssm": ssm_scan_ref, "mlstm": mlstm_scan_ref,
         "slstm": lambda pre_x, r: slstm_scan_ref(pre_x, r, 2)}


def _run(name, args, device):
    """(output, the inputs' gradients) of scan ``name`` on ``device``."""
    ins = [a.detach().to(device).requires_grad_() for a in args]
    y = SCANS[name](*ins)
    y.float().sum().backward()
    return y, [a.grad for a in ins]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SCANS))
def test_plain_scan_on_meta_matches_the_stepped_shapes(name, dtype):
    """T 300 (two full remat chunks of 128 and a rest: the stepped mLSTM
    and sLSTM scans take the unchunked loop; T 256 below takes the
    chunks)."""
    for t in (300, 256):
        args = _inputs(name, t, dtype)
        want, want_g = _run(name, args, "cpu")
        got, got_g = _run(name, args, "meta")
        assert got.is_meta and not want.is_meta
        assert (got.shape, got.dtype, got.stride()) == \
            (want.shape, want.dtype, want.stride())
        assert [(g.shape, g.dtype) for g in got_g] == \
            [(g.shape, g.dtype) for g in want_g]


def test_chunked_remat_scan_on_meta_runs_the_step_once():
    """A tuple-returning step: called once on ``meta`` (no checkpoint,
    under autograd too) and T times on the CPU, with the same carry and
    ``ys`` shapes, every ``ys`` contiguous."""
    calls = []

    def step(carry, x):
        calls.append(x[0].device.type)
        h = carry * 0.5 + x[0] * x[1]
        return h, (h, h.sum(-1))
    for device, want_calls in (("cpu", 12), ("meta", 1)):
        calls.clear()
        xs = tuple(torch.ones(12, 3, 4, device=device, requires_grad=True)
                   for _ in range(2))
        carry, ys = L.chunked_remat_scan(step, torch.zeros(3, 4,
                                                           device=device),
                                         xs, chunk=4)
        assert len(calls) == want_calls and set(calls) == {device}
        assert carry.shape == (3, 4)
        assert [y.shape for y in ys] == [(12, 3, 4), (12, 3)]
        assert all(y.is_contiguous() for y in ys)
        (ys[0].sum() + ys[1].sum()).backward()
        assert [x.grad.shape for x in xs] == [(12, 3, 4)] * 2


def test_scan_once_on_meta_leaves_values_alone():
    assert L.scan_once_on_meta(lambda c, x: (c, x), torch.zeros(2),
                               torch.ones(3, 2)) is None
    carry, ys = L.scan_once_on_meta(lambda c, x: (c + x, c),
                                    torch.zeros(2, device="meta"),
                                    torch.ones(3, 2, device="meta"))
    assert carry.is_meta and ys.shape == (3, 2)


# --------------------------------------------------------------------- #
# placed steps on a fake mesh: meta (body once) against CPU (stepped)
# --------------------------------------------------------------------- #
MESHES = {"2x2": {"data": 2, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}


def _desc(t):
    """(shape, dtype, placements) of a tensor or DTensor, as strings."""
    from repro_torch.models import shards
    pl = str(list(t.placements)) if shards.is_dtensor(t) else None
    return [list(t.shape), str(t.dtype), pl]


def record(arch: str, kind: str, mesh_name: str, device: str) -> dict:
    """One placed step of ``arch`` reduced at 8 x 32 tokens on the fake
    mesh ``mesh_name``, its leaves on ``device`` (``meta`` as the dry run
    places them, or drawn on the CPU): the collectives, the outputs and
    each parameter's gradient as the backward returned it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.analysis import collectives as CO
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as MDL
    from repro_torch.models import transformer as T

    cfg = get_arch(arch).reduced()
    cell = ShapeCell(f"{kind}_t", 32, 8, kind)
    specs = MDL.param_specs, MDL.input_specs
    if device == "cpu":
        def cpu(tree):
            if isinstance(tree, dict):
                return {k: cpu(v) for k, v in tree.items()}
            return torch.zeros(tree.shape, dtype=tree.dtype)
        MDL.param_specs = lambda c: T.init_params(
            c, torch.Generator().manual_seed(0), device="cpu")
        MDL.input_specs = lambda c, s: cpu(specs[1](c, s))
    grads = []
    grad = torch.autograd.grad

    def noted(outputs, inputs, *args, **kwargs):
        gs = grad(outputs, inputs, *args, **kwargs)
        grads.append([None if g is None else _desc(g) for g in gs])
        return gs
    torch.autograd.grad = noted
    shape = MESHES[mesh_name]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape.values()))
    try:
        mesh = make_mesh(shape, device_type="cpu")
        step, leaves = D.build_lowerable(cfg, cell, mesh)
        assert all(t.device.type == device for t in leaves)
        with CO.CollectiveRecord() as rec:
            out = step()
    finally:
        dist.destroy_process_group()
        torch.autograd.grad = grad
        MDL.param_specs, MDL.input_specs = specs
    if kind == "train":
        outs = [_desc(v) for _, v in sorted(out[2].items())]
    else:
        logits, caches = out
        outs = [_desc(logits)] + [_desc(v) for _, v in sorted(caches.items())
                                  if isinstance(v, torch.Tensor)]
    return {"bytes": CO.collective_bytes(rec),
            "counts": CO.collective_count(rec), "outputs": outs,
            "grads": grads}


@pytest.mark.parametrize("arch,kind,mesh_name", [
    (arch, kind, "2x2x2" if kind == "train" else "2x2")
    for arch in ("jamba-1.5-large-398b", "xlstm-125m")
    for kind in ("train", "prefill")])
def test_placed_step_on_meta_records_what_the_stepped_step_does(
        arch, kind, mesh_name):
    """Training on the 3-D mesh (pod, data, model), prefill on (data,
    model); both runs in one subprocess, ``meta`` first."""
    proc = subprocess.run(
        [sys.executable, __file__, arch, kind, mesh_name],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    meta, cpu = json.loads(proc.stdout.strip().splitlines()[-1])
    assert meta["counts"] == cpu["counts"]
    assert meta["bytes"] == cpu["bytes"]
    assert sum(meta["counts"].values()) > 0
    assert meta["outputs"] == cpu["outputs"]
    assert meta["grads"] == cpu["grads"]
    if kind == "train":
        assert meta["grads"] and all(g is not None
                                     for g in meta["grads"][0])


if __name__ == "__main__":
    print(json.dumps([record(*sys.argv[1:4], device)
                      for device in ("meta", "cpu")]))
