"""xLSTM on placed tensors (gloo, 4 ranks): a reduced xlstm-125m in f32
on a (data 2, model 2) mesh by the production rules against the same
model unplaced.  Each recurrence runs on its rank's batch shard
(``models.shards.on_batch_shards``): the loss at rel 1e-5, every gradient
leaf at 1e-4 and the prefill logits at 1e-5 of the unplaced run (the
bars of ``tests/test_torch_distributed.py``), and the collectives of the
placed loss and backward the same at T 16 and T 32 -- none a step (on
DTensors the sLSTM's backward reduce-scattered the carry's gradient
every step).  The ranks run :func:`xlstm_placed`, imported from this
module by each spawned process.
"""

import pytest
import torch

from _dist_workers import _rel, _whole
from repro_torch.analysis import collectives as CO
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import model as MDL
from repro_torch.models import transformer as T

SEQS = (16, 32)


def xlstm_placed(rank, world, seqs):
    """Reduced xlstm-125m in f32, placed on (data 2, model 2) by the
    production rules, against the same model unplaced, at each sequence
    length in ``seqs``: the loss and every gradient leaf (rel err), the
    prefill logits (rel err) and the collectives of the placed loss and
    backward (count by kind).  The recurrences run on each rank's batch
    shard (``shards.on_batch_shards``), so the counts do not grow with
    the sequence."""
    cfg = get_arch("xlstm-125m").reduced()
    mesh = M.make_test_mesh(2, 2, device_type="cpu")

    def model():
        return T.set_trainable(T.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu",
            dtype=torch.float32))
    out = {}
    for s in seqs:
        toks = torch.randint(0, cfg.vocab, (4, s), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(s))
        batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
        ref = model()
        loss0, _ = MDL.loss_fn(ref, cfg, batch)
        g0 = torch.autograd.grad(loss0, list(ref.parameters()))
        placed = SH.shard_model(model(), mesh)
        with SH.implicit_replication():
            with CO.CollectiveRecord() as rec:
                loss, _ = MDL.loss_fn(placed, cfg,
                                      SH.shard_batch(batch, mesh, 4))
                g = torch.autograd.grad(loss, list(placed.parameters()))
            with torch.no_grad():
                lg0 = T.forward_prefill(ref, cfg, toks, T.init_caches(
                    cfg, 4, s, device="cpu"), ssm_impl="ref")[0]
                lg = T.forward_prefill(
                    placed, cfg, SH.shard_batch({"t": toks}, mesh, 4)["t"],
                    SH.shard_caches(cfg, T.init_caches(cfg, 4, s,
                                                       device="cpu"),
                                    mesh, 4), ssm_impl="ref")[0]
        out[s] = {"loss": _rel(_whole(loss.detach()), loss0),
                  "grads": max(_rel(_whole(a), b) for a, b in zip(g, g0)),
                  "logits": _rel(_whole(lg), lg0),
                  "counts": CO.collective_count(rec)}
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    return run_ranks(xlstm_placed, 4, SEQS,
                     work_dir=str(tmp_path_factory.mktemp("xlstm")),
                     timeout_s=240)[0]


@pytest.mark.parametrize("s", SEQS)
def test_placed_xlstm_matches_unplaced(placed, s):
    got = placed[s]
    assert got["loss"] <= 1e-5
    assert got["grads"] <= 1e-4
    assert got["logits"] <= 1e-5


def test_placed_xlstm_makes_no_collective_a_step(placed):
    short, long = (placed[s]["counts"] for s in SEQS)
    assert short == long
    assert sum(short.values()) > 0
