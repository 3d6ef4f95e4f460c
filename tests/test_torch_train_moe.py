"""The port's training gradients for the MoE families held to the JAX
reference on the CPU: reduced jamba-1.5-large-398b with its experts
(Mamba through the stepped scan, MoE every other layer) and reduced
deepseek-v2-236b (MLA, the dense first layer), with and without its int8
dispatch, all in f32 -- ``forward_train``'s logits and aux loss,
``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of the
reference's ``loss_fn`` (``tests/_train_common.py``; loss and aux at rel
1e-5, logits and each leaf at ``rel_err`` <= 1e-4).

The int8 dispatch passes a gradient to its input only through each
token's scale (``max |x| / 127``: the payload is rounded), whose
cotangent the compiled reference sums in bf16; the port sums it as XLA
does (``moe._Dequant``), so every leaf, upstream of an MoE layer or
not, is held at the f32 bar.  The dropping case (capacity factor 0.5)
also carries the gradient of slot ``(0, C-1)``, where the dropped pairs'
scales are folded.  (In bf16 the comparison does not hold: a bf16 ulp
moves a token's ``argmax |x|`` between near-tied entries, and the whole
scale gradient with it.)

Routing is discontinuous, so the runs must route alike: the port records
every MoE layer's routing (``MoEFFN.record``), and its smallest margin
(the gap between a token's k-th and (k+1)-th expert, or group, that a
flip must cross) must be far above the f32 difference of the two
packages' router probabilities -- the routes then equal the
reference's.  (The layer's routes are held EQUAL to the reference's own
``top_k`` in ``tests/test_torch_moe.py``.)
"""

import pytest
import torch

from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

from _train_common import (check_run, configs, make_batch, port_model,
                           port_run, reference_params, torch_batch)

#: a route flips only across a gap the two packages' f32 router
#: probabilities could bridge (their difference is ~1e-7)
MIN_MARGIN = 1e-5


def _routings(tcfg, params, batch):
    """Every MoE layer's :class:`~repro_torch.models.moe.Routing` of the
    port's run."""
    model = port_model(tcfg, params)
    ffns = [m for m in model.modules() if isinstance(m, TT.MoEFFN)]
    for f in ffns:
        f.record = []
    port_run(tcfg, model, batch)
    assert ffns and all(f.record for f in ffns)
    return [r for f in ffns for r in f.record]


@pytest.mark.parametrize("name,over,seed", [
    ("jamba-1.5-large-398b", {}, 20),
    ("deepseek-v2-236b", {"int8_dispatch": False}, 22),
    ("deepseek-v2-236b", {}, 24),
    ("deepseek-v2-236b", {"capacity_factor": 0.5}, 26)],
    ids=["jamba", "deepseek-no-int8", "deepseek-int8",
         "deepseek-int8-drops"])
def test_moe_family_gradients_match_the_reference(name, over, seed):
    jcfg, tcfg = configs(name, **over)
    assert jcfg.n_experts
    params = reference_params(jcfg, seed, "f32")
    batch = make_batch(jcfg, seed + 1, "f32")
    routings = _routings(tcfg, params, batch)
    assert min(float(r.margin.min()) for r in routings) > MIN_MARGIN
    drops = any(not bool(r.keep.all()) for r in routings)
    assert drops == (tcfg.capacity_factor < 1)
    (_, m, _, _, aux), _ = check_run(jcfg, tcfg, params, batch, "f32")
    assert float(aux) > 0 and float(m["aux"]) == float(aux)


def test_replayed_moe_train_step_with_remat_equals_without():
    """``MoEFFN``'s check hooks under ``remat``: the backward recomputes a
    checkpointed repetition, and its MoE layer must take the routes its
    forward replayed, not the replay's next ones, and record once.  Each
    layer replays forced routes (its own choice moved by one expert) and
    then its own choice; the loss and every gradient equal the run
    without remat bit for bit, and the own choice is left unread."""
    jcfg, tcfg = configs("deepseek-v2-236b")
    model = port_model(tcfg, reference_params(jcfg, 28, "f32"))
    batch = torch_batch(make_batch(jcfg, 29, "f32"))
    ffns = [m for m in model.modules() if isinstance(m, TT.MoEFFN)]
    for f in ffns:
        f.record = []
    TM.loss_fn(model, tcfg, batch)
    own = [f.record[0].gate_idx for f in ffns]
    forced = [(r + 1) % tcfg.n_experts for r in own]
    out = []
    for remat in (False, True):
        for f, a, b in zip(ffns, forced, own):
            f.replay, f.record = iter([a, b]), []
        loss, _ = TM.loss_fn(model, tcfg, batch, remat=remat)
        out.append((loss, torch.autograd.grad(loss,
                                              list(model.parameters()))))
        for f, a, b in zip(ffns, forced, own):
            assert len(f.record) == 1
            assert torch.equal(f.record[0].gate_idx, a)
            assert next(f.replay) is b
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
