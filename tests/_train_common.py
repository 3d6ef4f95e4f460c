"""Shared helpers of the training tests (``tests/test_torch_train*.py``):
reduced configs of both packages, the reference's parameters and a
seeded batch, the compiled reference's loss, gradients, logits and aux
loss, and the port's, with the gradients in the reference's tree; and
:func:`check_run`, which holds one to the other at the stated
tolerances."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

F32_TOL = 1e-4
BF16_TOL = 5e-2
B, S, M = 2, 16, 12


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def configs(name: str, **over):
    jcfg = dataclasses.replace(j_get_arch(name).reduced(), **over)
    tcfg = dataclasses.replace(get_arch(name).reduced(), **over)
    return jcfg, tcfg


def reference_params(jcfg, seed: int, dtype: str):
    p = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    if dtype == "f32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    return p


def make_batch(cfg, seed: int, dtype: str):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if "cross" in cfg.pattern:
        batch["memory"] = (0.1 * rng.standard_normal((B, M, cfg.d_model))
                           ).astype(np.float32)
    return batch


def reference_run(jcfg, params, batch, remat=False):
    """(loss, metrics, grads, logits, aux) of the compiled reference."""
    def fn(p, b):
        (loss, m), g = jax.value_and_grad(JM.loss_fn, has_aux=True)(
            p, jcfg, b, "qchunk", "ref", remat)
        logits, aux = JT.forward_train(p, jcfg, b["tokens"],
                                       memory=b.get("memory"),
                                       attn_impl="qchunk", ssm_impl="ref")
        return loss, m, g, logits, aux
    out = jax.jit(fn)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, out)


def port_model(tcfg, params):
    model = TT.params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return TT.set_trainable(model)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_run(tcfg, model, batch, remat=False):
    """(loss, metrics, grads in the reference's tree, logits, aux)."""
    tb = torch_batch(batch)
    logits, aux = TT.forward_train(model, tcfg, tb["tokens"],
                                   memory=tb.get("memory"))
    loss, m = TM.loss_fn(model, tcfg, tb, remat=remat)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    tree = TT.params_to_numpy(TT.like(model, grads),
                              bf16_dtype=jnp.bfloat16)
    return (loss.detach(), {k: v.detach() for k, v in m.items()}, tree,
            logits.detach(), aux.detach())


def check_run(jcfg, tcfg, params, batch, dtype):
    """Hold the port's run to the reference's: logits and gradient leaves
    at ``rel_err`` <= 1e-4 in f32, 5e-2 in bf16; loss, nll and aux at
    rel 1e-5 in f32."""
    want = reference_run(jcfg, params, batch)
    got = port_run(tcfg, port_model(tcfg, params), batch)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    scalar_tol = 1e-5 if dtype == "f32" else BF16_TOL
    loss, m, grads, logits, aux = got
    w_loss, w_m, w_grads, w_logits, w_aux = want
    v = jcfg.vocab
    assert logits.dtype == torch.float32
    assert logits.shape == w_logits.shape
    assert rel_err(logits.numpy()[..., :v], w_logits[..., :v]) <= tol
    assert abs(float(aux) - float(w_aux)) <= scalar_tol * max(
        1.0, abs(float(w_aux)))
    assert abs(float(loss) - float(w_loss)) <= scalar_tol * abs(float(w_loss))
    assert abs(float(m["nll"]) - float(w_m["nll"])) <= scalar_tol * abs(
        float(w_m["nll"]))
    errs = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        rel_err, grads, jax.tree.map(np.asarray, w_grads)))[0]
    worst = max(errs, key=lambda kv: kv[1])
    assert worst[1] <= tol, (jax.tree_util.keystr(worst[0]), worst[1])
    return got, want
