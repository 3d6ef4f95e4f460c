"""The port's training forward and gradients held to the JAX reference on
the CPU: ``forward_train``'s logits and aux loss, ``loss_fn`` and every
gradient leaf against ``jax.value_and_grad`` of the reference's
``loss_fn`` (``attn_impl="qchunk"``, ``ssm_impl="ref"``), for reduced
granite-3-8b (dense GQA), seamless-m4t-medium (the encoder,
cross-attention, LayerNorm, GELU) and xlstm-125m (an mLSTM-only pattern
in f32, the full pattern in bf16); one whole ``make_train_step`` step
against the reference's jitted step, with and without int8 gradient
compression; remat on and off; ``attention_qchunk``; the gradient of
``chunked_remat_scan`` with and without chunking.  The MoE families
(jamba, deepseek-v2) are in ``tests/test_torch_train_moe.py``.

The reference runs compiled (``jax.jit``), as it trains; the port's
parameters are the reference's, carried over by ``params_from_numpy``,
and its gradients come back in the reference's tree through
``transformer.like`` and ``params_to_numpy``.  Tolerances (``rel_err``
= max abs difference over max abs reference): f32 loss and aux at rel
1e-5, logits and each gradient leaf at 1e-4 (summation order); bf16 at
the reference's own 5e-2 bar (``tests/test_arch_smoke.py``).  The
reference refuses an f32 sLSTM forward (its carry ``h`` starts in bf16),
so the sLSTM is held in bf16 only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.kernels.flash_attention import ops as JF
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.train import grad as JG
from repro.train import optimizer as JOPT
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as TF
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.train import grad as TG
from repro_torch.train import optimizer as TOPT

from _train_common import (B, BF16_TOL, F32_TOL, S, check_run, configs,
                           make_batch, port_model, port_run,
                           reference_params, reference_run, rel_err,
                           torch_batch)


# --------------------------------------------------------------------- #
# the families
# --------------------------------------------------------------------- #
def test_granite_gradients_match_the_reference():
    jcfg, tcfg = configs("granite-3-8b")
    params = reference_params(jcfg, 0, "f32")
    check_run(jcfg, tcfg, params, make_batch(jcfg, 1, "f32"), "f32")


def test_seamless_gradients_match_the_reference():
    """The encoder, cross-attention over its output, LayerNorm, GELU."""
    jcfg, tcfg = configs("seamless-m4t-medium")
    assert jcfg.encoder_layers and jcfg.norm == "layernorm"
    params = reference_params(jcfg, 2, "f32")
    check_run(jcfg, tcfg, params, make_batch(jcfg, 3, "f32"), "f32")


def test_xlstm_mlstm_only_gradients_match_the_reference():
    """Two repetitions of an mLSTM-only pattern in f32."""
    jcfg, tcfg = configs("xlstm-125m", pattern=("mlstm",), n_layers=2)
    params = reference_params(jcfg, 4, "f32")
    check_run(jcfg, tcfg, params, make_batch(jcfg, 5, "f32"), "f32")


def test_xlstm_full_pattern_bf16_gradients_match_the_reference():
    """(mLSTM, mLSTM, mLSTM, sLSTM) in bf16, as published."""
    jcfg, tcfg = configs("xlstm-125m")
    params = reference_params(jcfg, 6, "bf16")
    check_run(jcfg, tcfg, params, make_batch(jcfg, 7, "bf16"), "bf16")


# --------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------- #
def _opt_cfgs():
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    return JOPT.AdamWConfig(**kw), TOPT.AdamWConfig(**kw)


def _close(got, want, tol, scale=1.0, flips=False):
    """``got`` within ``tol`` of ``want`` relative to ``scale`` x max
    |want| -- or, with ``flips``, all but at most one element in a
    thousand (int8 rounding flips)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bad = np.abs(got - want) > tol * scale * (np.abs(want).max() + 1e-30)
    assert bad.sum() <= (max(1, want.size // 1000) if flips else 0), (
        bad.sum(), want.size)


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "int8-ef"])
def test_train_step_matches_the_reference_step(compress):
    """One ``make_train_step`` step of the reduced granite in f32 from the
    same parameters, moments and batch: the updated parameters, moments,
    error feedback and metrics.  With int8 compression a gradient element
    within f32 noise of a rounding boundary may round the other way in
    one package (one element of 16,384 in one leaf here), and moves its
    parameter, moments and residual by a quantization step: at most one
    such element in a thousand a leaf is allowed.  The residual is held
    relative to its leaf's gradient scale (254 x its max)."""
    jcfg, tcfg = configs("granite-3-8b")
    params = reference_params(jcfg, 8, "f32")
    batch = make_batch(jcfg, 9, "f32")
    jopt, topt = _opt_cfgs()
    jstate = (params, JG.init_error_feedback(params)) if compress else params
    jstep = jax.jit(JM.make_train_step(jcfg, jopt, compress_grads=compress))
    w_state, w_opt, w_m = jax.tree.map(np.asarray, jstep(
        jstate, JOPT.init(params),
        {k: jnp.asarray(v) for k, v in batch.items()}))

    model = port_model(tcfg, params)
    opt = TOPT.init(model)
    state = (model, TG.init_error_feedback(model)) if compress else model
    step = TM.make_train_step(tcfg, topt, compress_grads=compress)
    state, opt, m = step(state, opt, torch_batch(batch))
    got_model = state[0] if compress else state
    assert got_model is model                # updated in place
    want_params = w_state[0] if compress else w_state
    jax.tree.map(lambda a, b: _close(a, b, 1e-5, flips=compress),
                 TT.params_to_numpy(model), want_params)
    got_opt = TOPT.state_to_numpy(opt)
    assert int(got_opt.step) == int(w_opt.step) == 1
    for got, want in ((got_opt.mu, w_opt.mu), (got_opt.nu, w_opt.nu)):
        jax.tree.map(lambda a, b: _close(a, b, F32_TOL, flips=compress),
                     got, want)
    if compress:
        ef = TT.params_to_numpy(TT.like(model, state[1]))
        jax.tree.map(lambda a, b: _close(a, b, F32_TOL, 254.0, flips=True),
                     ef, w_state[1])
    for key in ("loss", "nll", "grad_norm", "lr"):
        assert abs(float(m[key]) - float(w_m[key])) <= 1e-5 * abs(
            float(w_m[key])), key
    assert float(m["aux"]) == float(w_m["aux"]) == 0.0


def test_remat_on_and_off_give_the_same_gradients():
    """Checkpointing each repetition recomputes the same ops: the loss and
    every gradient are bit for bit the same."""
    jcfg, tcfg = configs("xlstm-125m", pattern=("mlstm",), n_layers=2)
    model = port_model(tcfg, reference_params(jcfg, 10, "f32"))
    batch = torch_batch(make_batch(jcfg, 11, "f32"))
    out = []
    for remat in (False, True):
        loss, _ = TM.loss_fn(model, tcfg, batch, remat=remat)
        out.append((loss, torch.autograd.grad(loss,
                                              list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# --------------------------------------------------------------------- #
# attention_qchunk and the remat scan
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,sk", [(1024, 1024), (48, 48), (32, 40)])
def test_attention_qchunk_matches_the_reference(causal, s, sk):
    """Query blocks of 512 (two at S 1024), GQA 4 over 2; output and the
    gradients of q, k and v."""
    if causal and s > sk:
        pytest.skip("causal attention needs S <= Sk")
    rng = np.random.default_rng(s + sk + causal)
    q = rng.standard_normal((1, 4, s, 8)).astype(np.float32)
    k = rng.standard_normal((1, 2, sk, 8)).astype(np.float32)
    v = rng.standard_normal((1, 2, sk, 8)).astype(np.float32)
    dout = rng.standard_normal((1, 4, s, 8)).astype(np.float32)

    def jfn(q, k, v):
        return JF.attention(q, k, v, causal=causal, impl="qchunk")
    want, vjp = jax.vjp(jax.jit(jfn), *map(jnp.asarray, (q, k, v)))
    w_grads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = TF.attention(tq, tk, tv, causal=causal, impl="qchunk")
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dout))
    assert rel_err(got.detach().numpy(), want) <= 1e-5
    for g, w in zip(grads, w_grads):
        assert rel_err(g.numpy(), w) <= F32_TOL


def test_chunked_remat_scan_gradient_with_and_without_chunks():
    """T 256: chunks of 64 (checkpointed) and none give the same values
    and gradients bit for bit, and both the reference's gradient."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((256, 3, 5)).astype(np.float32)
    a = rng.standard_normal((256, 3, 5)).astype(np.float32)

    def tstep(c, inp):
        x_t, a_t = inp
        c = c * torch.sigmoid(a_t) + torch.tanh(x_t)
        return c, c * c

    def jstep(c, inp):
        x_t, a_t = inp
        c = c * jax.nn.sigmoid(a_t) + jnp.tanh(x_t)
        return c, c * c

    def jloss(x, a):
        c, ys = JL.chunked_remat_scan(jstep, jnp.zeros((3, 5)), (x, a), 64)
        return jnp.sum(ys) + jnp.sum(c)
    w_grads = jax.jit(jax.grad(jloss, argnums=(0, 1)))(x, a)
    out = []
    for chunk in (64, 1):
        tx, ta = (torch.from_numpy(v).requires_grad_() for v in (x, a))
        c, ys = TL.chunked_remat_scan(tstep, torch.zeros(3, 5), (tx, ta),
                                      chunk)
        loss = ys.sum() + c.sum()
        out.append((loss, torch.autograd.grad(loss, (tx, ta))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(g, h) for g, h in zip(out[0][1], out[1][1]))
    for g, w in zip(out[0][1], w_grads):
        assert rel_err(g.numpy(), w) <= 1e-5


# --------------------------------------------------------------------- #
# the kernels' autograd guard
# --------------------------------------------------------------------- #
def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """The shared check: it raises under grad mode when an input requires
    grad, naming the plain path, and passes under ``no_grad`` or without
    such an input.  (The wrappers call it on CUDA tensors only; a CPU
    call runs the plain version, which autograd differentiates.)"""
    from repro_torch.kernels import _build
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match='impl="ref"'):
        _build.refuse_autograd("ssm_scan", 'impl="ref"', torch.ones(3), x)
    with torch.no_grad():
        _build.refuse_autograd("ssm_scan", 'impl="ref"', x)
    _build.refuse_autograd("ssm_scan", 'impl="ref"', x.detach())
    q = torch.ones(1, 2, 4, 8, requires_grad=True)
    out = TF.attention(q, q, q, causal=True)          # cpu: the plain path
    assert out.requires_grad and out.grad_fn is not None
