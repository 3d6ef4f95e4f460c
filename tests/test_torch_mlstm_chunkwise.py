"""The mLSTM scan's chunkwise form held to the stepped recurrence on the
CPU: ``ref.mlstm_chunkwise_ref`` (the algorithm of the chunkwise kernel,
``csrc/mlstm_chunkwise.cu``) against ``ref.mlstm_scan_ref``, the mLSTM
block with its scan swapped for the chunkwise form against the JAX
reference, and the launch plan that picks between the two kernels.

Tolerances (``rel_err`` = max abs difference over max abs reference):
5e-5 in f32, where both forms are exact up to f32 summation order (the
card's f32 bar for the kernels); 2.5e-2 with the chunkwise kernel's
operand roundings emulated on bf16 inputs (the card's bf16 bar, which h's
own bf16 rounding mostly fills); the block's 1e-3 / 3e-2 of
``tests/test_torch_xlstm.py``.  The gate regimes: the served layer's
(log input gates ~ N(0, 2^2), forget gates near 1), input gates that
jump by 30 mid-chunk (the stabiliser moves inside a chunk), forget gates
near 0 (lf ~ -20) with falling input gates (the carried terms dominate,
and a chunk's cumulative log-forget reaches -640), and queries scaled so
that ``|n . q|`` falls on both sides of the clamp's 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as JX
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
from repro_torch.kernels.mlstm_scan import ref as mlstm_ref
from repro_torch.models import xlstm as TX

D, H = 64, 4                  # the block's reduced width: P 32
TOL = {"f32": 1e-3, "bf16": 3e-2}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
KINDS = ("served", "jumps", "forget0", "clamp")


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def to_np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def scan_inputs(kind: str, b: int, s: int, h: int, p: int, *,
                strided: bool, dtype=torch.float32, seed: int = 0):
    """q, k, v ``(B, S, H, P)`` (views of one ``(B, S, 3, H, P)`` tensor
    with ``strided``), k scaled by 1/sqrt(P) as the layer scales it, and
    the f32 log gates of one regime (see the module docstring)."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3, h, p)).astype(np.float32)
    qkv[:, :, 1] *= p ** -0.5
    li = rng.standard_normal((b, s, h)).astype(np.float32) * 2
    pre_f = rng.standard_normal((b, s, h)).astype(np.float32) + 3
    lf = -np.logaddexp(0, -pre_f).astype(np.float32)
    t = np.arange(s, dtype=np.float32)[None, :, None]
    if kind == "jumps":
        li[:, 5::11] += 30
    elif kind == "forget0":
        lf = (-20 + rng.standard_normal((b, s, h))).astype(np.float32)
        li = (-25 * t + li).astype(np.float32)
    elif kind == "clamp":
        qkv[:, :, 0] *= np.exp(rng.uniform(-5, 3, (b, s, h, 1)))
    elif kind != "served":
        raise ValueError(kind)
    if strided:
        q, k, v = torch.from_numpy(qkv).to(dtype).unbind(2)
    else:
        q, k, v = (torch.from_numpy(np.ascontiguousarray(qkv[:, :, i]))
                   .to(dtype) for i in range(3))
    return q, k, v, torch.from_numpy(li), torch.from_numpy(lf)


def stepped_nq(q, k, log_i, log_f) -> np.ndarray:
    """``n_t . q_t`` of the stepped recurrence, for the clamp regime's
    check that it falls on both sides of 1."""
    qf, kf = to_np(q), to_np(k)
    li, lf = to_np(log_i), to_np(log_f)
    n = np.zeros(qf.shape[:1] + qf.shape[2:], np.float32)
    m = np.full(li.shape[:1] + li.shape[2:], mlstm_ref.M0, np.float32)
    out = []
    for t in range(qf.shape[1]):
        m_new = np.maximum(lf[:, t] + m, li[:, t])
        fp = np.exp(lf[:, t] + m - m_new)[..., None]
        ip = np.exp(li[:, t] - m_new)[..., None]
        n = fp * n + ip * kf[:, t]
        m = m_new
        out.append(np.sum(n * qf[:, t], -1))
    return np.stack(out, 1)


def mlstm_params(dt: str, seed: int = 0):
    """The block's reference parameters in ``dt`` (a non-trivial norm
    weight in bf16) and the same values as torch tensors, bit for bit."""
    jd = DT[dt][0]
    p = jax.tree.map(lambda a: a.astype(jd),
                     JX.mlstm_init(jax.random.PRNGKey(seed), D, H))
    if dt == "bf16":
        p["out_norm"] = jnp.asarray(1 + 0.1 * np.random.default_rng(
            seed).standard_normal(p["out_norm"].shape), jd)
    return p, {k: torch.from_numpy(np.asarray(a).astype(np.float32)).to(
        DT[dt][1]) for k, a in p.items()}


def lengths(chunk: int):
    return (1, chunk - 1, chunk, chunk + 1, 37, 129)


CASES = [(chunk, s, kind) for chunk in (mlstm_ref.CHUNKWISE_L, 16)
         for s in lengths(chunk) for kind in KINDS]


@pytest.mark.parametrize("chunk,s,kind", CASES)
def test_chunkwise_plain_version_matches_the_stepped_one(chunk, s, kind):
    """f32 operands: the chunkwise algebra equals the stepped recurrence
    to f32 rounding at T on and off the chunk boundary, strided inputs
    at odd T."""
    args = scan_inputs(kind, 2, s, 2, 32, strided=s % 2 == 1, seed=s)
    want = mlstm_ref.mlstm_scan_ref(*args)
    got = mlstm_ref.mlstm_chunkwise_ref(*args, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel_err(to_np(got), to_np(want)) <= 5e-5


def test_the_gate_regimes_reach_what_they_are_for():
    """The clamp regime's ``|n . q|`` falls on both sides of 1; the
    forget-0 regime's chunk of 32 sums its log-forget gates past -600
    while the stabiliser follows the forget path (carried terms weigh
    1), and the jumps move the stabiliser to the input gate mid-chunk."""
    q, k, _, li, lf = scan_inputs("clamp", 2, 129, 2, 32, strided=False)
    nq = np.abs(stepped_nq(q, k, li, lf))
    assert (nq < 0.5).mean() > 0.1 and (nq > 2).mean() > 0.1
    _, _, _, li, lf = scan_inputs("forget0", 2, 129, 2, 32, strided=False)
    assert float(lf[:, :32].sum(1).max()) < -600
    li, lf = to_np(li), to_np(lf)
    m = np.full((2, 2), mlstm_ref.M0, np.float32)
    forget_path = []
    for t in range(129):
        forget_path.append(lf[:, t] + m >= li[:, t])
        m = np.maximum(lf[:, t] + m, li[:, t])
    assert np.mean(forget_path[1:]) > 0.9
    _, _, _, li, _ = scan_inputs("jumps", 2, 129, 2, 32, strided=False)
    assert float(li[:, 5::11].min()) > 20


@pytest.mark.parametrize("s", [1, 33, 129])
@pytest.mark.parametrize("kind", KINDS)
def test_chunkwise_with_the_kernels_operand_roundings(kind, s):
    """bf16 inputs, the three f32 tensor-core operands handed over as
    the chunkwise kernel hands them (bf16 triples): within the card's
    bf16 bar of the stepped recurrence on the same inputs, the error at
    h's own rounding; and h's bf16 values as the unrounded operands give
    them but where f32 sums part at a rounding boundary."""
    args = scan_inputs(kind, 2, s, 2, 32, strided=True,
                       dtype=torch.bfloat16, seed=s)
    want = to_np(mlstm_ref.mlstm_scan_ref(*args))
    got = mlstm_ref.mlstm_chunkwise_ref(
        *args, operands=mlstm_ref.KERNEL_OPERANDS)
    assert got.dtype == torch.bfloat16
    err = rel_err(to_np(got), want)
    assert err <= 2.5e-2
    exact = mlstm_ref.mlstm_chunkwise_ref(*args)
    assert err <= max(rel_err(to_np(exact), want), 2 ** -8)
    assert float((got != exact).float().mean()) <= 1e-3


def test_operand_roundings_are_the_kernels():
    """One rounding to bf16 carries x to 2^-8 of |x|, the pair to 2^-16,
    the triple the kernel uses (``split3`` in the source) to 2^-24 (2^-23
    with the f32 sum that emulates it)."""
    x = torch.tensor([1.0 + 2 ** -9 + 2 ** -20, -3.14159265, 1e-30, 0.0,
                      0.1, 7.0 / 3.0])
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    assert torch.equal(mlstm_ref._operand(x, "bf16"), hi)
    assert torch.equal(mlstm_ref._operand(x, "f32"), x)
    pair = mlstm_ref._operand(x, "bf16x2")
    assert torch.equal(pair, hi + mid)
    triple = mlstm_ref._operand(x, mlstm_ref.KERNEL_OPERANDS)
    assert torch.equal(triple, hi + mid + (x - hi - mid).to(
        torch.bfloat16).float())
    x64 = x.double()
    for got, bound in ((hi, 2 ** -8), (pair, 2 ** -16),
                       (triple, 2 ** -23)):
        assert float(((got.double() - x64).abs()
                      - bound * x64.abs()).max()) <= 0
    with pytest.raises(ValueError, match="unknown operands"):
        mlstm_ref._operand(x, "tf32")
    with pytest.raises(ValueError, match="chunk must be positive"):
        mlstm_ref.mlstm_chunkwise_ref(*scan_inputs(
            "served", 1, 3, 1, 32, strided=False), chunk=0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s", [37, 256])
def test_mlstm_forward_on_the_chunkwise_scan_matches_the_reference(
        dt, s, monkeypatch):
    """The mLSTM block with its scan swapped for the chunkwise form (f32
    operands in f32, the kernel's hi/mid/lo triples in bf16) against the
    compiled JAX block, at the tolerance of
    ``test_mlstm_forward_matches_the_reference``."""
    jd, td = DT[dt]
    jp, tp = mlstm_params(dt)
    operands = "f32" if dt == "f32" else mlstm_ref.KERNEL_OPERANDS
    calls = []

    def chunkwise(q, k, v, log_i, log_f, *, impl="kernel"):
        calls.append(q.shape)
        return mlstm_ref.mlstm_chunkwise_ref(q, k, v, log_i, log_f,
                                             operands=operands)
    monkeypatch.setattr(mlstm_ops, "mlstm_scan", chunkwise)
    x = np.random.default_rng(3).standard_normal((2, s, D))
    want = jax.jit(lambda p, x: JX.mlstm_forward(p, x, H))(
        jp, jnp.asarray(x, jd))
    got = TX.mlstm_forward(tp, torch.from_numpy(x).to(td), H)
    assert calls == [(2, s, H, 2 * D // H)]
    assert got.dtype == td
    assert rel_err(to_np(got), want) <= TOL[dt]


# --------------------------------------------------------------------- #
# the launch plan
# --------------------------------------------------------------------- #
def test_mlstm_launch_plan_at_the_served_shape():
    """xlstm-125m's mLSTM (P 384) in bf16: the chunkwise kernel on its
    widest tile, 4 CTAs of 96 rows a head; in f32 the recurrent
    kernel."""
    plan = mlstm_ops.launch_plan(384, torch.bfloat16)
    assert plan == mlstm_ops.Plan("chunkwise", tile=384, ctas=4)
    assert mlstm_ops.launch_plan(384, torch.float32) \
        == mlstm_ops.Plan("recurrent")
    assert mlstm_ops.CHUNK == mlstm_ref.CHUNKWISE_L == 32


@pytest.mark.parametrize("p", [32, 64, 96, 128, 160, 192, 256, 288, 384,
                               416, 512, 48, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_launch_plan_obeys_the_kernel_limits(p, dtype):
    """bf16 with P a multiple of 32 up to 384 takes the chunkwise kernel
    on the narrowest tile that holds P, ceil(P / 96) CTAs; every other
    shape, and all of f32, the recurrent kernel."""
    plan = mlstm_ops.launch_plan(p, dtype)
    if dtype == torch.float32 or p % 32 or p > 384:
        assert plan == mlstm_ops.Plan("recurrent")
        return
    assert plan.design == "chunkwise"
    assert plan.tile == min(t for t in (32, 128, 384) if t >= p)
    assert plan.ctas == -(-p // 96)


def test_launch_plan_and_launch_refuse_what_no_kernel_takes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mlstm_ops.launch_plan(64, torch.float16)
    with pytest.raises(ValueError, match="positive"):
        mlstm_ops.launch_plan(0, torch.bfloat16)
    before = (mlstm_ops.launches, dict(mlstm_ops.designs))
    q = torch.zeros(1, 3, 2, 32)
    g = torch.zeros(1, 3, 2)
    with pytest.raises(ValueError, match="chunkwise kernel takes bf16"):
        mlstm_ops.launch(q, q, q, g, g, mlstm_ops.Plan("chunkwise", 32))
    qb = torch.zeros(1, 3, 2, 512, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head size up to 384"):
        mlstm_ops.launch(qb, qb, qb, g, g, mlstm_ops.Plan("chunkwise", 384))
    with pytest.raises(ValueError, match="unknown mlstm_scan design"):
        mlstm_ops.launch(q, q, q, g, g, mlstm_ops.Plan("stepped"))
    with pytest.raises(ValueError, match="multiple of 32 up to 512"):
        mlstm_ops.launch(q[..., :16], q[..., :16], q[..., :16], g, g,
                         mlstm_ops.Plan("recurrent"))
    assert (mlstm_ops.launches, mlstm_ops.designs) == before


def test_reset_launches_zeroes_both_counts():
    mlstm_ops.launches = 5
    mlstm_ops.designs.update(chunkwise=3, recurrent=2)
    mlstm_ops.reset_launches()
    assert mlstm_ops.launches == 0
    assert mlstm_ops.designs == {"chunkwise": 0, "recurrent": 0}
