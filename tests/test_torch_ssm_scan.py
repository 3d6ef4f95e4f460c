"""The port's selective scan -- the ``ssm_scan`` kernel's plain version
and the one-token ``single_step`` -- held to the JAX package on the CPU.

On the CPU the wrapper runs the kernel's plain version (``ref.py``),
which is compared here with the reference's jnp oracle
(``ssm_scan_ref``) and its Pallas kernel in interpret mode, on the same
numpy-seeded inputs.  Tolerance: the reference's own ``tol(dtype)`` on
``rel_err`` (``tests/test_kernels.py``) -- 5e-5 in f32 (summation order),
2.5e-2 in bf16 (the output is rounded to bf16).  The CUDA kernel itself
is held to the plain version by the ``cuda``-marked test at the end
(skipped without a card) and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import single_step as j_single_step
from repro.kernels.ssm_scan.ops import ssm_scan as j_ssm_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_ssm_scan_ref
from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan import ref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def tol(dt: str) -> float:
    return 2.5e-2 if dt == "bf16" else 5e-5


def to_np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def scan_inputs(rng, bh, t, p, n):
    """The reference sweep's distributions (``tests/test_kernels.py``):
    x, b, c ~ N(0, 0.25), dt in [0.01, 0.11), a < -0.1, d ~ N(0, 0.01);
    a and d stay f32."""
    return (rng.standard_normal((bh, t, p)) * 0.5,
            rng.random((bh, t, p)) * 0.1 + 0.01,
            rng.standard_normal((bh, t, n)) * 0.5,
            rng.standard_normal((bh, t, n)) * 0.5,
            -np.abs(rng.standard_normal((p, n))) - 0.1,
            rng.standard_normal(p) * 0.1)


def both(arrays, dt: str):
    """The four activations in ``dt``, a and d in f32, for each
    package."""
    jd, td = DTYPES[dt]
    j = [jnp.asarray(a, jd) for a in arrays[:4]]
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(td)
         for a in arrays[:4]]
    for a in arrays[4:]:
        j.append(jnp.asarray(a, jnp.float32))
        t.append(torch.from_numpy(np.asarray(a, np.float32)))
    return j, t


# --------------------------------------------------------------------- #
# the scan
# --------------------------------------------------------------------- #
# tests/test_kernels.py's sweep, then T = 1 and a T no chunk divides
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("bh,t,p,n,chunk", [
    (2, 64, 16, 8, 16), (1, 128, 32, 16, 64), (4, 32, 8, 4, 32),
    (3, 1, 12, 16, 1), (2, 100, 20, 8, 100)])
def test_plain_scan_matches_the_reference(bh, t, p, n, chunk, dt):
    rng = np.random.default_rng(bh + t + p)
    (jx, jdt, jb, jc, ja, jdd), args = both(scan_inputs(rng, bh, t, p, n),
                                           dt)
    before = ops.launches
    got = ops.ssm_scan(*args)
    assert ops.launches == before            # the CPU ran the plain version
    assert got.dtype == DTYPES[dt][1] and got.shape == (bh, t, p)
    want = j_ssm_scan_ref(jx, jdt, jb, jc, ja, jdd)
    assert rel_err(to_np(got), want) < tol(dt)
    pallas = j_ssm_scan(jx, jdt, jb, jc, ja, jdd, impl="pallas",
                        chunk=chunk)
    assert rel_err(to_np(got), pallas) < tol(dt)
    assert torch.equal(ops.ssm_scan(*args, impl="ref"), got)


def test_plain_scan_reads_column_views_like_copies():
    """b and c as column slices of one projection (the Mamba layer's
    ``x_proj`` output) give the same bits as contiguous copies."""
    rng = np.random.default_rng(4)
    bh, t, p, n, rank = 2, 9, 6, 4, 3
    x, dt, _, _, a, d = [torch.from_numpy(np.asarray(v, np.float32))
                         for v in scan_inputs(rng, bh, t, p, n)]
    xdbc = torch.from_numpy(rng.standard_normal(
        (bh, t, rank + 2 * n)).astype(np.float32))
    b, c = xdbc[..., rank:rank + n], xdbc[..., rank + n:]
    assert not b.is_contiguous()
    assert torch.equal(ops.ssm_scan(x, dt, b, c, a, d),
                       ops.ssm_scan(x, dt, b.contiguous(), c.contiguous(),
                                    a, d))


def test_ssm_scan_rejections(monkeypatch, tmp_path):
    x = torch.zeros((2, 5, 4))
    bc = torch.zeros((2, 5, 3))
    a, d = torch.zeros((4, 3)), torch.zeros(4)
    with pytest.raises(ValueError, match="x and dt"):
        ops.ssm_scan(x, x[:, :4], bc, bc, a, d)
    with pytest.raises(ValueError, match="b and c"):
        ops.ssm_scan(x, x, bc[:, :4], bc[:, :4], a, d)
    with pytest.raises(ValueError, match="a must be"):
        ops.ssm_scan(x, x, bc, bc, a[:, :2], d)
    with pytest.raises(TypeError, match="b is"):
        ops.ssm_scan(x, x, bc.bfloat16(), bc, a, d)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.ssm_scan(x.half(), x.half(), bc.half(), bc.half(), a, d)
    with pytest.raises(ValueError, match="unknown"):
        ops.ssm_scan(x, x, bc, bc, a, d, impl="pallas")
    # a tensor that is on neither the CPU nor a card is refused, not
    # computed on the CPU
    meta = [t.to("meta") for t in (x, x, bc, bc, a, d)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.ssm_scan(*meta)
    # where no library can be built, loading the kernel raises (a CUDA
    # call never falls back to the plain version)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(ops, "_lib_cache", [])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops._lib()


def test_wrapper_tile_and_chunk_are_the_kernels_defaults():
    """``ops.TILE`` / ``ops.CHUNK`` (which the card's tests use to cross
    the kernel's widths) name the source's compile-time constants."""
    import re
    src = ops.SOURCE.read_text()
    d = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);",
                                          src)}
    assert ops.TILE == d["kC"] * d["kThreads"]
    assert ops.CHUNK == d["kChunk"]


# --------------------------------------------------------------------- #
# one decode step
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_single_step_matches_the_reference(dt):
    rng = np.random.default_rng(21)
    bh, p, n = 3, 10, 8
    jd, td = DTYPES[dt]
    h0 = rng.standard_normal((bh, p, n)).astype(np.float32)
    x, dtv, b, c, a, d = scan_inputs(rng, bh, 1, p, n)
    acts = [v[:, 0] for v in (x, dtv, b, c)]
    jh, jy = j_single_step(jnp.asarray(h0), *[jnp.asarray(v, jd)
                                              for v in acts],
                           jnp.asarray(a, jnp.float32),
                           jnp.asarray(d, jnp.float32))
    h = torch.from_numpy(h0.copy())
    th, ty = ops.single_step(h, *[torch.from_numpy(
        np.asarray(v, np.float32)).to(td) for v in acts],
        torch.from_numpy(a.astype(np.float32)),
        torch.from_numpy(d.astype(np.float32)))
    assert th is h and th.dtype == torch.float32   # updated in place
    assert ty.dtype == td
    # in bf16 the reference rounds dt_t * x_t to bf16 before the upcast,
    # and XLA may drop that rounding when it fuses the two: tol(dtype)
    assert rel_err(to_np(th), jh) < (1e-6 if dt == "f32" else tol(dt))
    assert rel_err(to_np(ty), jy) < tol(dt)


def test_single_step_stepped_equals_the_scan():
    """``tests/test_kernels.py``'s consistency check: T single steps from
    a zero state give the scan's outputs."""
    rng = np.random.default_rng(9)
    bh, t, p, n = 2, 16, 8, 4
    x, dt, b, c, a, d = [torch.from_numpy(np.asarray(v, np.float32))
                         for v in scan_inputs(rng, bh, t, p, n)]
    want = ref.ssm_scan_ref(x, dt, b, c, a, d)
    h = torch.zeros((bh, p, n))
    for i in range(t):
        h, y = ops.single_step(h, x[:, i], dt[:, i], b[:, i], c[:, i], a, d)
        assert rel_err(to_np(y), to_np(want[:, i])) < 1e-5


# --------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------- #
@pytest.mark.cuda
def test_cuda_kernel_matches_its_plain_version():
    """Run on a card only: the Hopper kernel against its plain version on
    the same CUDA tensors -- ragged T and P, T = 1, column views for b and
    c, N below 16 -- in f32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(13)
    for dt in ("f32", "bf16"):
        td = DTYPES[dt][1]
        for bh, t, p, n in [(2, 300, 200, 16), (1, 1, 5, 16),
                            (3, 70, 128, 4), (2, 65, 33, 8)]:
            x, dtv, b, c, a, d = [
                torch.from_numpy(np.asarray(v, np.float32)).cuda()
                for v in scan_inputs(rng, bh, t, p, n)]
            xdbc = torch.cat([b, c], dim=-1).to(td)
            args = (x.to(td), dtv.to(td), xdbc[..., :n], xdbc[..., n:],
                    a, d)
            before = ops.launches
            got = ops.ssm_scan(*args)
            assert ops.launches == before + 1
            want = ref.ssm_scan_ref(*args)
            torch.cuda.synchronize()
            assert rel_err(to_np(got), to_np(want)) < tol(dt)



@pytest.mark.cuda
def test_cuda_kernel_on_two_devices():
    """Run on two cards only: the f32 kernel needs more than 48 KB of
    shared memory a CTA, an attribute set per device, so a launch on the
    second card after one on the first must be granted it too."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(14)
    inputs = [torch.from_numpy(np.asarray(v, np.float32))
              for v in scan_inputs(rng, 2, 70, 300, 16)]
    for dev in ("cuda:0", "cuda:1", "cuda:0"):
        args = [v.to(dev) for v in inputs]
        got = ops.ssm_scan(*args)
        want = ref.ssm_scan_ref(*args)
        torch.cuda.synchronize(dev)
        assert got.device == torch.device(dev)
        assert rel_err(to_np(got), to_np(want)) < tol("f32")