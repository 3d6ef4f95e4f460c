"""The port's two attention kernels -- flash attention (prefill) and
decode attention -- held to the JAX package on the CPU.

On the CPU each wrapper runs its kernel's plain version (``ref.py``),
which is compared here with the reference's Pallas kernels in interpret
mode, its chunked streaming versions and its plain oracles, on the same
numpy-seeded inputs.  Tolerance: the reference's own ``tol(dtype)`` on
``rel_err`` (``tests/test_kernels.py``) -- 5e-5 in f32 (summation order),
2.5e-2 in bf16 (the output is rounded to bf16; the reference's XLA
decode also rounds the probabilities to bf16).  The CUDA kernels
themselves are held to the plain versions by the ``cuda``-marked test at
the end (skipped without a card) and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import (
    decode_attention_pallas)
from repro.kernels.decode_attention.ops import decode_attention_chunked
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_pallas)
from repro.kernels.flash_attention.ops import attention_chunked
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def tol(dt: str) -> float:
    return 2.5e-2 if dt == "bf16" else 5e-5


def both(a: np.ndarray, dt: str):
    jd, td = DTYPES[dt]
    return (jnp.asarray(a, jd),
            torch.from_numpy(np.asarray(a, np.float32)).to(td))


def to_np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# --------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------- #
# tests/test_kernels.py's grid, then ragged S (not a multiple of the
# port's 64-row tiles), G = 4 with D = 128, and D = 96
FLASH = [
    (2, 4, 2, 64, 32, True, 32),
    (1, 8, 8, 128, 64, True, 32),    # MHA
    (2, 8, 1, 96, 16, True, 32),     # MQA
    (1, 4, 2, 64, 128, False, 32),   # bidirectional
    (1, 8, 2, 80, 128, True, 16),    # G = 4, D = 128, ragged
    (2, 4, 4, 100, 96, False, 20),   # ragged, D = 96
    (1, 8, 1, 136, 64, True, 8),     # G = 8, two full tiles + 8 rows
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,blk", FLASH)
def test_flash_plain_version_matches_the_reference(b, hq, hkv, s, d,
                                                   causal, blk, dt):
    rng = np.random.default_rng(b + hq + s + d)
    qa = rng.standard_normal((b, hq, s, d))
    ka = rng.standard_normal((b, hkv, s, d))
    va = rng.standard_normal((b, hkv, s, d))
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dt) for a in (qa, ka, va))
    before = fops.launches
    out = fops.attention(tq, tk, tv, causal=causal)
    assert fops.launches == before          # the plain version: no launch
    assert out.dtype == DTYPES[dt][1] and out.shape == tq.shape
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, block_q=blk,
                                    block_k=blk, interpret=True)
    assert rel_err(to_np(out), pallas) < tol(dt)
    # attention_chunked pads a ragged Sk and then offsets causal rows by
    # the PADDED length, so it is only held where its block divides S
    assert rel_err(to_np(out), attention_chunked(jq, jk, jv, causal=causal,
                                                 block_k=blk)) < tol(dt)
    assert rel_err(to_np(out), attention_ref(jq, jk, jv,
                                             causal=causal)) < tol(dt)
    assert torch.equal(out, fops.attention(tq, tk, tv, causal=causal,
                                           impl="ref"))


def test_flash_reads_strided_views():
    """A (B, S, H, D) projection viewed as (B, H, S, D) gives the same
    output as its contiguous copy."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 70, 8, 32))).float()
    k = torch.from_numpy(rng.standard_normal((2, 70, 2, 32))).float()
    v = torch.from_numpy(rng.standard_normal((2, 70, 2, 32))).float()
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    out = fops.attention(*views, causal=True)
    want = fops.attention(*[t.contiguous() for t in views], causal=True)
    assert torch.equal(out, want)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_causal_offset_when_s_lt_sk(causal):
    """Fewer queries than keys: the causal mask offsets rows by Sk - S,
    as the reference's attention_ref and attention_chunked do (the
    Pallas kernel's mask has no offset; it only ever sees S == Sk)."""
    rng = np.random.default_rng(9)
    qa = rng.standard_normal((2, 4, 24, 32))
    ka = rng.standard_normal((2, 2, 90, 32))
    va = rng.standard_normal((2, 2, 90, 32))
    (jq, tq), (jk, tk), (jv, tv) = (both(a, "f32") for a in (qa, ka, va))
    out = to_np(fops.attention(tq, tk, tv, causal=causal))
    assert rel_err(out, attention_ref(jq, jk, jv, causal=causal)) < 5e-5
    assert rel_err(out, attention_chunked(jq, jk, jv, causal=causal,
                                          block_k=30)) < 5e-5   # 30 | 90
    if causal:
        # the last query row sees every key; the first sees Sk - S + 1
        k2, v2 = tk.clone(), tv.clone()
        k2[:, :, 90 - 24 + 1:] = 99.0
        v2[:, :, 90 - 24 + 1:] = -99.0
        out2 = to_np(fops.attention(tq, k2, v2, causal=True))
        assert np.array_equal(out2[:, :, 0], out[:, :, 0])
        assert not np.allclose(out2[:, :, -1], out[:, :, -1])


def test_flash_rejections():
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="S <= Sk"):
        fops.attention(q, k[:, :, :4], k[:, :, :4], causal=True)
    fops.attention(q, k[:, :, :4], k[:, :, :4], causal=False)  # fine
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((1, 2, 8, 200))
        fops.attention(big, big, big)
    mla = torch.zeros((1, 2, 8, 192))           # MLA's nope 128 + rope 64
    assert fops.attention(mla, mla, mla).shape == mla.shape
    with pytest.raises(ValueError, match="multiple"):
        fops.attention(q, torch.zeros((1, 3, 8, 16)),
                       torch.zeros((1, 3, 8, 16)))
    with pytest.raises(TypeError, match="k is"):
        fops.attention(q, k.bfloat16(), k)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fops.attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="shape"):
        fops.attention(q, k, k[:, :1])
    with pytest.raises(ValueError, match="unknown"):
        fops.attention(q, k, k, impl="pallas")


# --------------------------------------------------------------------- #
# decode attention
# --------------------------------------------------------------------- #
# tests/test_kernels.py's grid, then the serving slice's G = 4, D = 128
# over a 544-row cache (8.5 tiles of 64), and G = 8 with D = 96
DECODE = [
    (2, 8, 2, 256, 32, 64),
    (1, 4, 4, 128, 64, 64),
    (3, 8, 1, 64, 16, 64),
    (1, 16, 2, 512, 128, 64),
    (2, 32, 8, 544, 128, 32),
    (2, 16, 2, 100, 96, 20),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s,d,blk", DECODE)
def test_decode_plain_version_matches_the_reference(b, hq, hkv, s, d, blk,
                                                    dt):
    rng = np.random.default_rng(b * 31 + s + d)
    qa = rng.standard_normal((b, hq, d))
    ka = rng.standard_normal((b, s, hkv, d))
    va = rng.standard_normal((b, s, hkv, d))
    la = rng.integers(1, s + 1, b).astype(np.int32)
    la[0] = s                                   # one full cache
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dt) for a in (qa, ka, va))
    jl, tl = jnp.asarray(la), torch.from_numpy(la)
    before = dops.launches
    out = dops.decode_attention(tq, tk, tv, tl)
    assert dops.launches == before
    assert out.dtype == DTYPES[dt][1] and out.shape == tq.shape
    pallas = decode_attention_pallas(jq, jk, jv, jl, block_s=blk,
                                     interpret=True)
    assert rel_err(to_np(out), pallas) < tol(dt)
    assert rel_err(to_np(out), decode_attention_chunked(jq, jk, jv,
                                                        jl)) < tol(dt)
    assert rel_err(to_np(out), decode_attention_ref(jq, jk, jv,
                                                    jl)) < tol(dt)


def test_decode_mixed_dtypes_f32_query_over_bf16_cache():
    """An f32 model keeps a bf16 cache (as the reference does)."""
    rng = np.random.default_rng(2)
    qa = rng.standard_normal((2, 8, 32))
    ka = rng.standard_normal((2, 40, 2, 32))
    va = rng.standard_normal((2, 40, 2, 32))
    la = np.array([40, 17], np.int32)
    jq, tq = both(qa, "f32")
    (jk, tk), (jv, tv) = (both(a, "bf16") for a in (ka, va))
    out = dops.decode_attention(tq, tk, tv, torch.from_numpy(la))
    assert out.dtype == torch.float32
    pallas = decode_attention_pallas(jq, jk, jv, jnp.asarray(la),
                                     block_s=8, interpret=True)
    assert rel_err(to_np(out), pallas) < 5e-5


def test_decode_zero_length_gives_zero_unlike_the_plain_reference():
    """lengths == 0: the Pallas kernel's ``l == 0`` guard returns 0, and
    so do the port's kernel and plain version.  The reference's
    decode_attention_ref / _chunked softmax uniform -1e30 logits and
    return the mean of V instead."""
    rng = np.random.default_rng(6)
    qa = rng.standard_normal((3, 8, 16))
    ka = rng.standard_normal((3, 64, 2, 16))
    va = rng.standard_normal((3, 64, 2, 16))
    la = np.array([0, 64, 1], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (both(a, "f32") for a in (qa, ka, va))
    out = to_np(dops.decode_attention(tq, tk, tv, torch.from_numpy(la)))
    assert np.array_equal(out[0], np.zeros_like(out[0]))
    pallas = np.asarray(decode_attention_pallas(
        jq, jk, jv, jnp.asarray(la), block_s=16, interpret=True))
    assert np.array_equal(pallas[0], np.zeros_like(pallas[0]))
    assert rel_err(out, pallas) < 5e-5
    # the length-1 row is exactly V's first row of its KV head
    want = np.repeat(va[2, 0], 4, axis=0).reshape(8, 16)
    assert np.allclose(out[2], want, atol=1e-6)
    mean_v = np.repeat(va[0].mean(axis=0), 4, axis=0).reshape(8, 16)
    for ref in (decode_attention_ref(jq, jk, jv, jnp.asarray(la)),
                decode_attention_chunked(jq, jk, jv, jnp.asarray(la))):
        assert np.allclose(np.asarray(ref)[0], mean_v, atol=1e-5)


def test_decode_ignores_rows_past_length():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 4, 32))).float()
    k = torch.from_numpy(rng.standard_normal((2, 128, 2, 32))).float()
    v = torch.from_numpy(rng.standard_normal((2, 128, 2, 32))).float()
    lengths = torch.tensor([40, 97], dtype=torch.int32)
    out1 = dops.decode_attention(q, k, v, lengths)
    k2, v2 = k.clone(), v.clone()
    k2[0, 40:], v2[0, 40:] = 999.0, -999.0
    k2[1, 97:], v2[1, 97:] = 999.0, -999.0
    assert torch.equal(dops.decode_attention(q, k2, v2, lengths), out1)
    # lengths past the cache clamp to it
    full = dops.decode_attention(q, k, v, torch.tensor([128, 128]))
    assert torch.equal(dops.decode_attention(q, k, v,
                                             torch.tensor([500, 129])),
                       full)


def test_decode_rejections():
    q = torch.zeros((2, 4, 16))
    k = torch.zeros((2, 8, 2, 16))
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        dops.decode_attention(torch.zeros((2, 4, 160)),
                              torch.zeros((2, 8, 2, 160)),
                              torch.zeros((2, 8, 2, 160)), lengths)
    with pytest.raises(ValueError, match="multiple"):
        dops.decode_attention(q, torch.zeros((2, 8, 3, 16)),
                              torch.zeros((2, 8, 3, 16)), lengths)
    with pytest.raises(ValueError, match="exceeds"):
        dops.decode_attention(torch.zeros((1, 64, 128)),
                              torch.zeros((1, 8, 1, 128)),
                              torch.zeros((1, 8, 1, 128)), lengths[:1])
    with pytest.raises(ValueError, match="lengths"):
        dops.decode_attention(q, k, k, lengths[:1])
    with pytest.raises(TypeError, match="v is"):
        dops.decode_attention(q, k, k.bfloat16(), lengths)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dops.decode_attention(q.half(), k, k, lengths)
    with pytest.raises(ValueError, match="unknown"):
        dops.decode_attention(q, k, k, lengths, impl="xla")


# --------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------- #
@pytest.mark.cuda
def test_cuda_kernels_match_their_plain_versions():
    """Run on a card only: each Hopper kernel against its plain version
    on the same CUDA tensors, at ragged shapes, the Jamba cut's and S off
    the flash kernel's 128-row tiles, in f32 and bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    for dt in ("f32", "bf16"):
        td = DTYPES[dt][1]
        for b, hq, hkv, s, sk, d, causal in [
                (2, 32, 8, 200, 200, 128, True), (1, 4, 4, 33, 97, 64, True),
                (3, 8, 1, 70, 70, 96, False), (1, 2, 2, 1, 5, 16, True),
                (2, 8, 2, 129, 255, 128, True),     # off the 128-row tiles
                (1, 8, 1, 192, 320, 64, False),
                (8, 64, 8, 2048, 2048, 128, True)]:  # the Jamba cut's
            q, k, v = (torch.from_numpy(rng.standard_normal(shape)).to(
                device="cuda", dtype=td) for shape in (
                    (b, hq, s, d), (b, hkv, sk, d), (b, hkv, sk, d)))
            before = fops.launches
            got = fops.attention(q, k, v, causal=causal)
            assert fops.launches == before + 1
            want = fref.attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert rel_err(to_np(got), to_np(want)) < tol(dt)
        for b, hq, hkv, s, d in [(8, 32, 8, 544, 128), (3, 8, 1, 70, 96),
                                 (2, 4, 4, 5, 16), (8, 64, 8, 2080, 128),
                                 (4, 16, 2, 1000, 64)]:
            q = torch.from_numpy(rng.standard_normal((b, hq, d))).to(
                device="cuda", dtype=td)
            k, v = (torch.from_numpy(rng.standard_normal(
                (b, s, hkv, d))).to(device="cuda", dtype=td)
                for _ in range(2))
            lengths = torch.from_numpy(rng.integers(0, s + 1, b).astype(
                np.int32)).cuda()
            got = dops.decode_attention(q, k, v, lengths)
            want = dref.decode_attention_ref(q, k, v, lengths)
            torch.cuda.synchronize()
            assert rel_err(to_np(got), to_np(want)) < tol(dt)


#: head dims above 128 (the bf16 kernel's 64-row K/V tile plan): the
#: one-card deepseek-v2 cut's prefill (B 8, 128 heads, S 512, D 192), S
#: one before, on and one after the 64- and 128-row tiles, D 136 and 184,
#: and ragged shapes with G > 1
FLASH_MLA = [(8, 128, 128, 512, 512, 192, True),
             (2, 4, 2, 63, 63, 192, True), (2, 4, 2, 65, 65, 192, True),
             (2, 4, 2, 127, 127, 192, True), (2, 4, 2, 129, 129, 192, True),
             (1, 4, 4, 100, 300, 136, True), (2, 8, 2, 200, 200, 184, False),
             (3, 8, 1, 77, 150, 192, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s,sk,d,causal", FLASH_MLA)
def test_cuda_flash_kernel_above_head_dim_128(b, hq, hkv, s, sk, d, causal,
                                              dt):
    """Run on a card only: the flash kernel at MLA's head dims against its
    plain version on the same CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU "
                    "mode (the plain version at D 192 is held to the "
                    "reference in tests/test_torch_mla.py)")
    rng = np.random.default_rng(s + d)
    td = DTYPES[dt][1]
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).to(
        device="cuda", dtype=td) for shape in (
            (b, hq, s, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    before = fops.launches
    got = fops.attention(q, k, v, causal=causal)
    assert fops.launches == before + 1
    want = fref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert rel_err(to_np(got), to_np(want)) < tol(dt)


# --------------------------------------------------------------------- #
# cross-attention: not causal over a memory, every decode length M
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s,sk,blk", [(9, 37, 16), (40, 37, 16),
                                      (16, 161, 64)])
def test_flash_not_causal_over_a_ragged_memory(s, sk, blk, dt):
    """Cross-attention's prefill: S queries over a memory of Sk rows that
    the reference's block does not divide (it pads and masks the tail),
    S below and above Sk, through (B, S, H, D) / (B, M, Hkv, D) views."""
    rng = np.random.default_rng(s + sk)
    q = rng.standard_normal((2, s, 8, 16))
    k, v = (rng.standard_normal((2, sk, 2, 16)) for _ in range(2))
    jq, tq = both(q, dt)
    (jk, tk), (jv, tv) = both(k, dt), both(v, dt)
    want = attention_chunked(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                             jv.transpose(0, 2, 1, 3), causal=False,
                             block_k=blk)
    got = fops.attention(tq.transpose(1, 2), tk.transpose(1, 2),
                         tv.transpose(1, 2), causal=False)
    assert rel_err(to_np(got), want) < tol(dt)


#: the two cross-attention models' kernel shapes (llama-3.2-vision-11b:
#: 32 over 8 heads of 128, a 1601-row memory; seamless-m4t-medium: 16
#: heads of 64, G 1, 1024 frames): flash (self causal, cross and encoder
#: not causal, cross as the model's strided views), Sk about 1601's 64-
#: and 128-row tiles, and not causal with S > Sk
CROSS_FLASH = [(8, 32, 8, 512, 1601, 128, False, True),
               (8, 16, 16, 1024, 1024, 64, False, False),
               (8, 16, 16, 512, 512, 64, True, False),
               (8, 16, 16, 512, 1024, 64, False, True),
               (2, 8, 2, 128, 1535, 128, False, False),
               (2, 8, 2, 128, 1537, 128, False, True),
               (2, 8, 2, 128, 1599, 128, False, False),
               (2, 8, 2, 128, 1602, 128, False, True),
               (2, 8, 2, 300, 129, 128, False, False)]
#: decode over a memory, every length M, at G 4 and G 1
CROSS_DECODE = [(8, 32, 8, 1601, 128), (8, 16, 16, 1024, 64),
                (8, 16, 16, 1601, 64), (8, 32, 8, 1024, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_kernels_at_the_cross_attention_shapes(dt):
    """Run on a card only: both kernels against their plain versions at
    the cross-attention models' shapes (``chip_smoke.py`` phase 7e)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "mode (their plain versions are held to the reference "
                    "above and in tests/test_torch_cross.py)")
    rng = np.random.default_rng(21)
    td = DTYPES[dt][1]

    def dev(shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(
            device="cuda", dtype=td)
    for b, hq, hkv, s, sk, d, causal, views in CROSS_FLASH:
        if views:
            q = dev((b, s, hq, d)).transpose(1, 2)
            k, v = (dev((b, sk, hkv, d)).transpose(1, 2) for _ in range(2))
        else:
            q, k, v = dev((b, hq, s, d)), dev((b, hkv, sk, d)), dev(
                (b, hkv, sk, d))
        got = fops.attention(q, k, v, causal=causal)
        want = fref.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert rel_err(to_np(got), to_np(want)) < tol(dt)
    for b, hq, hkv, m, d in CROSS_DECODE:
        q = dev((b, hq, d))
        k, v = dev((b, m, hkv, d)), dev((b, m, hkv, d))
        lengths = torch.full((b,), m, dtype=torch.int32, device="cuda")
        got = dops.decode_attention(q, k, v, lengths)
        want = dref.decode_attention_ref(q, k, v, lengths)
        torch.cuda.synchronize()
        assert rel_err(to_np(got), to_np(want)) < tol(dt)
