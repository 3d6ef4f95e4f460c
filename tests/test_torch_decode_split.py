"""The split-S structure of the port's decode-attention kernel, on the CPU.

``decode_attention_split_ref`` computes what the CUDA kernel's two stages
compute -- a partial ``(m, l, acc)`` per split of cache rows, then their
log-sum-exp combine -- and is held here to the one-pass plain version
``decode_attention_ref`` and to the reference's Pallas kernel in
interpret mode, on numpy-seeded inputs.  Tolerance: the reference's
``tol(dtype)`` on ``rel_err`` (5e-5 f32, summation order; 2.5e-2 bf16,
the output rounded to bf16).  Also: ``split_plan`` (shapes only, every
row covered once, whole tiles, enough CTAs to fill the card) and the
kernel build's cache key, which must change with a header beside the
source.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import (
    decode_attention_pallas)
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention import ref as dref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
H100_SMS = 132


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def tol(dt: str) -> float:
    return 2.5e-2 if dt == "bf16" else 5e-5


def inputs(seed, b, hq, hkv, s, d, q_dt, kv_dt):
    rng = np.random.default_rng(seed)
    qa = rng.standard_normal((b, hq, d))
    ka = rng.standard_normal((b, s, hkv, d))
    va = rng.standard_normal((b, s, hkv, d))
    conv = []
    for a, dt in ((qa, q_dt), (ka, kv_dt), (va, kv_dt)):
        jd, td = DTYPES[dt]
        conv.append((jnp.asarray(a, jd),
                     torch.from_numpy(np.asarray(a, np.float32)).to(td)))
    return conv


# (b, hq, hkv, s, d, lengths, rows_per_split): lengths 0 and 1, lengths
# on, one before and one after a split boundary, splits wholly past the
# length, G in {1, 4, 8}, D in {64, 96, 128}
SPLIT = [
    (3, 4, 4, 200, 64, [0, 1, 200], 64),           # G 1
    (3, 16, 4, 256, 128, [128, 127, 129], 64),     # G 4, on a boundary
    (2, 16, 2, 300, 96, [64, 5], 128),             # G 8, most splits empty
    (3, 8, 1, 384, 64, [256, 255, 257], 128),      # G 8, boundaries
    (2, 8, 2, 130, 128, [130, 0], 64),             # ragged last split
    (1, 4, 1, 64, 96, [64], 64),                   # one split
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,s,d,lengths,rps", SPLIT)
def test_split_ref_matches_the_plain_version_and_pallas(b, hq, hkv, s, d,
                                                        lengths, rps, dt):
    (jq, tq), (jk, tk), (jv, tv) = inputs(b * 7 + s + d, b, hq, hkv, s, d,
                                          dt, dt)
    la = np.asarray(lengths, np.int32)
    tl = torch.from_numpy(la)
    out = dref.decode_attention_split_ref(tq, tk, tv, tl, rps)
    assert out.dtype == DTYPES[dt][1] and out.shape == tq.shape
    plain = dref.decode_attention_ref(tq, tk, tv, tl)
    assert rel_err(out.float(), plain.float()) < tol(dt)
    pallas = decode_attention_pallas(jq, jk, jv, jnp.asarray(la),
                                     block_s=math.gcd(s, 32), interpret=True)
    assert rel_err(out.float(), pallas) < tol(dt)
    zero = la == 0
    assert bool((out[torch.from_numpy(zero)] == 0).all())


def test_split_ref_f32_query_over_bf16_cache():
    """An f32 model keeps a bf16 cache, as the reference does."""
    (jq, tq), (jk, tk), (jv, tv) = inputs(3, 2, 8, 2, 200, 64, "f32",
                                          "bf16")
    la = np.asarray([200, 65], np.int32)
    out = dref.decode_attention_split_ref(tq, tk, tv, torch.from_numpy(la),
                                          64)
    assert out.dtype == torch.float32
    pallas = decode_attention_pallas(jq, jk, jv, jnp.asarray(la),
                                     block_s=8, interpret=True)
    assert rel_err(out, pallas) < 5e-5
    assert rel_err(out, dref.decode_attention_ref(
        tq, tk, tv, torch.from_numpy(la))) < 5e-5


def test_split_ref_ignores_rows_past_length():
    (_, tq), (_, tk), (_, tv) = inputs(8, 2, 8, 2, 256, 64, "f32", "f32")
    lengths = torch.tensor([70, 129], dtype=torch.int32)
    out = dref.decode_attention_split_ref(tq, tk, tv, lengths, 64)
    k2, v2 = tk.clone(), tv.clone()
    k2[0, 70:], v2[0, 70:] = 999.0, -999.0
    k2[1, 129:], v2[1, 129:] = 999.0, -999.0
    assert torch.equal(dref.decode_attention_split_ref(tq, k2, v2, lengths,
                                                       64), out)


# --------------------------------------------------------------------- #
# the split plan
# --------------------------------------------------------------------- #
PLAN_SHAPES = [(8, 8, s, H100_SMS) for s in (1, 63, 64, 65, 128, 129, 200,
                                             544, 1000, 2080, 4097, 32768)]
PLAN_SHAPES += [(1, 1, 5, H100_SMS), (64, 8, 2080, H100_SMS),
                (2, 4, 700, 114), (1, 8, 131072, H100_SMS)]


@pytest.mark.parametrize("b,hkv,s,n_sm", PLAN_SHAPES)
def test_split_plan_covers_every_row_once_in_whole_tiles(b, hkv, s, n_sm):
    rps, n_split = dops.split_plan(b, hkv, s, n_sm)
    assert isinstance(rps, int) and isinstance(n_split, int)
    assert rps % dops.TILE == 0 and rps >= dops.TILE
    assert 1 <= n_split <= dops.MAX_SPLITS
    # the splits [i * rps, (i + 1) * rps) cover [0, s) and none is
    # wholly past the cache
    assert n_split * rps >= s and (n_split - 1) * rps < s
    tiles = -(-s // dops.TILE)
    if b == hkv == 8 and n_sm == H100_SMS and tiles >= 3:
        # at least one CTA per SM wherever the cache has the tiles for it
        assert b * hkv * n_split >= H100_SMS


def test_split_plan_of_the_serving_paths():
    """Granite's decode (544 rows) and the Jamba cut's (2080), B 8, Hkv
    8 on an H100: 9 splits of 64 rows = 576 CTAs; 17 of 128 = 1088."""
    assert dops.split_plan(8, 8, 544, H100_SMS) == (64, 9)
    assert dops.split_plan(8, 8, 2080, H100_SMS) == (128, 17)
    # a large batch fills the card with fewer splits
    assert dops.split_plan(64, 8, 2080, H100_SMS)[1] == 3


def test_split_plan_reads_shapes_only():
    """The plan takes four integers and nothing else: the lengths, a
    device tensor, never reach it, so a decode step costs no host
    sync."""
    params = inspect.signature(dops.split_plan).parameters
    assert list(params) == ["b", "hkv", "s", "n_sm"]
    src = inspect.getsource(dops.split_plan)
    for word in ("lengths", ".item", ".cpu", "tolist"):
        assert word not in src.split('"""')[2]


@pytest.mark.parametrize("b,hq,hkv,s,d", [(2, 8, 2, 300, 64),
                                          (3, 16, 8, 544, 128)])
def test_split_ref_at_the_planned_split(b, hq, hkv, s, d):
    """The plan's rows_per_split gives the plain version's answer."""
    (_, tq), (_, tk), (_, tv) = inputs(s, b, hq, hkv, s, d, "f32", "f32")
    lengths = torch.tensor([s, 1, 65][:b], dtype=torch.int32)
    rps, _ = dops.split_plan(b, hkv, s, H100_SMS)
    out = dref.decode_attention_split_ref(tq, tk, tv, lengths, rps)
    assert rel_err(out, dref.decode_attention_ref(tq, tk, tv,
                                                  lengths)) < 5e-5


# --------------------------------------------------------------------- #
# the build's cache key
# --------------------------------------------------------------------- #
def test_library_path_changes_with_a_header_beside_the_source(tmp_path):
    src = tmp_path / "csrc" / "kern.cu"
    src.parent.mkdir()
    src.write_text('#include "common.cuh"\nextern "C" int f() { return 0; }\n')
    header = src.parent / "common.cuh"
    header.write_text("#define X 1\n")
    first = _build.library_path(src)
    assert first == _build.library_path(src)           # stable
    header.write_text("#define X 2\n")
    second = _build.library_path(src)
    assert second != first
    (src.parent / "other.h").write_text("int y;\n")
    assert _build.library_path(src) not in (first, second)
    assert second.parent == _build.BUILD_DIR and second.name.startswith(
        "kern-")


def test_parse_ptxas_reads_registers_and_spills():
    text = ("ptxas info    : Compiling entry function '_Z6kernelv' for "
            "'sm_90a'\n"
            "ptxas info    : Function properties for _Z6kernelv\n"
            "    16 bytes stack frame, 8 bytes spill stores, 12 bytes "
            "spill loads\n"
            "ptxas info    : Used 168 registers, used 1 barriers, 1024 "
            "bytes smem, 464 bytes cmem[0]\n")
    assert _build.parse_ptxas(text) == {"_Z6kernelv": {
        "spill_stores": 8, "spill_loads": 12, "registers": 168,
        "smem": 1024}}
