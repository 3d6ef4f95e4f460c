"""Attention's output projection ``wo`` and the dense FFNs' down projection
(``w_down``, and ``w_out`` of the GELU MLP) go through
``shards.row_parallel``.

* Unplaced, it is ``a @ w`` as before: a whole prefill and decode steps
  of reduced models (self-attention with a SwiGLU FFN, cross-attention
  with a GELU MLP and an encoder, Mamba with attention) in f32 and bf16
  give the same logits and caches, bit for bit, as the same run with
  ``row_parallel`` replaced by the plain product.
* Placed on (data 2, model 2) on four gloo processes, in bf16 at reduced
  widths: every ``wo`` / ``w_down`` product whose input is split along
  the contraction equals, bit for bit, the two ``model`` ranks' f32
  partial products summed in f32 and rounded once; bf16 partials (each
  rounded, then summed in bf16, the product it replaces) differ from
  that on some outputs.

The ranks import ``repro_torch`` alone (``tests/_dist_moe_workers.py``).
"""

import numpy as np
import pytest
import torch

import _dist_moe_workers as MW
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import shards
from repro_torch.models import transformer as T

#: the reduced archs the unplaced check runs: wo + SwiGLU, cross + GELU
#: MLP + encoder, Mamba + attention + SwiGLU
UNPLACED = ("granite-3-8b", "seamless-m4t-medium", "jamba-1.5-large-398b")
TIMEOUT_S = 240.0


def run(cfg, model, prompt, steps, memory=None):
    """Prefill and ``steps`` decode steps on the plain paths: every
    logits tensor and the caches after the last step."""
    b, s = prompt.shape
    caches = T.init_caches(cfg, b, s + steps, device="cpu",
                           memory_len=0 if memory is None
                           else memory.shape[1],
                           memory_dtype=torch.promote_types(
                               torch.bfloat16, model.embed.dtype))
    with torch.no_grad():
        lg, caches = T.forward_prefill(model, cfg, prompt, caches,
                                       memory=memory, attn_impl="ref",
                                       ssm_impl="ref")
        outs = [lg]
        for i in range(steps):
            lg, caches = T.forward_decode(
                model, cfg, torch.full((b,), i + 1, dtype=torch.int32),
                caches, torch.full((b,), s + i, dtype=torch.int32),
                attn_impl="ref")
            outs.append(lg)
    return outs, caches


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("arch", UNPLACED)
def test_unplaced_outputs_are_the_plain_products_bit_for_bit(
        arch, dtype, monkeypatch):
    cfg = get_arch(arch).reduced()
    model = serve.build(cfg, seed=5, device="cpu", dtype=dtype)
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9))
                              .astype(np.int64))
    memory = None
    if cfg.encoder_layers or "cross" in cfg.pattern:
        memory = torch.from_numpy(rng.standard_normal(
            (2, 7, cfg.d_model)).astype(np.float32)).to(dtype)
    got, got_caches = run(cfg, model, prompt, 3, memory)
    products = []

    def plain(a, w, groups=()):
        assert not groups
        products.append(tuple(w.shape))
        return a @ w
    monkeypatch.setattr(shards, "row_parallel", plain)
    want, want_caches = run(cfg, model, prompt, 3, memory)
    assert products, "no wo / w_down product went through row_parallel"
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert sorted(got_caches) == sorted(want_caches)
    for name in got_caches:
        assert torch.equal(got_caches[name], want_caches[name]), name


@pytest.mark.parametrize("shape", ((5, 8, 12), (3, 4, 6, 8)))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
def test_row_parallel_without_groups_is_the_product(shape, dtype):
    g = torch.Generator().manual_seed(1)
    a = torch.randn(shape, generator=g).to(dtype)
    w = torch.randn(shape[-1], 7, generator=g).to(dtype)
    assert torch.equal(shards.row_parallel(a, w), a @ w)


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    prompt = np.random.default_rng(2).integers(
        0, get_arch("granite-3-8b").reduced().vocab, (4, 8)).astype(np.int64)
    return run_ranks(MW.placed_row_products, 4, "granite-3-8b", 3, prompt,
                     work_dir=str(tmp_path_factory.mktemp("rowpar")),
                     timeout_s=TIMEOUT_S)


def test_placed_wo_and_w_down_sum_f32_partials_rounded_once(placed):
    calls = [c for rank in placed for c in rank]
    split = [c for c in calls if c["split"]]
    kinds = {c["weight"].rsplit(".", 1)[-1] for c in split}
    # 2 layers x (wo + w_down), prefill and one decode step, on 4 ranks
    assert kinds == {"wo", "w_down"}, calls
    assert len(split) == 4 * 2 * 2 * 2, calls
    assert all(c["split"] == ["model"] and c["dtype"] == "torch.bfloat16"
               for c in split), split
    assert all(c["equal"] for c in split), [c for c in split
                                            if not c["equal"]]
    # the product this replaces rounds twice and differs on some outputs
    assert max(c["bf16_partials_differ"] for c in split) > 0, split
