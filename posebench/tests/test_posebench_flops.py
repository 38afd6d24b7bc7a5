"""The benchmark's operation and byte counts against hand counts at small
shapes, and against torch's own FLOP counter run over the plain model."""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from posebench import flops as F
from posebench.harness import data
from posebench.reference import model as R
from posebench.reference.spec import ModelShape

SHAPE = ModelShape(hidden=64, layers=2, heads=2, mlp_ratio=4, patch=14, pos_grid=37, eps=1e-6,
                   keypoints=24, heatmap=48, lora_rank=8, lora_alpha=16.0, lora_dropout=0.1,
                   z_dropout=0.1, z_hidden=(1024, 512, 256), head_grid_at_init=16)


def test_product_by_hand():
    # (2 x 3) @ (3 x 4): 2*2*3*4 FLOPs; bytes bf16 (6 + 12 + 8) * 2.
    assert F._product(2, 3, 4) == (48, 52)
    assert F._product(2, 3, 4, out_bytes=4) == (48, 2 * 18 + 32)


def test_block_and_attention_by_hand():
    t, d, h = 10, 8, 32
    assert sum(2 * m * k * n for m, k, n in F.block_forward_products(t, d, h)) == 24 * t * d * d
    s = (28 // 14) ** 2 + 1                      # 5 tokens at 28^2
    fwd, bwd = F.attention_work(SHAPE, {"unfreeze_last_n_layers": 1}, 3, 28, train=True)
    assert fwd == [(4 * 3 * s * s * 64, 4 * 3 * s * 64 * 2)] * 2
    assert bwd == [(8 * 3 * s * s * 64, 8 * 3 * s * 64 * 2)]
    assert F.attention_work(SHAPE, {"use_lora": True}, 3, 28, train=True)[1] == []


def test_gemm_work_counts_no_recompute():
    t = 2 * 257
    fwd = F.gemm_work(SHAPE, {}, 2, 224, train=False)
    assert sum(f for f, _ in fwd) == 2 * 24 * t * 64 * 64
    lora = F.gemm_work(SHAPE, {"use_lora": True}, 2, 224, train=True)
    assert sum(f for f, _ in lora) - sum(f for f, _ in fwd) == 2 * 2 * t * 64 * 256
    # Each unfrozen block's dx and dW, 2 * 24 t d^2, but the lowest one's
    # qkv dx, 2 t d 3d: nothing trainable lies below it.
    for n in (1, 2):
        unf = F.gemm_work(SHAPE, {"unfreeze_last_n_layers": n}, 2, 224, train=True)
        assert (sum(f for f, _ in unf) - sum(f for f, _ in fwd)
                == n * 2 * 24 * t * 64 * 64 - 2 * t * 64 * 192)


def test_bound_takes_the_larger():
    assert F.bound_s(989e12, 0) == pytest.approx(1.0)
    assert F.bound_s(0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("size", [224, 504])
def test_forward_matches_torch_flop_counter(size):
    """A forward of the plain model, counted by torch, equals model_flops
    less the bilinear resize (torch counts no interpolation)."""
    W = data.weights(SHAPE, {}, 7, "cpu")
    model = R.PoseModel(W, SHAPE, {}, R.Precision("f32"))
    x = torch.randn(2, 3, size, size)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.forward(x)
    heads, resize = F.heads_flops(SHAPE, size // 14)
    assert counter.get_total_flops() == F.model_flops(SHAPE, {}, 2, size, train=False) - 2 * resize


def test_lora_forward_adds_the_adapter():
    shape = dataclasses.replace(SHAPE)
    diff = (F.model_flops(shape, {"use_lora": True}, 2, 224, train=False)
            - F.model_flops(shape, {}, 2, 224, train=False))
    assert diff == 2 * 2 * (2 * 257) * 64 * 8
