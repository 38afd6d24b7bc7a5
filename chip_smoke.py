"""Chip smoke test of the PyTorch/H100 port: build the CUDA kernels, hold each
against its plain PyTorch version (first the chains' three GEMM kernels
alone, forward, dx and weight-gradient products, at every dinov2 product
shape, timed beside torch.matmul; then the chains' attention step alone,
the resident pair and the streamed one, at every dinov2 head count, timed
beside scaled_dot_product_attention), serve dinov2-small + LoRA pose requests
through the kernels, drive the port's five other CLIs (model_info,
export_coreml, demo, benchmark_model, compare_models) on a checkpoint of
that model with their exact launches, take dinov2-small fine-tuning steps
at batch 128 through them (LoRA, and unfreeze-last-4 with whole blocks
training), all at 224²; then the long-sequence paths at 504² (S = 1297),
where every layer streams its attention through the flash kernels:
serving, and unfreeze-last-4 steps
at batch 32; then dinov2-small + LoRA from pretrained DINOv2 weights in a
local Hugging Face hub cache that the script writes itself (nothing is
downloaded; every other phase builds its weights from a seed and sees an
empty cache): the load bit-equal to the cache, serving, a LoRA step and one
``cli.train`` epoch on those weights, an empty cache's warning and a
checkpoint's reload that reads no cache; then dinov2-base and -large at
504² (their kernels at S = 1297 and the flash pair at 12 and 16 heads,
serving, and unfreeze-last-4 steps at batch 32); then FastViT serving at 256²: fastvit_t8 + LoRA r=8 (10
ConvFFN kernel launches a forward), fastvit_sa12 (12 ConvFFN launches and
2 flash forwards, its attention stage), fastvit_ma36 + LoRA r=8 (36
ConvFFN launches, stages 0 and 1 at C = 76 and 152 zero-padded to the
kernel's multiples of 16, and 6 flash forwards), fastvit_sa24 (24 and 4)
and fastvit_sa36 (36 and 6); then FastViT LoRA fine-tuning at
256²: fastvit_t8 + LoRA r=8 at batch 128 (10 ConvFFN forward and 10
backward launches a step), fastvit_sa12 + LoRA r=8 at batch 32 (12 and
12, and 2 flash forwards and backwards) and fastvit_ma36 + LoRA r=8 at
batch 32 (36 and 36, 6 and 6); then JAX's FastViT fold switches, each for
its phases only: DINO_POSE_TPU_FASTVIT_FOLD=0 (t8 + LoRA and sa12 served,
the t8 step), DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS=branch (the t8 step) and
DINO_POSE_TPU_FASTVIT_TRAIN_FFN=fold (the sa12 step), every kernel held
on the path's own tensors; then the bigger dinov2 backbones at
224²: each forward kernel of their block routes and fused_mlp_dx at
dinov2-base's and dinov2-large's widths at batch 1, 8 and 128, dinov2-base
+ LoRA serving and fine-tuning at batch 128 (the resident kernels, 11/1/1
a forward), dinov2-large + LoRA r=8 on layer 23 serving and fine-tuning at
batch 128 (24 launches each of the weight-streamed halves a forward, and
the LoRA layer's dx kernel in the backward), each step's kernels held on
its own tensors and the backbone's LoRA gradients alone at batch 128; then
unfreeze-last-4 fine-tuning of both at batch 128, whose four trainable
blocks take the weight-streamed training halves (the streamed MLP half that
also saves h2, and the streamed backward chains of both halves: their
kernels held at both widths at batch 1, 8 and 128 and on each step's own
tensors, and the backbone's trainable-block gradients alone at batch 128);
then FastViT's two opt-in kernel arms (JAX's DINO_POSE_TPU_DWCONV and
DINO_POSE_TPU_STAGE_PAIR, set to ``on`` for those phases only): the
depthwise conv, the combine + conv segment forward and backward and the
ConvFFN with the block residual held at t8's stage 0 and 1 shapes (and
ragged H) at batch 1, 8 and 128, fastvit_t8 + LoRA serving with the conv
arm (4 depthwise-conv and 10 ConvFFN launches a forward), and its LoRA
fine-tuning at batch 128 with both arms (the pair in stages 0-1), and
with both arms under DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS=fold (no pair
launch: the pair needs the reuse form); then the
tensor-parallel slice: each shard's kernels (the attention and MLP halves'
partial products and the LoRA layer's partial dx) at dinov2-base's shard
shapes (tp = 2) and dinov2-large's (tp = 2 and 4), dinov2-base + LoRA r=8
under a ('data', 'model') = (1, 2) mesh on the one card, serving (24 + 24
shard launches a forward) and fine-tuning at batch 128 (and the LoRA
layer's partial dx on both shards); then FastViT under the same mesh:
the ConvFFN kernels and the flash pair at every t8/sa12 shard width (H/2,
8 heads), fastvit_t8 + LoRA and fastvit_sa12 + LoRA served and fine-tuned
with every ConvFFN as two shards (two ConvFFN launches a layer) and held
against their one-card route, and the MLP-variant heads in bf16 against
the CPU in f32; then the final LayerNorm's kernel
(JAX's DINO_POSE_TPU_LN=pallas) against its plain version and
torch.nn.functional.layer_norm, and dinov2-small, -base and -large + LoRA
serving and fine-tuning with that switch on; last, the training entry point
(``python -m dino_pose_tpu_torch.cli.train``'s ``main``) on a seeded
COCO-format set: two epochs of the default configuration with their
launches, files and PCKh gate, the final checkpoint reloaded and served
bit-equal, an auto-resumed third epoch and a device-warp epoch; then
multi-process training on the one card (phase_dist): two ranks as
processes of this script under torchrun's launch variables, gloo with CUDA
tensors, dinov2-small and fastvit_t8 + LoRA steps of 2 x 64 against one
process of 128, ``cli.train`` on two ranks against phase_fit's run and its
resume, dinov2-base + LoRA with its model axis across the two ranks
bit-equal to the one-card route, ``fit`` with a (1, 2) mesh across the two
ranks (dinov2-base and fastvit_sa12 + LoRA) bit-equal to the same mesh in
one process, ``fit`` with a (2, 2) mesh across four ranks (dinov2-small +
LoRA), and a world of one under NCCL. Times kernels, serving and every train
step; the ConvFFN, depthwise-conv and LayerNorm kernels, and cuDNN's
grouped conv and torch.nn.functional.layer_norm beside them, on three
clocks (host-inclusive, device-only from a CUDA graph's replay, host
microseconds a call), the ConvFFN kernels beside the replaced WMMA ones'
(OLD_CONVFFN), the combine + conv segment's kernels beside the replaced ones'
(OLD_DWPAIR) and an unfused library yardstick.

    python3 chip_smoke.py [--out results.json] [--profile]
    python3 chip_smoke.py --ab-parent DIR [--ab-steps t8|unfreeze_504] [--out ab.json]
    python3 chip_smoke.py --flash-only [--out flash.json]
    python3 chip_smoke.py --ab-flash DIR [--out ab.json]

(``--dist-worker SPEC`` is how phase_dist starts its ranks.)

The third form only holds and times the streamed attention pair
(phase_flash at dinov2-small's, -base's and -large's widths), then the
chains' attention step on both routes across the resident route's range of
S (flash_crossover). The fourth times the flash phase's wall seconds,
after a warm-up, against the tree at DIR, parent, change, change, parent,
each a fresh process.

The second form only times the fastvit_t8 + LoRA bs=128 train step on the
kernel path, default and with both opt-in arms on (with ``--ab-steps
unfreeze_504``: the dinov2-small and -large unfreeze-last-4 steps at 504²,
bs=32), against the tree at DIR (e.g. ``git archive`` of the parent
commit), each arm in a fresh process from its own tree, in turns parent,
change, change, parent on one card.

Needs one CUDA card and ``nvcc``; exits non-zero without a card, when a
kernel does not build, launch or agree, or when any phase fails. The last
line of standard output is ``{"ok": true, "device": {...}}``; the line before
it is the card's ``nvidia-smi`` name and power limit, and before that the
per-kernel JSON line. Weights are random (from a seed), so only agreement
between paths is checked, not pose accuracy. f32 products on the card run in
full f32: TF32 is switched off for matmuls and cuDNN convolutions.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 0
D, H, S, HIDDEN, EPS = 384, 6, 257, 1536, 1e-6
# bf16 tolerance of one block, kernel vs plain: both round every product to
# bf16 (8-bit mantissa), but in another summation order, so single roundings
# flip by one ulp (2^-8 relative); 3e-2 abs/rel is the JAX suite's own bf16
# tolerance for the fused block (tests/test_block_kernel.py).
KERNEL_ATOL = KERNEL_RTOL = 3e-2
# The attention alone — flash_attention's o, dq, dk, dv, and fused_attn_part's
# output, which adds no residual — is held tighter: values there are ~0.04
# (a softmax over ~500 keys), so 3e-2 would pass a kernel that drops the
# ragged last key tile's row-sum share or uses a stale rowsum(P*dP).
# Elementwise within ATTN_ATOL + ATTN_RTOL*|ref| (an H100 measured at most
# 0.00195 on the flash outputs, 0.0039 on fused_attn_part's), and in
# relative Frobenius norm, which catches a bias in the row sum of under 1%
# that no elementwise bf16 limit can: the flash outputs within FLASH_FRO
# (measured at most 1.5e-4), fused_attn_part's, which adds the rounding of
# two GEMMs, within ATTN_FRO (measured at most 1.42e-3).
ATTN_ATOL, ATTN_RTOL, FLASH_FRO, ATTN_FRO = 4e-3, 2e-2, 5e-4, 3e-3
# Whole model, kernels vs plain, bf16: twelve blocks and the heads compound
# those one-ulp flips, so outputs are held to 5% of their largest magnitude.
MODEL_REL_TOL = 5e-2
# Keypoints: an argmax over near-tied peaks of a random-weight model can move
# under one flip, so at least 75% of keypoints must agree within one heatmap
# cell (image size / 48 px: 4.67 px at 224², 10.5 px at 504², 5.33 px at
# 256²). A keypoint whose plain heatmap holds, more than one cell from its
# peak, a value within one bf16 ulp of that peak is a tie no bf16 path can
# order (random-weight fastvit_sa12's heatmaps have their top 50 cells within
# 0.4% of the peak); such keypoints are counted and left out of the share.
KP_AGREE = 0.75
# Train steps, kernels vs plain, bf16 at batch 128: the losses are means over
# 7M heatmap elements and 3072 z values, so one-ulp flips average out; they
# are held to 1e-3 relative (they agree to 1.1e-4 over three steps on an
# H100). The step-1 gradients are held to the bf16 noise of the plain path,
# measured in the same run against a plain f32 step from the same weights and
# dropout masks: the LoRA and first-head-conv gradients are sums over 32896
# tokens (or 32768 positions) that the BatchNorm after them nearly cancels,
# so bf16 rounding alone moves them 12-20% from f32 on either path. Each
# gradient's error vs f32 on the kernel path, and its distance from the plain
# path, must stay within GRAD_NOISE_FACTOR times the plain path's error vs
# f32, plus GRAD_NOISE_SLACK for gradients that bf16 barely moves. On an H100
# the largest of those ratios is 0.99 (LoRA B: kernels 0.2021 vs f32, plain
# 0.2039), so 1.25 leaves a quarter for run-to-run noise. The dx kernel
# itself is held tighter on the step's own tensors: the x2, cotangent dy and
# weights that reach it in the first step, against mlp_dx_math at the
# kernel tolerance scaled by max|dy| (the real cotangent is ~1e-4).
LOSS_RTOL = 1e-3
GRAD_NOISE_FACTOR, GRAD_NOISE_SLACK = 1.25, 2e-3
# The trainable block's backward kernels against their plain versions: dx
# (and y, x2) at the kernel tolerance above (measured: 0.03125 at most, one
# bf16 ulp of values in [4, 8)); each weight gradient, an f32 sum over B*S
# rows of bf16-rounded terms in another order, elementwise within GRAD_TOL
# of its largest magnitude: 2.4 times the largest ratio an H100 measured at
# batch 1, 8 and 128 and on the train step's own tensors (8.3e-4).
GRAD_TOL = 2e-3
TRAIN_BATCH, TRAIN_STEPS, LR = 128, 3, 3e-5
# The long-sequence paths: dinov2-small at 504² input, a 36x36 patch grid,
# S = 1297 (bench.py --image-size 504); the unfreeze step at batch 32 (41504
# token rows, about the 32896 of the 224²/bs=128 step), two checked steps.
LONG_IMAGE, S_LONG, LONG_BATCH, LONG_STEPS = 504, 1297, 32, 2
FLASH_BATCHES = (1, 8, LONG_BATCH)
LORA_CONFIG = {"model_name": "facebook/dinov2-small", "use_lora": True}
UNFREEZE_CONFIG = {"model_name": "facebook/dinov2-small", "use_lora": False,
                   "unfreeze_last_n_layers": 4}


def lora_grad_names(layer: int) -> tuple:
    """The LoRA matrices of ``layer`` and two head convs."""
    return (f"backbone.encoder.layer.{layer}.attention.lora_output.lora_A",
            f"backbone.encoder.layer.{layer}.attention.lora_output.lora_B",
            "pose_heads.heatmap_head.feature_refine.0.weight",
            "pose_heads.heatmap_head.prediction.3.weight")


LORA_GRAD_NAMES = lora_grad_names(11)


def unfreeze_grad_names(top: int) -> tuple:
    """MLP leaves of the top layer, attention leaves of the lowest of the
    four trainable ones, and the heads' first conv."""
    first = f"backbone.encoder.layer.{top - 3}."
    return (*(f"backbone.encoder.layer.{top}.{leaf}" for leaf in (
        "mlp.fc1.weight", "mlp.fc2.bias", "layer_scale2.lambda1", "norm2.weight")),
            *(first + leaf for leaf in (
                "attention.attention.query.weight", "attention.output.dense.bias",
                "layer_scale1.lambda1", "norm1.weight")),
            "pose_heads.heatmap_head.feature_refine.0.weight")


UNFREEZE_GRAD_NAMES = unfreeze_grad_names(11)
# Launches of each wrapper per forward or step on each path (the others 0:
# no flash launch at 224², where the chains keep K and V resident: one
# resident attention forward per layer, attn_fwd, and per trainable layer a
# recomputed forward and a backward pair, attn_bwd, in fused_attn_bwd). At
# 504² every attention streams: one flash forward per layer, and per
# trainable layer a recomputed forward and a backward pair.
SERVING_LAUNCHES = {"fused_block": 11, "fused_attn_part": 1, "fused_mlp_part": 1, "attn_fwd": 12}
LORA_LAUNCHES = {**SERVING_LAUNCHES, "fused_mlp_dx": 1}
UNFREEZE_LAUNCHES = {"fused_block": 8, "fused_block_train": 4, "fused_mlp_bwd": 4,
                     "fused_attn_bwd": 4, "attn_fwd": 16, "attn_bwd": 4}
SERVING_504_LAUNCHES = {**SERVING_LAUNCHES, "attn_fwd": 0, "flash_fwd": 12}
UNFREEZE_504_LAUNCHES = {**UNFREEZE_LAUNCHES, "attn_fwd": 0, "attn_bwd": 0, "flash_fwd": 16,
                         "flash_bwd": 4}
# The bigger dinov2 backbones at 504² (S = 1297): every block takes the
# "math" route there (ops/block.block_route), whose chains stream their
# attention through the flash kernels: a frozen block fused_block, the LoRA
# layer its two halves, a trainable block block_train (fused_block_train,
# backward fused_mlp_bwd + fused_attn_bwd), each with one flash forward, a
# trainable one also with its recomputed forward and a flash backward in
# the backward. Serving dinov2-base and -large + LoRA r=8 on the last layer
# (seeded arrays, batch 1 and 8) and their unfreeze-last-4 step at batch 32
# (bench.py --image-size 504), two checked steps and three timed each way.
LONG_WIDE_LAYERS = {"dinov2-base": 12, "dinov2-large": 24}


def serving_504_launches(layers: int) -> dict:
    return {"fused_block": layers - 1, "fused_attn_part": 1, "fused_mlp_part": 1,
            "flash_fwd": layers}


def unfreeze_504_launches(layers: int) -> dict:
    return {"fused_block": layers - 4, "fused_block_train": 4, "fused_mlp_bwd": 4,
            "fused_attn_bwd": 4, "flash_fwd": layers + 4, "flash_bwd": 4}


UNFREEZE_504_WIDE_RECORDED = ("fused_block", "fused_block_train", "fused_mlp_bwd",
                              "fused_attn_bwd")
# FastViT serving at 256² (timm's input size): t8 + LoRA r=8, the family's
# default model, and sa12, whose last stage is attention. Launches per forward:
# one ConvFFN kernel per block (depths 2/2/4/2 and 2/2/6/2), one flash
# forward per attention block.
T8_CONFIG = {"model_name": "timm/fastvit_t8.apple_in1k", "use_lora": True}
SA12_CONFIG = {"model_name": "timm/fastvit_sa12.apple_in1k"}
SERVING_T8_LAUNCHES = {"fused_convffn": 10}
SERVING_SA12_LAUNCHES = {"fused_convffn": 12, "flash_fwd": 2}
# fastvit_ma36 + LoRA r=8 at 256² (depths 6/6/18/6, C = 76-608): one ConvFFN
# kernel per block (stages 0 and 1 zero-padded from C = 76 and 152 to
# multiples of 16 around the launch), one flash forward per attention block
# of stage 3 (19 heads of 32 over the 8x8 grid).
MA36_CONFIG = {"model_name": "timm/fastvit_ma36.apple_in1k", "use_lora": True}
SERVING_MA36_LAUNCHES = {"fused_convffn": 36, "flash_fwd": 6}
# FastViT LoRA fine-tuning at 256² (bench.py's FastViT cell: t8 + LoRA r=8 at
# bs=128; sa12 + LoRA r=8 at bs=32, two checked steps, three timed). Every
# ConvFFN runs its forward kernel and, in the backward, its backward kernel;
# sa12's two attention blocks their flash forward and backward. The LoRA
# dropout (0.1) draws the same masks on both paths (the step's generator).
T8_TRAIN_BATCH, SA12_TRAIN_BATCH, FASTVIT_IMAGE = 128, 32, 256
SA12_LORA_CONFIG = {**SA12_CONFIG, "use_lora": True}
T8_TRAIN_LAUNCHES = {"fused_convffn": 10, "fused_convffn_bwd": 10}
SA12_TRAIN_LAUNCHES = {"fused_convffn": 12, "fused_convffn_bwd": 12, "flash_fwd": 2,
                       "flash_bwd": 2}
# The FastViT attention shapes at 256², (heads, S, dh) over stage 3's 8x8
# grid, that phase_flash holds at B = 1, 8, 32: sa12's (sa24's, sa36's),
# which it also times, and ma36's 19 heads of 32.
FASTVIT_FLASH_SHAPES = {"fastvit_sa12": (16, 64, 32), "fastvit_ma36": (19, 64, 32)}
# (S, heads, dh) of the streamed pair on the chains' packed qkv (B, S, 3D)
# at a ragged S past the resident limits whose last tile holds neither 0
# nor 64 rows (1300 = 20 * 64 + 20), at both head widths, B = 2.
FLASH_PACKED = ((1300, 6, 64), (1300, 12, 32))
# fastvit_sa24 and sa36 serving at 256² (as sa12: no LoRA; depths 4/4/12/4
# and 6/6/18/6): one ConvFFN kernel a block, one flash forward a block of
# the attention stage (16 heads of 32 over the 8x8 grid), a forward.
SA24_CONFIG = {"model_name": "timm/fastvit_sa24.apple_in1k"}
SA36_CONFIG = {"model_name": "timm/fastvit_sa36.apple_in1k"}
SERVING_SA24_LAUNCHES = {"fused_convffn": 24, "flash_fwd": 4}
SERVING_SA36_LAUNCHES = {"fused_convffn": 36, "flash_fwd": 6}
FASTVIT_SERVING_RECORDED = ("fused_convffn", "flash_fwd")
# fastvit_ma36 + LoRA r=8 fine-tuning at bs=32 (sa12's train batch; two
# checked steps, three timed): 36 ConvFFN forward and backward launches a
# step, stages 0-1 zero-padded from C = 76 and 152 around each launch, and 6
# flash forwards and backwards (19 heads of 32). Held: stage 0's first block
# (padded), stage 1's first (padded), the last block and the heads.
MA36_TRAIN_BATCH = 32
MA36_TRAIN_LAUNCHES = {"fused_convffn": 36, "fused_convffn_bwd": 36, "flash_fwd": 6,
                       "flash_bwd": 6}
MA36_GRAD_NAMES = (
    "backbone.stages.0.blocks.0.mlp.fc1.lora_A.weight",
    "backbone.stages.0.blocks.0.mlp.fc1.lora_B.weight",
    "backbone.stages.1.blocks.0.mlp.fc2.lora_A.weight",
    "backbone.stages.3.blocks.5.mlp.fc2.lora_A.weight",
    "backbone.stages.3.blocks.5.mlp.fc2.lora_B.weight",
    "backbone.head.heatmap_head.feature_refine.0.weight",
)
# JAX's FastViT fold switches, each arm for its phases only (gates): a.
# FASTVIT_FOLD=0, the branch math in eval (t8 + LoRA and sa12 served; the
# launches as by default: every ConvFFN keeps its kernel) and in training
# (the t8 + LoRA bs=128 step); b. TRAIN_BLOCKS=branch (the t8 step); c.
# TRAIN_BLOCKS=fold with both opt-in arms on (the t8 step): the stage pair
# needs the reuse form, so the pair kernels launch 0 times; the conv arm
# takes only the ConvFFN 7x7 of stages 0-1 (a folded block's conv is JAX's
# lax.conv), 4 forward and the dx of the 3 whose input carries a gradient;
# d. TRAIN_FFN=fold (the sa12 + LoRA bs=32 step: the statistics as one-pass
# moments, the attention's BatchNorm folded into qkv). Two checked steps
# and three timed in each.
FOLD0 = {"DINO_POSE_TPU_FASTVIT_FOLD": "0"}
BLOCKS_BRANCH = {"DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS": "branch"}
FFN_FOLD = {"DINO_POSE_TPU_FASTVIT_TRAIN_FFN": "fold"}
T8_FOLD_ARMS_LAUNCHES = {"fused_dw_conv": 4 + 3, "fused_convffn": 10, "fused_convffn_bwd": 10}
ARM_STEPS, ARM_TIMED = 2, 3
# The first and the last ConvFFN's adapters (t8 and sa12 both end with two
# blocks) and the heads' first conv.
FASTVIT_GRAD_NAMES = (
    "backbone.stages.0.blocks.0.mlp.fc1.lora_A.weight",
    "backbone.stages.0.blocks.0.mlp.fc1.lora_B.weight",
    "backbone.stages.3.blocks.1.mlp.fc2.lora_A.weight",
    "backbone.stages.3.blocks.1.mlp.fc2.lora_B.weight",
    "backbone.head.heatmap_head.feature_refine.0.weight",
)
# Each ConvFFN's (C, H, S at 256², blocks per forward): t8 with LoRA r=8 and
# real masks in the kernel check (the serving path runs ones), sa12 with rank 0
# (rank-1 zero adapters).
CONVFFN_STAGES = {
    "t8": [(48, 144, 4096, 2), (96, 288, 1024, 2), (192, 576, 256, 4), (384, 1152, 64, 2)],
    "sa12": [(64, 256, 4096, 2), (128, 512, 1024, 2), (256, 1024, 256, 6), (512, 2048, 64, 2)],
    "ma36": [(76, 304, 4096, 6), (152, 608, 1024, 6), (304, 1216, 256, 18), (608, 2432, 64, 6)],
}
CONVFFN_RANK = {"t8": 8, "sa12": 0, "ma36": 8}
# The bigger dinov2 backbones at 224² (models/vit.py VIT_PRESETS): LoRA r=8
# on the last layer, as the registry builds them. Their block route is JAX's
# single-device TPU dispatch (ops/block.block_route): dinov2-base the
# resident kernels (11 fused_block, the LoRA layer's two halves),
# dinov2-large the weight-streamed halves in all 24 layers. Fine-tuning at
# bs=128 (bench.py --model facebook/dinov2-large), two checked steps and
# three timed each way.
WIDE = {"dinov2-base": (768, 12, 3072), "dinov2-large": (1024, 16, 4096)}
BASE_LORA_CONFIG = {"model_name": "facebook/dinov2-base", "use_lora": True}
LARGE_LORA_CONFIG = {"model_name": "facebook/dinov2-large", "use_lora": True}
SERVING_LARGE_LAUNCHES = {"fused_attn_part_stream": 24, "fused_mlp_part_stream": 24,
                          "attn_fwd": 24}
LARGE_LORA_LAUNCHES = {**SERVING_LARGE_LAUNCHES, "fused_mlp_dx": 1}
WIDE_STEPS, WIDE_TIMED = 2, 3
# Their step-1 LoRA gradients are sums that the heads' BatchNorms nearly
# cancel, so bf16 rounding alone moves them 12-32% from f32 on either path,
# by an amount that changes from batch to batch. The wide phases take the
# step-1 gradients of three seeded batches (the steps' own and two more)
# and hold every batch's kernel-path error to its limit. dinov2-base's
# ratios kernels/plain against f32 read 0.96-1.11 on an H100, inside the
# 1.25 of the other phases. dinov2-large's LoRA A read 1.36, 0.91 and 0.67
# on the three batches, with the kernel path as far from the plain one
# (0.236) as the plain one from f32 (0.235): at this width the step's
# gradient check is bound by that noise and cannot tell a slightly wrong
# kernel from a right one. Its limit, LARGE_GRAD_NOISE_FACTOR, sits just
# above the largest reading. What holds the kernels of the wide paths
# tightly is the backbone's LoRA gradients alone under a seeded cotangent
# at the step's batch (bf16 moves them ~1%, within GRAD_NOISE_FACTOR of
# plain's), and every kernel of the path on the step's own tensors.
WIDE_GRAD_BATCHES, LARGE_GRAD_NOISE_FACTOR = 3, 1.5
BASE_RECORDED = ("fused_block", "fused_attn_part", "fused_mlp_part", "fused_mlp_dx")
LARGE_RECORDED = ("fused_attn_part_stream", "fused_mlp_part_stream", "fused_mlp_dx")
# Their unfreeze-last-4 fine-tuning at bs=128 (bench.py --model
# facebook/dinov2-large --no_lora: unfreeze_last_n_layers=4), full depth. A
# trainable block of either takes JAX's weight-streamed training route
# (block_route(..., training=True) == "stream"): fused_attn_part_stream ->
# the bf16 stitch -> fused_mlp_part_stream_train, backward
# fused_mlp_bwd_stream then fused_attn_bwd_stream. Frozen layers as served:
# large's 20 through the streamed halves, base's 8 through fused_block.
BASE_UNFREEZE_CONFIG = {"model_name": "facebook/dinov2-base", "use_lora": False,
                        "unfreeze_last_n_layers": 4}
LARGE_UNFREEZE_CONFIG = {**BASE_UNFREEZE_CONFIG, "model_name": "facebook/dinov2-large"}
STREAM_TRAIN = ("fused_mlp_part_stream_train", "fused_mlp_bwd_stream", "fused_attn_bwd_stream")
STREAM_TRAIN_LAUNCHES = {"fused_attn_part_stream": 4, **dict.fromkeys(STREAM_TRAIN, 4),
                         "attn_fwd": 8, "attn_bwd": 4}
BASE_UNFREEZE_LAUNCHES = {"fused_block": 8, **STREAM_TRAIN_LAUNCHES, "attn_fwd": 16}
LARGE_UNFREEZE_LAUNCHES = {**STREAM_TRAIN_LAUNCHES, "fused_attn_part_stream": 24,
                           "fused_mlp_part_stream": 20, "attn_fwd": 28}
BASE_UNFREEZE_RECORDED = ("fused_block", "fused_attn_part_stream", *STREAM_TRAIN)
LARGE_UNFREEZE_RECORDED = ("fused_attn_part_stream", "fused_mlp_part_stream", *STREAM_TRAIN)
# Outputs that add no residual (output indices): the streamed MLP half's
# pre-LayerScale h2 and the streamed attention backward's dx. Their values,
# ~0.05-1, are where the elementwise 3e-2 holds little, so they are also
# held in relative Frobenius norm to ATTN_FRO. Not to the attention half's
# elementwise 4e-3 + 2e-2*|ref|: a row whose LayerNorm output rounds the
# other way in one element moves many of the row's bf16 hidden values by
# one ulp, and their sum moves an output of any size by more than 4e-3 (an
# H100 put one h2 element of the dinov2-base B=128 check outside it, with
# the rel Frobenius error at 1.9e-4).
NO_RESIDUAL = {"fused_mlp_part_stream_train": (1,), "fused_attn_bwd_stream": (0,)}
BLOCK_SOURCE = "dino_pose_tpu_torch/ops/csrc/block_kernels.cu"
FLASH_SOURCE = "dino_pose_tpu_torch/ops/csrc/flash_kernels.cu"
CONVFFN_SOURCE = "dino_pose_tpu_torch/ops/csrc/convffn_kernels.cu"
DWCONV_SOURCE = "dino_pose_tpu_torch/ops/csrc/dwconv_kernels.cu"
# FastViT's opt-in arms, JAX's own switches at "on": its TPU shape-and-fit
# window, which at 256² takes t8's stages 0 and 1 (C = 48 at 64², 96 at
# 32²). Serving with the conv arm: each of those stages' ConvFFN 7x7 convs
# (the RepMixers fold into one conv in eval). The LoRA step with both arms:
# the four blocks of stages 0-1 run as the pair (their mixers' 3x3 branch
# through the conv arm, the combine + 7x7 segment, the ConvFFN with the
# residual), stages 2-3 as before; in the backward the segment's and the
# mixer conv's dx run in the three pair blocks whose input carries a
# gradient (stage 0's first block input does not).
ARMS = {"DINO_POSE_TPU_DWCONV": "on", "DINO_POSE_TPU_STAGE_PAIR": "on"}
SERVING_T8_DW_LAUNCHES = {"fused_convffn": 10, "fused_dw_conv": 4}
T8_PAIR_LAUNCHES = {"fused_dw_conv": 4 + 3, "fused_combine_dw": 4, "fused_convffn_res": 4,
                    "fused_convffn": 6, "fused_combine_dw_bwd": 3, "fused_convffn_bwd": 10}
T8_PAIR_RECORDED = ("fused_dw_conv", "fused_combine_dw", "fused_combine_dw_bwd",
                    "fused_convffn_res", "fused_convffn_bwd")
# Arm c of the fold switches (FOLD0 above): TRAIN_BLOCKS=fold with both arms.
BLOCKS_FOLD_ARMS = {**ARMS, "DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS": "fold"}
# The arms' t8 stages at 256²: (C, H = W, ConvFFN hidden, launches of a
# serving forward's 7x7 conv, of a step's segment forward and of its
# backward), and ragged rows (H = 24, 56) held but not on the path.
ARM_STAGES = [(48, 64, 144, 2, 2, 1), (96, 32, 288, 2, 2, 2)]
ARM_RAGGED = [(48, 24), (96, 56)]
# The tensor-parallel slice: dinov2-base + LoRA r=8 at 224² under a
# ('data', 'model') = (1, 2) mesh whose two model shards live on the one
# card (core/mesh.py): every block takes JAX's Megatron halves, each shard's
# kernel launched in rank order on its slice of the weights, the partials
# summed by the mesh. Per forward 12 layers x 2 shards of each half; per
# LoRA step also the LoRA layer's partial dx on both shards. The shard
# kernels are held at dinov2-base's shard shapes (D = 768, 6 heads and an
# MLP width of 1536 a shard) and dinov2-large's (D = 1024 at tp 2 and 4).
TP = 2
TP_SHAPES = {"dinov2-base": (768, 12, 3072, 2), "dinov2-large": (1024, 16, 4096, 2),
             "dinov2-large-tp4": (1024, 16, 4096, 4)}
TP_SHARD = ("fused_attn_part_partial", "fused_mlp_part_partial", "fused_mlp_partial_dx")
SERVING_TP_LAUNCHES = {"fused_attn_part_partial": 24, "fused_mlp_part_partial": 24,
                       "attn_fwd": 24}
TP_LORA_LAUNCHES = {**SERVING_TP_LAUNCHES, "fused_mlp_partial_dx": 2}
# FastViT under the same (1, 2) mesh (models/fastvit.py): every ConvFFN runs
# as two shards of H/2 hidden units (t8: 72 to 576, the 72 zero-padded to
# 80; sa12: 128 to 1024), each its own fused_convffn launch (and in a step
# fused_convffn_bwd), the partials summed by the mesh and fc2's bias added
# once; sa12's two attention blocks as two shards of 8 heads, a flash launch
# each. So every layer launches tp kernels where one card launches one:
# t8 + LoRA r=8 served at B = 1 and 8 and trained at bs=128, sa12 + LoRA r=8
# served and trained at bs=32 (two checked steps, three timed). Each is also
# held against the same model's one-card route (tp = 1) on the kernels: its
# forward and its step-1 LoRA gradients.
T8_TP_SERVING = {"fused_convffn": 2 * 10}
T8_TP_TRAIN = {"fused_convffn": 2 * 10, "fused_convffn_bwd": 2 * 10}
SA12_TP_SERVING = {"fused_convffn": 2 * 12, "flash_fwd": 2 * 2}
SA12_TP_TRAIN = {"fused_convffn": 2 * 12, "fused_convffn_bwd": 2 * 12, "flash_fwd": 2 * 2,
                 "flash_bwd": 2 * 2}
SA12_TP_FLASH_SHAPE = (16 // TP, 64, 32)
# The MLP-variant heads (models/heads.PoseHeads; no model uses them) on the
# card in bf16 against the CPU in f32, at heatmap 48 and at 40 (the chain
# overshoots to 48 and pools back), on dinov2-base-wide feature vectors.
MLP_HEADS_FEATURES, MLP_HEADS_BATCH = 768, 8
# The final LayerNorm's kernel behind JAX's DINO_POSE_TPU_LN=pallas, on
# dinov2-small + LoRA (the gate's home, nn/layers.py:246-250): one launch a
# forward on top of the path's own; held at the serving forward's (257, 384)
# rows and the step's (128*257, D) for dinov2-small's, -base's and -large's
# widths, bf16 and f32.
LN_GATE = {"DINO_POSE_TPU_LN": "pallas"}
SERVING_LN_LAUNCHES = {**SERVING_LAUNCHES, "fused_layernorm": 1}
LORA_LN_LAUNCHES = {**LORA_LAUNCHES, "fused_layernorm": 1}
# The same gate on dinov2-base (D = 768, the resident route) and -large
# (D = 1024, the weight-streamed halves) + LoRA r=8 at 224²: serving and the
# bs=128 LoRA step, one fused_layernorm launch a forward at their widths,
# each step followed by the backbone's LoRA gradients alone (the final
# LayerNorm's kernel in its forward). dinov2-large's step-1 LoRA A gradient
# is the bf16 noise of a sum the heads' BatchNorms nearly cancel
# (LARGE_GRAD_NOISE_FACTOR): with the gate on, an H100 read its kernel path
# 1.596 times as far from f32 as the plain path, with the kernel path 0.29
# from the plain one and the plain one 0.24 from f32, every wrapper of the
# step within tolerance on its own tensors. There it is held by the
# backbone-alone gradients (within GRAD_NOISE_FACTOR), not by the step's.
LN_WIDE = {
    "dinov2-base": ("ln_base", BASE_LORA_CONFIG, {**SERVING_LAUNCHES, "fused_layernorm": 1},
                    {**LORA_LAUNCHES, "fused_layernorm": 1}, lora_grad_names(11),
                    GRAD_NOISE_FACTOR),
    "dinov2-large": ("ln_large", LARGE_LORA_CONFIG, {**SERVING_LARGE_LAUNCHES,
                                                     "fused_layernorm": 1},
                     {**LARGE_LORA_LAUNCHES, "fused_layernorm": 1}, lora_grad_names(23)[1:],
                     LARGE_GRAD_NOISE_FACTOR),
}
LN_CASES = [(S, D), (TRAIN_BATCH * S, D), (TRAIN_BATCH * S, 768), (TRAIN_BATCH * S, 1024)]
# The library call's three clocks beside a kernel's (``clocks``), where one
# PyTorch call computes the kernel's function (rows 24 and 27).
LIBRARY_CLOCKS = ("library_ms", "library_device_ms", "library_host_us")
LN_SOURCE = "dino_pose_tpu_torch/ops/csrc/layernorm_kernels.cu"
# phase_fit's dataset: train and validation images (batch 32: 4 steps and one
# validation batch an epoch).
FIT_TRAIN, FIT_VAL = 128, 32
# Steps timed alone after the fit runs, on one batch kept on the card.
FIT_ALONE = 10
# fit's per-epoch history: seconds, images/s and the StepTimer's split.
EPOCH_KEYS = ("epoch_seconds", "images_per_sec", "input_wait_s", "dispatch_s", "drain_s")
# The five other CLIs (phase_cli) on dinov2-small + LoRA r=8 at full width:
# a forward of a registry name without LoRA launches 12 fused_block; a
# fastvit_t8 forward 10 fused_convffn. benchmark_model's warm-up and timed
# forwards, compare_models' iterations (its device-time adds 3 warm-up and
# as many timed forward + decode calls), the demo's frames and their batch.
SMALL_LAUNCHES = {"fused_block": 12, "attn_fwd": 12}
CLI_BENCH_WARMUP, CLI_BENCH_ITERS, CLI_COMPARE_ITERS = 3, 20, 10
CLI_FRAMES, CLI_FRAME_BATCH = 10, 8
# The chains' GEMM alone (phase_gemm, ops/block.fused_gemm): every product
# shape the driven dinov2 paths run, (D, MLP width, tp) per model: qkv (K =
# D, N = 3D/tp), the out-projection (K = D/tp, N = D), fc1 (K = D, N =
# 4D/tp) and fc2 (K = 4D/tp, N = D), each with the epilogues its chains put
# on it, at M = B*257 for B = 1, 8, 128 and a ragged M = 2*57.
GEMM_MODELS = {"dinov2-small": (384, 1536, 1), "dinov2-base": (768, 3072, 1),
               "dinov2-large": (1024, 4096, 1), "dinov2-base tp2": (768, 3072, 2),
               "dinov2-large tp2": (1024, 4096, 2), "dinov2-large tp4": (1024, 4096, 4)}
GEMM_EPIS = {
    "qkv": (("bias",), ("bias",)),
    "out": (("bias", "bias_ls_res", "f32bias"), ("none",)),
    "fc1": (("bias_gelu", "bias_gelu_pair", "bias"), ("bias_gelu", "bias")),
    "fc2": (("bias_ls_res", "f32bias_ls_res", "f32bias_ls_res_h2", "bias"), ("none",)),
}
GEMM_ROWS = (S, 8 * S, TRAIN_BATCH * S, 2 * 57)
# The replaced mma.sync flash kernels' three clocks (ms, device ms, host us)
# at each phase_flash shape, forward and backward, measured by this script
# on an H100 80GB HBM3 at 700.00 W before the wgmma kernels took their
# place; printed beside the new kernels' (at sa12's shape, device ms alone).
OLD_FLASH = {
    "dinov2-small B=1 fwd": (0.0340, 0.0322, 24.9),
    "dinov2-small B=1 bwd": (0.0878, 0.0828, 78.9),
    "dinov2-small B=8 fwd": (0.1312, 0.1287, 47.8),
    "dinov2-small B=8 bwd": (0.4354, 0.4274, 65.9),
    "dinov2-small B=32 fwd": (0.5101, 0.4979, 50.6),
    "dinov2-small B=32 bwd": (1.5703, 1.5825, 86.4),
    "dinov2-base B=1 fwd": (0.0532, 0.0441, 52.3),
    "dinov2-base B=1 bwd": (0.1240, 0.1174, 107.9),
    "dinov2-base B=8 fwd": (0.2559, 0.2506, 60.4),
    "dinov2-base B=8 bwd": (0.8301, 0.8159, 105.4),
    "dinov2-base B=32 fwd": (1.0167, 0.9972, 59.4),
    "dinov2-base B=32 bwd": (3.0760, 3.0462, 84.2),
    "dinov2-large B=1 fwd": (0.0604, 0.0572, 52.2),
    "dinov2-large B=1 bwd": (0.1880, 0.1837, 68.3),
    "dinov2-large B=8 fwd": (0.3614, 0.3537, 61.5),
    "dinov2-large B=8 bwd": (1.0831, 1.0698, 56.5),
    "dinov2-large B=32 fwd": (1.3543, 1.3462, 60.3),
    "dinov2-large B=32 bwd": (4.0809, 4.1241, 118.9),
    "fastvit_sa12 B=1 fwd": (0.0509, 0.0033, 48.1),
    "fastvit_sa12 B=1 bwd": (0.0911, 0.0085, 90.2),
    "fastvit_sa12 B=8 fwd": (0.0813, 0.0035, 79.8),
    "fastvit_sa12 B=8 bwd": (0.0700, 0.0090, 84.5),
    "fastvit_sa12 B=32 fwd": (0.0656, 0.0080, 64.1),
    "fastvit_sa12 B=32 bwd": (0.0578, 0.0171, 58.5),
}
# The chains' attention step at S = 257, head width 64 (phase_attention_core):
# the resident pair against the streamed flash pair at each driven model's
# heads a call (dinov2-small, -base and -large, and the shards' H/tp), B = 1,
# 8, 128; and the ragged S at which both routes are held against their plain
# versions (the resident route's limits, S = 304 and 320 at head width 64).
ROUTE_HEADS = {"dinov2-small": 6, "dinov2-base": 12, "dinov2-base tp2": 6, "dinov2-large": 16,
               "dinov2-large tp2": 8, "dinov2-large tp4": 4}
ATTN_CORE_SEQS = (1, 63, 65, 200, 257, 304, 320)
# The replaced WMMA attention kernels' three clocks (ms, device ms, host us)
# at each ROUTE_HEADS shape and batch, forward and backward, measured by this
# script on an H100 80GB HBM3 at 700.00 W before the wgmma kernels took
# their place; printed beside the new kernels'.
OLD_ATTN = {
    "dinov2-small B=1 fwd": (0.0332, 0.0308, 18.5),
    "dinov2-small B=1 bwd": (0.0919, 0.0883, 30.3),
    "dinov2-small B=8 fwd": (0.0635, 0.0607, 38.7),
    "dinov2-small B=8 bwd": (0.1762, 0.1712, 64.7),
    "dinov2-small B=128 fwd": (0.9941, 0.9694, 28.8),
    "dinov2-small B=128 bwd": (2.8009, 2.7170, 87.9),
    "dinov2-base B=1 fwd": (0.0348, 0.0307, 33.0),
    "dinov2-base B=1 bwd": (0.0917, 0.0874, 60.0),
    "dinov2-base B=8 fwd": (0.1218, 0.1201, 26.5),
    "dinov2-base B=8 bwd": (0.3462, 0.3362, 60.7),
    "dinov2-base B=128 fwd": (1.9671, 1.9040, 33.7),
    "dinov2-base B=128 bwd": (5.4417, 5.4079, 52.4),
    "dinov2-base tp2 B=1 fwd": (0.0323, 0.0305, 22.5),
    "dinov2-base tp2 B=1 bwd": (0.0914, 0.0881, 37.5),
    "dinov2-base tp2 B=8 fwd": (0.0624, 0.0605, 24.2),
    "dinov2-base tp2 B=8 bwd": (0.1741, 0.1704, 40.5),
    "dinov2-base tp2 B=128 fwd": (1.0015, 0.9698, 45.1),
    "dinov2-base tp2 B=128 bwd": (2.8001, 2.7155, 78.7),
    "dinov2-large B=1 fwd": (0.0328, 0.0308, 27.8),
    "dinov2-large B=1 bwd": (0.0921, 0.0862, 133.4),
    "dinov2-large B=8 fwd": (0.1529, 0.1511, 22.9),
    "dinov2-large B=8 bwd": (0.4451, 0.4336, 42.4),
    "dinov2-large B=128 fwd": (2.6064, 2.5399, 38.3),
    "dinov2-large B=128 bwd": (7.2125, 7.1829, 45.7),
    "dinov2-large tp2 B=1 fwd": (0.0336, 0.0308, 35.8),
    "dinov2-large tp2 B=1 bwd": (0.0926, 0.0887, 43.0),
    "dinov2-large tp2 B=8 fwd": (0.0918, 0.0899, 22.7),
    "dinov2-large tp2 B=8 bwd": (0.2570, 0.2519, 39.6),
    "dinov2-large tp2 B=128 fwd": (1.3308, 1.2828, 40.9),
    "dinov2-large tp2 B=128 bwd": (3.7094, 3.6230, 73.6),
    "dinov2-large tp4 B=1 fwd": (0.0334, 0.0304, 22.5),
    "dinov2-large tp4 B=1 bwd": (0.0904, 0.0866, 42.5),
    "dinov2-large tp4 B=8 fwd": (0.0621, 0.0602, 25.6),
    "dinov2-large tp4 B=8 bwd": (0.1715, 0.1669, 41.8),
    "dinov2-large tp4 B=128 fwd": (0.6808, 0.6595, 46.5),
    "dinov2-large tp4 B=128 bwd": (1.9016, 1.8363, 98.2),
}
# The replaced WMMA gemm_kernel's three clocks (ms, device ms, host us) at
# each EPI_NONE shape and each M of GEMM_ROWS, measured by this script on an
# H100 80GB HBM3 at 700.00 W before the wgmma kernel took its place;
# printed beside the new kernel's.
OLD_GEMM = {
    "dinov2-small qkv": ((0.0418, 0.0179, 39.5), (0.0258, 0.0235, 23.5),
                        (0.3660, 0.3583, 36.5), (0.0254, 0.0179, 24.0)),
    "dinov2-small out": ((0.0328, 0.0183, 34.5), (0.0263, 0.0189, 25.2),
                        (0.1388, 0.1336, 33.8), (0.0296, 0.0180, 23.3)),
    "dinov2-small fc1": ((0.0268, 0.0180, 24.5), (0.0419, 0.0390, 38.5),
                        (0.4933, 0.4778, 47.0), (0.0325, 0.0180, 34.3)),
    "dinov2-small fc2": ((0.0652, 0.0628, 24.0), (0.0669, 0.0645, 30.2),
                        (0.5357, 0.5156, 43.9), (0.0653, 0.0617, 23.3)),
    "dinov2-base qkv": ((0.0350, 0.0328, 41.1), (0.0843, 0.0812, 36.8),
                       (1.3469, 1.3094, 44.2), (0.0348, 0.0325, 24.2)),
    "dinov2-base out": ((0.0350, 0.0323, 26.5), (0.0393, 0.0367, 33.6),
                       (0.4810, 0.4744, 29.8), (0.0393, 0.0332, 37.0)),
    "dinov2-base fc1": ((0.0358, 0.0335, 24.5), (0.1148, 0.1122, 26.6),
                       (1.8008, 1.7592, 31.6), (0.0348, 0.0324, 24.3)),
    "dinov2-base fc2": ((0.1210, 0.1180, 24.8), (0.1371, 0.1337, 30.5),
                       (2.1010, 2.0642, 25.7), (0.1284, 0.1219, 24.9)),
    "dinov2-large qkv": ((0.0456, 0.0432, 39.3), (0.1582, 0.1614, 22.8),
                        (2.3381, 2.3001, 35.1), (0.0436, 0.0414, 25.5)),
    "dinov2-large out": ((0.0440, 0.0418, 21.3), (0.0529, 0.0503, 33.6),
                        (0.8044, 0.7860, 38.6), (0.0469, 0.0435, 39.5)),
    "dinov2-large fc1": ((0.0473, 0.0448, 24.8), (0.2127, 0.2099, 24.2),
                        (2.9697, 2.9382, 29.4), (0.0461, 0.0416, 43.3)),
    "dinov2-large fc2": ((0.1576, 0.1546, 24.9), (0.2166, 0.2432, 42.0),
                        (3.6682, 3.6262, 26.3), (0.1701, 0.1634, 34.1)),
    "dinov2-base tp2 qkv": ((0.0345, 0.0322, 24.7), (0.0450, 0.0419, 38.4),
                           (0.6806, 0.6753, 26.0), (0.0356, 0.0335, 23.0)),
    "dinov2-base tp2 out": ((0.0245, 0.0181, 23.1), (0.0261, 0.0205, 26.3),
                           (0.2630, 0.2548, 25.7), (0.0242, 0.0179, 22.3)),
    "dinov2-base tp2 fc1": ((0.0345, 0.0320, 25.4), (0.0759, 0.0726, 44.8),
                           (0.9121, 0.8917, 27.5), (0.0367, 0.0324, 25.0)),
    "dinov2-base tp2 fc2": ((0.0642, 0.0617, 35.5), (0.0725, 0.0693, 39.2),
                           (0.9315, 0.9210, 27.2), (0.0659, 0.0635, 25.6)),
    "dinov2-large tp2 qkv": ((0.0448, 0.0414, 39.8), (0.0996, 0.0963, 24.4),
                            (1.1865, 1.1667, 23.8), (0.0447, 0.0425, 26.7)),
    "dinov2-large tp2 out": ((0.0280, 0.0228, 37.1), (0.0381, 0.0273, 38.5),
                            (0.4350, 0.4265, 43.7), (0.0382, 0.0234, 40.2)),
    "dinov2-large tp2 fc1": ((0.0552, 0.0427, 44.7), (0.1085, 0.1046, 28.6),
                            (1.5380, 1.5312, 43.4), (0.0443, 0.0418, 28.4)),
    "dinov2-large tp2 fc2": ((0.0837, 0.0795, 27.7), (0.0985, 0.0958, 29.5),
                            (1.5778, 1.5561, 29.0), (0.0868, 0.0843, 25.7)),
    "dinov2-large tp4 qkv": ((0.0442, 0.0419, 27.8), (0.0506, 0.0473, 26.9),
                            (0.6370, 0.6200, 49.9), (0.0447, 0.0422, 26.2)),
    "dinov2-large tp4 out": ((0.0427, 0.0133, 41.1), (0.0264, 0.0160, 24.0),
                            (0.2342, 0.2297, 24.3), (0.0241, 0.0130, 23.5)),
    "dinov2-large tp4 fc1": ((0.0435, 0.0413, 23.2), (0.0526, 0.0496, 22.8),
                            (0.8058, 0.7922, 43.5), (0.0460, 0.0435, 25.0)),
    "dinov2-large tp4 fc2": ((0.0438, 0.0413, 25.6), (0.0575, 0.0501, 48.9),
                            (0.8017, 0.7902, 24.7), (0.0450, 0.0423, 25.3)),
}
# The chains' backward products alone (phase_gemm_bwd, ops/block.fused_gemm_nt
# and fused_gemm_tn): every backward product shape the driven paths run, per
# model (D, MLP width, tp): gemm_nt dh1b (K = D, N = 4D/tp, *gelu'(h1)), dm
# (K = 4D/tp, N = D, f32), dctx (K = N = D, bf16), da (K = 3D, N = D, f32);
# gemm_tn dW1 (K_in = D, N = 4D), dW2 (K_in = 4D, N = D), dWqkv with dbqkv's
# column sums (K_in = D, N = 3D), dWo (K_in = N = D). A shard's dx chain
# (#22) runs only dh1b and dm. Each product is checked in every form its
# chains give it (the scaled cotangent, the column sums) and timed in the
# first form listed (no scale) at GEMM_ROWS, dinov2-small also at the 504²
# step's 32*1297 rows.
GEMM_BWD_MODELS = {"dinov2-small": (384, 1536, 1), "dinov2-base": (768, 3072, 1),
                   "dinov2-large": (1024, 4096, 1), "dinov2-base tp2": (768, 3072, 2),
                   "dinov2-large tp2": (1024, 4096, 2)}
# Per product: (kind, K or K_in, N) from (D, MLP width / tp) and its forms.
GEMM_BWD_PRODUCTS = {
    "dh1b": ("nt", lambda d, h: (d, h), ({"epi": "gelu_grad", "colsum": True},
                                         {"epi": "gelu_grad", "colsum": True, "scale": True},
                                         {"epi": "gelu_grad", "scale": True})),
    "dm": ("nt", lambda d, h: (h, d), ({"epi": "f32"},)),
    "dctx": ("nt", lambda d, h: (d, d), ({"epi": "bf16"}, {"epi": "bf16", "scale": True})),
    "da": ("nt", lambda d, h: (3 * d, d), ({"epi": "f32"},)),
    "dW1": ("tn", lambda d, h: (d, h), ({},)),
    "dW2": ("tn", lambda d, h: (h, d), ({}, {"scale": True})),
    "dWqkv": ("tn", lambda d, h: (d, 3 * d), ({"gsum": True},)),
    "dWo": ("tn", lambda d, h: (d, d), ({}, {"scale": True})),
}
GEMM_BWD_SHARD = (({"epi": "gelu_grad"},), ({"epi": "f32"},))
# The replaced WMMA gemm_nt_kernel's and gemm_tn_kernel's three clocks (ms,
# device ms, host us) in each product's timed form, by "<model> <product>
# M=<rows>", measured by this script on an H100 80GB HBM3 at 700.00 W before
# the wgmma kernels took their place; printed beside the new kernels'.
OLD_GEMM_BWD = {
    "dinov2-small dh1b M=257": (0.0458, 0.0258, 39.6),
    "dinov2-small dh1b M=2056": (0.0410, 0.0375, 29.8),
    "dinov2-small dh1b M=32896": (0.7036, 0.6854, 52.2),
    "dinov2-small dh1b M=114": (0.0342, 0.0257, 31.2),
    "dinov2-small dh1b M=41504": (0.8717, 0.8589, 30.8),
    "dinov2-small dm M=257": (0.0636, 0.0615, 28.0),
    "dinov2-small dm M=2056": (0.0679, 0.0658, 17.6),
    "dinov2-small dm M=32896": (0.4678, 0.4575, 26.8),
    "dinov2-small dm M=114": (0.0622, 0.0612, 20.1),
    "dinov2-small dm M=41504": (0.5859, 0.5768, 19.3),
    "dinov2-small dctx M=257": (0.0195, 0.0181, 17.2),
    "dinov2-small dctx M=2056": (0.0269, 0.0190, 21.4),
    "dinov2-small dctx M=32896": (0.1164, 0.1122, 18.0),
    "dinov2-small dctx M=114": (0.0192, 0.0174, 17.5),
    "dinov2-small dctx M=41504": (0.1439, 0.1399, 28.6),
    "dinov2-small da M=257": (0.0490, 0.0462, 30.1),
    "dinov2-small da M=2056": (0.0513, 0.0495, 17.6),
    "dinov2-small da M=32896": (0.3516, 0.3453, 17.8),
    "dinov2-small da M=114": (0.0485, 0.0466, 17.4),
    "dinov2-small da M=41504": (0.4430, 0.4397, 25.1),
    "dinov2-small dW1 M=257": (0.0356, 0.0137, 34.7),
    "dinov2-small dW1 M=2056": (0.0403, 0.0362, 36.7),
    "dinov2-small dW1 M=32896": (0.5985, 0.5948, 24.8),
    "dinov2-small dW1 M=114": (0.0341, 0.0108, 33.6),
    "dinov2-small dW1 M=41504": (0.7555, 0.7385, 23.8),
    "dinov2-small dW2 M=257": (0.0287, 0.0137, 28.7),
    "dinov2-small dW2 M=2056": (0.0403, 0.0360, 23.5),
    "dinov2-small dW2 M=32896": (0.6139, 0.6066, 29.8),
    "dinov2-small dW2 M=114": (0.0254, 0.0107, 24.3),
    "dinov2-small dW2 M=41504": (0.7713, 0.7599, 49.4),
    "dinov2-small dWqkv M=257": (0.0528, 0.0139, 53.3),
    "dinov2-small dWqkv M=2056": (0.0371, 0.0325, 35.6),
    "dinov2-small dWqkv M=32896": (0.4826, 0.4748, 33.6),
    "dinov2-small dWqkv M=114": (0.0420, 0.0109, 38.2),
    "dinov2-small dWqkv M=41504": (0.6096, 0.5950, 39.3),
    "dinov2-small dWo M=257": (0.0276, 0.0104, 26.6),
    "dinov2-small dWo M=2056": (0.0383, 0.0173, 38.8),
    "dinov2-small dWo M=32896": (0.1817, 0.1757, 31.9),
    "dinov2-small dWo M=114": (0.0231, 0.0085, 23.3),
    "dinov2-small dWo M=41504": (0.2279, 0.2145, 46.6),
    "dinov2-base dh1b M=257": (0.0491, 0.0422, 46.7),
    "dinov2-base dh1b M=2056": (0.1308, 0.1273, 28.4),
    "dinov2-base dh1b M=32896": (2.0056, 1.9729, 29.8),
    "dinov2-base dh1b M=114": (0.0433, 0.0399, 27.8),
    "dinov2-base dm M=257": (0.1175, 0.1157, 18.1),
    "dinov2-base dm M=2056": (0.1644, 0.1369, 28.3),
    "dinov2-base dm M=32896": (1.6836, 1.6526, 25.4),
    "dinov2-base dm M=114": (0.1223, 0.1235, 19.7),
    "dinov2-base dctx M=257": (0.0336, 0.0312, 28.6),
    "dinov2-base dctx M=2056": (0.0398, 0.0380, 20.4),
    "dinov2-base dctx M=32896": (0.3633, 0.3600, 17.2),
    "dinov2-base dctx M=114": (0.0336, 0.0315, 23.9),
    "dinov2-base da M=257": (0.0890, 0.0868, 24.8),
    "dinov2-base da M=2056": (0.1070, 0.1044, 25.2),
    "dinov2-base da M=32896": (1.2565, 1.2342, 17.6),
    "dinov2-base da M=114": (0.0912, 0.0886, 16.9),
    "dinov2-base dW1 M=257": (0.0301, 0.0245, 23.5),
    "dinov2-base dW1 M=2056": (0.1757, 0.1703, 23.1),
    "dinov2-base dW1 M=32896": (2.6028, 2.5373, 27.6),
    "dinov2-base dW1 M=114": (0.0257, 0.0165, 22.9),
    "dinov2-base dW2 M=257": (0.0281, 0.0254, 23.5),
    "dinov2-base dW2 M=2056": (0.1630, 0.1626, 30.4),
    "dinov2-base dW2 M=32896": (2.6328, 2.5805, 44.3),
    "dinov2-base dW2 M=114": (0.0239, 0.0175, 22.6),
    "dinov2-base dWqkv M=257": (0.0342, 0.0261, 32.0),
    "dinov2-base dWqkv M=2056": (0.1506, 0.1430, 46.9),
    "dinov2-base dWqkv M=32896": (2.4328, 2.3944, 33.4),
    "dinov2-base dWqkv M=114": (0.0826, 0.0158, 84.6),
    "dinov2-base dWo M=257": (0.0371, 0.0138, 36.0),
    "dinov2-base dWo M=2056": (0.0437, 0.0359, 41.4),
    "dinov2-base dWo M=32896": (0.6117, 0.5974, 23.6),
    "dinov2-base dWo M=114": (0.0241, 0.0108, 23.2),
    "dinov2-large dh1b M=257": (0.0573, 0.0537, 41.7),
    "dinov2-large dh1b M=2056": (0.2407, 0.2372, 27.8),
    "dinov2-large dh1b M=32896": (3.2092, 3.1879, 34.9),
    "dinov2-large dh1b M=114": (0.0523, 0.0491, 28.3),
    "dinov2-large dm M=257": (0.1552, 0.1527, 19.1),
    "dinov2-large dm M=2056": (0.2457, 0.2376, 28.7),
    "dinov2-large dm M=32896": (2.8332, 2.8213, 20.2),
    "dinov2-large dm M=114": (0.1644, 0.1596, 18.4),
    "dinov2-large dctx M=257": (0.0425, 0.0404, 19.0),
    "dinov2-large dctx M=2056": (0.0538, 0.0518, 19.7),
    "dinov2-large dctx M=32896": (0.6105, 0.6024, 18.5),
    "dinov2-large dctx M=114": (0.0441, 0.0425, 28.5),
    "dinov2-large da M=257": (0.1180, 0.1154, 26.2),
    "dinov2-large da M=2056": (0.1799, 0.1763, 27.6),
    "dinov2-large da M=32896": (2.1789, 2.1414, 21.6),
    "dinov2-large da M=114": (0.1240, 0.1220, 21.1),
    "dinov2-large dW1 M=257": (0.0446, 0.0412, 26.9),
    "dinov2-large dW1 M=2056": (0.1945, 0.1909, 26.2),
    "dinov2-large dW1 M=32896": (2.7545, 2.7258, 44.9),
    "dinov2-large dW1 M=114": (0.0313, 0.0281, 28.8),
    "dinov2-large dW2 M=257": (0.0441, 0.0403, 43.7),
    "dinov2-large dW2 M=2056": (0.1982, 0.1938, 30.0),
    "dinov2-large dW2 M=32896": (2.7490, 2.7119, 53.0),
    "dinov2-large dW2 M=114": (0.0312, 0.0281, 27.3),
    "dinov2-large dWqkv M=257": (0.0602, 0.0312, 58.7),
    "dinov2-large dWqkv M=2056": (0.1894, 0.1806, 49.6),
    "dinov2-large dWqkv M=32896": (2.6446, 2.5969, 41.3),
    "dinov2-large dWqkv M=114": (0.0609, 0.0217, 55.4),
    "dinov2-large dWo M=257": (0.0271, 0.0162, 37.7),
    "dinov2-large dWo M=2056": (0.0534, 0.0500, 35.0),
    "dinov2-large dWo M=32896": (0.8443, 0.8186, 24.5),
    "dinov2-large dWo M=114": (0.0373, 0.0125, 36.7),
    "dinov2-base tp2 dh1b M=257": (0.0395, 0.0378, 18.0),
    "dinov2-base tp2 dh1b M=2056": (0.0582, 0.0560, 21.3),
    "dinov2-base tp2 dh1b M=32896": (1.0182, 1.0045, 35.3),
    "dinov2-base tp2 dh1b M=114": (0.0406, 0.0381, 17.8),
    "dinov2-base tp2 dm M=257": (0.0612, 0.0593, 19.1),
    "dinov2-base tp2 dm M=2056": (0.0727, 0.0710, 17.9),
    "dinov2-base tp2 dm M=32896": (0.7937, 0.7833, 17.7),
    "dinov2-base tp2 dm M=114": (0.0620, 0.0617, 30.3),
    "dinov2-large tp2 dh1b M=257": (0.0501, 0.0479, 18.8),
    "dinov2-large tp2 dh1b M=2056": (0.1196, 0.1194, 18.0),
    "dinov2-large tp2 dh1b M=32896": (1.6277, 1.6118, 18.9),
    "dinov2-large tp2 dh1b M=114": (0.0490, 0.0465, 26.8),
    "dinov2-large tp2 dm M=257": (0.0793, 0.0772, 20.2),
    "dinov2-large tp2 dm M=2056": (0.1023, 0.0984, 38.0),
    "dinov2-large tp2 dm M=32896": (1.4023, 1.3842, 21.0),
    "dinov2-large tp2 dm M=114": (0.0842, 0.0812, 31.1),
}
# The replaced ConvFFN kernels' three clocks (ms, device ms, host us) at each
# phase_convffn stage shape and batch, forward and backward, and of
# fused_convffn_res at phase_dwconv's t8 stages ("res"), measured by this
# script on an H100 80GB HBM3 at 700.00 W before the wgmma kernels took
# their place (their 32-row WMMA tiles, rank terms on the CUDA cores);
# printed beside the new kernels'.
OLD_CONVFFN = {
    "t8 stage 0 B=1 fwd": (0.0435, 0.0260, 41.3),
    "t8 stage 1 B=1 fwd": (0.0564, 0.0527, 35.3),
    "t8 stage 2 B=1 fwd": (0.1313, 0.1265, 54.8),
    "t8 stage 3 B=1 fwd": (0.3613, 0.3515, 53.5),
    "sa12 stage 0 B=1 fwd": (0.0522, 0.0366, 50.3),
    "sa12 stage 1 B=1 fwd": (0.0863, 0.0839, 35.7),
    "sa12 stage 2 B=1 fwd": (0.2309, 0.2274, 47.2),
    "sa12 stage 3 B=1 fwd": (0.7226, 0.7077, 36.4),
    "ma36 stage 0 B=1 fwd": (0.1681, 0.0808, 164.4),
    "ma36 stage 1 B=1 fwd": (0.1801, 0.1552, 170.4),
    "ma36 stage 2 B=1 fwd": (0.3322, 0.3260, 56.9),
    "ma36 stage 3 B=1 fwd": (0.9889, 0.9659, 55.0),
    "t8 stage 0 B=8 fwd": (0.0923, 0.0884, 32.9),
    "t8 stage 1 B=8 fwd": (0.0643, 0.0633, 54.0),
    "t8 stage 2 B=8 fwd": (0.1332, 0.1302, 37.1),
    "t8 stage 3 B=8 fwd": (0.3618, 0.3548, 45.7),
    "sa12 stage 0 B=8 fwd": (0.1399, 0.1379, 54.7),
    "sa12 stage 1 B=8 fwd": (0.1171, 0.1147, 31.2),
    "sa12 stage 2 B=8 fwd": (0.2394, 0.2327, 57.1),
    "sa12 stage 3 B=8 fwd": (0.7243, 0.7098, 59.2),
    "ma36 stage 0 B=8 fwd": (0.2424, 0.2165, 155.4),
    "ma36 stage 1 B=8 fwd": (0.2152, 0.1833, 168.7),
    "ma36 stage 2 B=8 fwd": (0.3449, 0.3346, 60.6),
    "ma36 stage 3 B=8 fwd": (0.9864, 0.9711, 35.8),
    "t8 stage 0 B=128 fwd": (1.2870, 1.2612, 46.1),
    "t8 stage 1 B=128 fwd": (0.7460, 0.7297, 42.2),
    "t8 stage 2 B=128 fwd": (0.5532, 0.5413, 37.4),
    "t8 stage 3 B=128 fwd": (0.5186, 0.5117, 34.4),
    "sa12 stage 0 B=32 fwd": (0.5863, 0.5737, 31.6),
    "sa12 stage 1 B=32 fwd": (0.3925, 0.3855, 57.6),
    "sa12 stage 2 B=32 fwd": (0.3502, 0.3465, 52.6),
    "sa12 stage 3 B=32 fwd": (0.7725, 0.7575, 56.0),
    "ma36 stage 0 B=32 fwd": (0.8064, 0.7660, 226.5),
    "ma36 stage 1 B=32 fwd": (0.5529, 0.5282, 160.9),
    "ma36 stage 2 B=32 fwd": (0.4378, 0.4262, 57.7),
    "ma36 stage 3 B=32 fwd": (1.0129, 1.0108, 43.2),
    "t8 stage 0 B=1 bwd": (0.0747, 0.0478, 66.0),
    "t8 stage 1 B=1 bwd": (0.1102, 0.1019, 99.4),
    "t8 stage 2 B=1 bwd": (0.2433, 0.2356, 67.7),
    "t8 stage 3 B=1 bwd": (0.6708, 0.6530, 97.5),
    "sa12 stage 0 B=1 bwd": (0.1248, 0.0838, 113.3),
    "sa12 stage 1 B=1 bwd": (0.1809, 0.1742, 110.6),
    "sa12 stage 2 B=1 bwd": (0.4739, 0.4634, 120.8),
    "sa12 stage 3 B=1 bwd": (1.3763, 1.3537, 70.3),
    "ma36 stage 0 B=1 bwd": (0.3723, 0.1340, 358.0),
    "ma36 stage 1 B=1 bwd": (0.3120, 0.2725, 256.5),
    "ma36 stage 2 B=1 bwd": (0.6589, 0.6448, 129.3),
    "ma36 stage 3 B=1 bwd": (2.0480, 2.0160, 217.8),
    "t8 stage 0 B=8 bwd": (0.1974, 0.1906, 71.5),
    "t8 stage 1 B=8 bwd": (0.1376, 0.1314, 67.3),
    "t8 stage 2 B=8 bwd": (0.2472, 0.2397, 69.3),
    "t8 stage 3 B=8 bwd": (0.6752, 0.6599, 141.3),
    "sa12 stage 0 B=8 bwd": (0.3895, 0.3816, 80.7),
    "sa12 stage 1 B=8 bwd": (0.2492, 0.2426, 75.6),
    "sa12 stage 2 B=8 bwd": (0.4802, 0.4744, 82.1),
    "sa12 stage 3 B=8 bwd": (1.3875, 1.3644, 109.5),
    "ma36 stage 0 B=8 bwd": (0.4989, 0.4581, 409.2),
    "ma36 stage 1 B=8 bwd": (0.3863, 0.3559, 248.3),
    "ma36 stage 2 B=8 bwd": (0.6786, 0.6644, 71.7),
    "ma36 stage 3 B=8 bwd": (2.0467, 2.0140, 126.6),
    "t8 stage 0 B=128 bwd": (2.7527, 2.6953, 122.4),
    "t8 stage 1 B=128 bwd": (1.6935, 1.6373, 211.3),
    "t8 stage 2 B=128 bwd": (1.2866, 1.2506, 152.5),
    "t8 stage 3 B=128 bwd": (1.3636, 1.3488, 108.2),
    "sa12 stage 0 B=32 bwd": (1.4928, 1.4659, 80.3),
    "sa12 stage 1 B=32 bwd": (0.9996, 0.9879, 73.1),
    "sa12 stage 2 B=32 bwd": (0.6568, 0.6429, 146.0),
    "sa12 stage 3 B=32 bwd": (1.4275, 1.4028, 137.3),
    "ma36 stage 0 B=32 bwd": (1.7161, 1.6475, 294.3),
    "ma36 stage 1 B=32 bwd": (1.3151, 1.2445, 450.6),
    "ma36 stage 2 B=32 bwd": (0.9124, 0.9079, 107.2),
    "ma36 stage 3 B=32 bwd": (2.1260, 2.1117, 86.8),
    "t8 stage 0 B=1 res": (0.0590, 0.0267, 51.7),
    "t8 stage 1 B=1 res": (0.0582, 0.0548, 53.6),
    "t8 stage 0 B=8 res": (0.0931, 0.0905, 32.8),
    "t8 stage 1 B=8 res": (0.0689, 0.0646, 47.5),
    "t8 stage 0 B=128 res": (1.3190, 1.2758, 47.0),
    "t8 stage 1 B=128 res": (0.7707, 0.7428, 38.9),
}
# The replaced segment kernels' three clocks (ms, device ms, host us a call),
# dw_kernel<K, COMBINE, RB> and dw_kernel<K, COMBINE_BWD, 1> with
# dw_sums_reduce_kernel, at each phase_dwconv shape (t8's stage 0 and 1
# and the ragged H = 24, 56), k and batch, measured on an H100 80GB HBM3 at
# 700.00 W before pair_kernel took their place: t8's stages by this
# script's phase_dwconv, the ragged shapes by the same ``clocks`` on
# ``dw_inputs``, as phase_dwconv now times them. Printed beside the new
# kernels'.
OLD_DWPAIR = {
    "fused_combine_dw C=48 H=64 k=3 B=1": (0.0217, 0.0045, 19.6),
    "fused_combine_dw C=48 H=64 k=7 B=1": (0.0205, 0.0096, 19.7),
    "fused_combine_dw C=96 H=32 k=3 B=1": (0.0317, 0.0046, 19.4),
    "fused_combine_dw C=96 H=32 k=7 B=1": (0.0151, 0.0096, 17.6),
    "fused_combine_dw C=48 H=24 k=3 B=1": (0.0226, 0.0044, 21.3),
    "fused_combine_dw C=48 H=24 k=7 B=1": (0.0135, 0.0096, 12.7),
    "fused_combine_dw C=96 H=56 k=3 B=1": (0.0210, 0.0050, 20.3),
    "fused_combine_dw C=96 H=56 k=7 B=1": (0.0138, 0.0088, 13.1),
    "fused_combine_dw C=48 H=64 k=3 B=8": (0.0139, 0.0080, 12.8),
    "fused_combine_dw C=48 H=64 k=7 B=8": (0.0170, 0.0151, 13.7),
    "fused_combine_dw C=96 H=32 k=3 B=8": (0.0139, 0.0060, 13.4),
    "fused_combine_dw C=96 H=32 k=7 B=8": (0.0229, 0.0110, 22.2),
    "fused_combine_dw C=48 H=24 k=3 B=8": (0.0233, 0.0050, 21.2),
    "fused_combine_dw C=48 H=24 k=7 B=8": (0.0151, 0.0086, 13.8),
    "fused_combine_dw C=96 H=56 k=3 B=8": (0.0231, 0.0141, 21.3),
    "fused_combine_dw C=96 H=56 k=7 B=8": (0.0303, 0.0283, 19.5),
    "fused_combine_dw C=48 H=64 k=3 B=128": (0.0990, 0.0963, 13.2),
    "fused_combine_dw C=48 H=64 k=7 B=128": (0.1854, 0.1811, 20.3),
    "fused_combine_dw C=96 H=32 k=3 B=128": (0.0591, 0.0572, 17.7),
    "fused_combine_dw C=96 H=32 k=7 B=128": (0.0991, 0.0966, 14.1),
    "fused_combine_dw C=48 H=24 k=3 B=128": (0.0211, 0.0191, 14.0),
    "fused_combine_dw C=48 H=24 k=7 B=128": (0.0401, 0.0385, 15.2),
    "fused_combine_dw C=96 H=56 k=3 B=128": (0.1660, 0.1635, 18.9),
    "fused_combine_dw C=96 H=56 k=7 B=128": (0.3191, 0.3136, 20.8),
    "fused_combine_dw_bwd C=48 H=64 k=3 B=1": (0.0335, 0.0113, 32.7),
    "fused_combine_dw_bwd C=48 H=64 k=7 B=1": (0.0431, 0.0163, 40.9),
    "fused_combine_dw_bwd C=96 H=32 k=3 B=1": (0.0239, 0.0092, 24.1),
    "fused_combine_dw_bwd C=96 H=32 k=7 B=1": (0.0462, 0.0144, 41.6),
    "fused_combine_dw_bwd C=48 H=24 k=3 B=1": (0.0256, 0.0075, 25.1),
    "fused_combine_dw_bwd C=48 H=24 k=7 B=1": (0.0244, 0.0125, 23.4),
    "fused_combine_dw_bwd C=96 H=56 k=3 B=1": (0.0272, 0.0110, 25.1),
    "fused_combine_dw_bwd C=96 H=56 k=7 B=1": (0.0278, 0.0141, 23.8),
    "fused_combine_dw_bwd C=48 H=64 k=3 B=8": (0.0403, 0.0151, 42.6),
    "fused_combine_dw_bwd C=48 H=64 k=7 B=8": (0.0409, 0.0200, 39.9),
    "fused_combine_dw_bwd C=96 H=32 k=3 B=8": (0.0265, 0.0127, 24.7),
    "fused_combine_dw_bwd C=96 H=32 k=7 B=8": (0.0260, 0.0155, 25.1),
    "fused_combine_dw_bwd C=48 H=24 k=3 B=8": (0.0289, 0.0097, 33.8),
    "fused_combine_dw_bwd C=48 H=24 k=7 B=8": (0.0317, 0.0124, 30.7),
    "fused_combine_dw_bwd C=96 H=56 k=3 B=8": (0.0294, 0.0208, 32.4),
    "fused_combine_dw_bwd C=96 H=56 k=7 B=8": (0.0376, 0.0354, 29.2),
    "fused_combine_dw_bwd C=48 H=64 k=3 B=128": (0.1348, 0.1308, 38.8),
    "fused_combine_dw_bwd C=48 H=64 k=7 B=128": (0.1945, 0.1914, 27.8),
    "fused_combine_dw_bwd C=96 H=32 k=3 B=128": (0.1019, 0.0971, 42.9),
    "fused_combine_dw_bwd C=96 H=32 k=7 B=128": (0.1184, 0.1140, 41.6),
    "fused_combine_dw_bwd C=48 H=24 k=3 B=128": (0.0393, 0.0355, 31.2),
    "fused_combine_dw_bwd C=48 H=24 k=7 B=128": (0.0504, 0.0462, 41.9),
    "fused_combine_dw_bwd C=96 H=56 k=3 B=128": (0.2897, 0.2842, 29.3),
    "fused_combine_dw_bwd C=96 H=56 k=7 B=128": (0.3497, 0.3455, 27.2),
}
# Per JSON row: the TPU kernel it replaces, its source, the batch its
# numbers were taken at, the path whose launches "launches" reports and the
# LAUNCHES key counted there. The forward kernels at the serving batch on the
# serving path, the backward ones at the training batch on their training
# path; the flash rows at the 504² training batch, the forward on the 504²
# serving path, the backward on the 504² unfreeze path; the ConvFFN row at
# batch 1 on the t8 serving path, its times and bound summed over the ten
# launches of one t8 forward; the ConvFFN backward row at batch 128 on the t8
# LoRA training path, its times and bound summed over the ten launches of one
# t8 step.
KERNEL_ROWS = {
    "fused_block": ("dino_pose_tpu/ops/block.py:159", BLOCK_SOURCE, 1, "serving"),
    "fused_attn_part": ("dino_pose_tpu/ops/block.py:999", BLOCK_SOURCE, 1, "serving"),
    "fused_mlp_part": ("dino_pose_tpu/ops/block.py:1021", BLOCK_SOURCE, 1, "serving"),
    "fused_mlp_dx": ("dino_pose_tpu/ops/block.py:1044", BLOCK_SOURCE, TRAIN_BATCH, "lora_train"),
    "fused_block_train": ("dino_pose_tpu/ops/block.py:592", BLOCK_SOURCE, TRAIN_BATCH,
                          "unfreeze_train"),
    "fused_mlp_bwd": ("dino_pose_tpu/ops/block.py:284", BLOCK_SOURCE, TRAIN_BATCH,
                      "unfreeze_train"),
    "fused_attn_bwd": ("dino_pose_tpu/ops/block.py:334", BLOCK_SOURCE, TRAIN_BATCH,
                       "unfreeze_train"),
    "flash_attention": ("dino_pose_tpu/ops/attention.py:40", FLASH_SOURCE, LONG_BATCH,
                        "serving_504"),
    "flash_attention_bwd": ("dino_pose_tpu/ops/attention.py:130", FLASH_SOURCE, LONG_BATCH,
                            "unfreeze_504_train"),
    "fused_convffn": ("dino_pose_tpu/ops/convffn.py:92", CONVFFN_SOURCE, 1,
                      "serving_fastvit_t8"),
    "fused_convffn_bwd": ("dino_pose_tpu/ops/convffn.py:117", CONVFFN_SOURCE, T8_TRAIN_BATCH,
                          "fastvit_t8_lora_train"),
    # dinov2-large's streamed halves at batch 1 on its serving path, and the
    # LoRA layer's dx kernel at D = 1024 (JAX's _mlp_stream_dx_kernel, the
    # function of _mlp_dx_kernel) at batch 128 on its LoRA training path.
    "fused_attn_part_stream": ("dino_pose_tpu/ops/block.py:1807", BLOCK_SOURCE, 1,
                               "serving_dinov2_large"),
    "fused_mlp_part_stream": ("dino_pose_tpu/ops/block.py:1636", BLOCK_SOURCE, 1,
                              "serving_dinov2_large"),
    "fused_mlp_dx_dinov2_large": ("dino_pose_tpu/ops/block.py:1663", BLOCK_SOURCE, TRAIN_BATCH,
                                  "dinov2_large_lora_train"),
    # The trainable streamed halves at D = 1024, batch 128, on dinov2-large's
    # unfreeze path; each backward wrapper replaces a pair of TPU kernels.
    "fused_mlp_part_stream_train": ("dino_pose_tpu/ops/block.py:1695", BLOCK_SOURCE, TRAIN_BATCH,
                                    "dinov2_large_unfreeze_train"),
    "fused_mlp_bwd_stream": ("dino_pose_tpu/ops/block.py:1726, dino_pose_tpu/ops/block.py:1770",
                             BLOCK_SOURCE, TRAIN_BATCH, "dinov2_large_unfreeze_train"),
    "fused_attn_bwd_stream": ("dino_pose_tpu/ops/block.py:1924, dino_pose_tpu/ops/block.py:1973",
                              BLOCK_SOURCE, TRAIN_BATCH, "dinov2_large_unfreeze_train"),
    # FastViT's opt-in arms: the 7x7 conv at batch 1 on the t8 serving path
    # with the conv arm, times and bound summed over its four launches a
    # forward; the segment forward and the ConvFFN with the residual (four
    # launches a step) and the segment backward (three) at batch 128 on the
    # t8 LoRA path with both arms, summed the same way.
    "fused_dw_conv": ("dino_pose_tpu/ops/dwconv.py:54", DWCONV_SOURCE, 1,
                      "serving_fastvit_t8_dwconv"),
    "fused_combine_dw": ("dino_pose_tpu/ops/dwconv.py:287", DWCONV_SOURCE, T8_TRAIN_BATCH,
                         "fastvit_t8_lora_pair_train"),
    "fused_combine_dw_bwd": ("dino_pose_tpu/ops/dwconv.py:310", DWCONV_SOURCE, T8_TRAIN_BATCH,
                             "fastvit_t8_lora_pair_train"),
    "fused_convffn_res": ("dino_pose_tpu/ops/convffn.py:370", CONVFFN_SOURCE, T8_TRAIN_BATCH,
                          "fastvit_t8_lora_pair_train"),
    # One tensor-parallel shard's kernels at dinov2-base's shard shapes
    # (tp = 2): the halves at batch 1 on the tp2 serving path, the partial
    # dx at batch 128 on its LoRA training path; the final LayerNorm at the
    # serving forward's (257, 384) rows in bf16 on the gated serving path.
    "fused_attn_part_partial": ("dino_pose_tpu/ops/block.py:1010", BLOCK_SOURCE, 1,
                                "serving_dinov2_base_tp2"),
    "fused_mlp_part_partial": ("dino_pose_tpu/ops/block.py:1062", BLOCK_SOURCE, 1,
                               "serving_dinov2_base_tp2"),
    "fused_mlp_partial_dx": ("dino_pose_tpu/ops/block.py:1099", BLOCK_SOURCE, TRAIN_BATCH,
                             "dinov2_base_lora_tp2_train"),
    "fused_layernorm": ("dino_pose_tpu/ops/layernorm.py:36", LN_SOURCE, 1, "serving_ln"),
    # The resident attention step alone (the per-head loops of _block_kernel
    # and _attn_bwd_kernel, inside rows 1-7 and 17-20) at dinov2-small's 6
    # heads, batch 128, on its unfreeze path: 16 forwards and 4 backward
    # pairs a step.
    "attention_core": ("dino_pose_tpu/ops/block.py:182", BLOCK_SOURCE, TRAIN_BATCH,
                       "unfreeze_train"),
    "attention_core_bwd": ("dino_pose_tpu/ops/block.py:384", BLOCK_SOURCE, TRAIN_BATCH,
                           "unfreeze_train"),
}
# The LAUNCHES key each row counts.
LAUNCH_KEY = {"flash_attention": "flash_fwd", "flash_attention_bwd": "flash_bwd",
              "attention_core": "attn_fwd", "attention_core_bwd": "attn_bwd",
              "fused_mlp_dx_dinov2_large": "fused_mlp_dx"}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device-only ms a call: ``iters`` calls captured once in a CUDA graph,
    the graph replayed ``reps`` times between two events, so that no host
    work sits between the launches. A refused capture is tried once more
    (the first capture of a library's backward in a process can fail where
    the next succeeds); where capture refuses ``fn`` again, the kernels'
    summed time in a torch.profiler trace of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                for _ in range(iters):
                    fn()
            break
        except RuntimeError as err:
            torch.cuda.synchronize()
            del graph
            if attempt:
                log(f"device_ms: CUDA graph capture refused twice "
                    f"({str(err).splitlines()[0]}); profiler kernel time instead")
                return profiler_ms(fn, iters)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def profiler_ms(fn, iters: int) -> float:
    """The summed device time of the kernels of ``iters`` calls, a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1000 / iters


def host_us(fn, iters: int = 50) -> float:
    """Host microseconds a call: a host-clock loop of ``iters`` calls with
    no synchronisation inside it, the launches left queued on the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


def clocks(fn, iters: int = 20, warmup: int = 5) -> dict:
    """Three clocks of one call: host-inclusive ms (``cuda_ms``: back-to-back
    calls between two events, so the slower of host and device), device-only
    ms (``device_ms``) and host microseconds a call (``host_us``). The host
    clocks are the median of three runs with Python's garbage collector
    paused: a collection inside a run of 20 calls can double a batch-1
    reading. The graph of ``iters`` calls is replayed twice, and the host
    loop runs ``iters`` calls: the script's whole run has to fit its time
    limit on a shared host."""
    gc.collect()
    gc.disable()
    try:
        ms = sorted(cuda_ms(fn, iters=iters, warmup=warmup) for _ in range(3))[1]
        us = sorted(host_us(fn, iters) for _ in range(3))[1]
        return {"ms": ms, "device_ms": device_ms(fn, iters, reps=2), "host_us": us}
    finally:
        gc.enable()


def clocks_text(t: dict, prefix: str = "") -> str:
    return (f"{t[prefix + 'ms']:.4f} ms, device {t[prefix + 'device_ms']:.4f} ms, "
            f"host {t[prefix + 'host_us']:.1f} us/call")


def block_inputs(b: int, gen: torch.Generator, s: int = S, d: int = D, hidden: int = HIDDEN):
    """Seeded inputs of ``s`` tokens at width ``d`` (dinov2-small's by
    default), weights scaled like trained ones."""
    from dino_pose_tpu_torch.ops.block import BlockParams

    def n(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=gen) * std + mean

    def u(*shape, lo, hi):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    p = BlockParams(
        g1=n(d, std=0.1, mean=1.0), b1=n(d, std=0.05),
        wqkv=n(d, 3 * d, std=d**-0.5), bqkv=n(3 * d, std=0.05),
        wo=n(d, d, std=d**-0.5), bo=n(d, std=0.05), ls1=u(d, lo=0.1, hi=1.0),
        g2=n(d, std=0.1, mean=1.0), b2=n(d, std=0.05),
        w1=n(d, hidden, std=d**-0.5), bf1=n(hidden, std=0.05),
        w2=n(hidden, d, std=hidden**-0.5), bf2=n(d, std=0.05), ls2=u(d, lo=0.1, hi=1.0),
    )
    p = BlockParams(*(
        t.to("cuda", torch.bfloat16 if t.dim() == 2 else torch.float32).contiguous() for t in p
    ))
    x = n(b, s, d).to("cuda", torch.bfloat16)
    return x, p


def width(model: str | None) -> tuple:
    """(D, heads, hidden) of ``model``: dinov2-small's when None."""
    return WIDE.get(model, (D, H, HIDDEN))


def result_key(name: str, model: str | None) -> str:
    """The results key of a wrapper checked at ``model``'s width: its own
    name at dinov2-small's width, for the streamed forward halves (the
    largest error over every width they run at) and for the streamed
    training wrappers at dinov2-large's, else the name and the model."""
    if (model is None or name in ("fused_attn_part_stream", "fused_mlp_part_stream")
            or model == "dinov2-large" and name in STREAM_TRAIN):
        return name
    return f"{name}_{model.replace('-', '_')}"


def kernel_cases(x, p, heads: int = H, stream: bool = False):
    """The forward wrappers of a block route and their plain versions: the
    resident ones (dinov2-small and -base) or the weight-streamed halves
    (dinov2-large)."""
    from dino_pose_tpu_torch.ops import block as B

    ap, mp = B.attn_params(p), B.mlp_params(p)
    if stream:
        return {
            "fused_attn_part_stream": (
                lambda: B.fused_attn_part_stream(x, ap, heads, EPS),
                lambda: B.attn_part_stream_math(x, ap, num_heads=heads, eps=EPS)),
            "fused_mlp_part_stream": (lambda: B.fused_mlp_part_stream(x, mp, EPS),
                                      lambda: B.mlp_part_stream_math(x, mp, eps=EPS)),
        }
    return {
        "fused_block": (lambda: B.fused_block(x, p, heads, EPS),
                        lambda: B.block_math(x, p, num_heads=heads, eps=EPS)),
        "fused_attn_part": (lambda: B.fused_attn_part(x, ap, heads, EPS),
                            lambda: B.attn_part_math(x, ap, num_heads=heads, eps=EPS)),
        "fused_mlp_part": (lambda: B.fused_mlp_part(x, mp, EPS),
                           lambda: B.mlp_part_math(x, mp, eps=EPS)),
    }


def expected(per: dict) -> dict:
    """Every wrapper's launch count: ``per``, and 0 for the rest."""
    from dino_pose_tpu_torch.ops import block as B

    return {**dict.fromkeys(B.LAUNCHES, 0), **per}


def record_launches(results: dict, path: str, launches: dict) -> None:
    for name, n in launches.items():
        results.setdefault(name, {"max_abs_err": 0.0}).setdefault("launches", {})[path] = n


def attn_check(got: torch.Tensor, want: torch.Tensor, fro_tol: float,
               atol_scale: float = 1.0) -> tuple[float, float, bool]:
    """The attention tolerance, its absolute part scaled by ``atol_scale``:
    (max abs error, relative Frobenius error, ok)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    fro = ((got - want).norm() / want.norm()).item()
    ok = (bool(torch.isfinite(got).all()) and fro <= fro_tol
          and bool((err <= ATTN_ATOL * atol_scale + ATTN_RTOL * want.abs()).all()))
    return err.max().item(), fro, ok


def attn_tol_text(fro_tol: float) -> str:
    return f"atol {ATTN_ATOL} + rtol {ATTN_RTOL}*|ref| and rel Frobenius {fro_tol}"


def check_kernel(results: dict, key: str, got: torch.Tensor, want: torch.Tensor,
                 label: str) -> None:
    """A forward wrapper's output against its plain version: the attention
    halves' (no residual) at the attention tolerance, the others at the
    kernel tolerance. Keeps the largest error under ``key``."""
    got, want = got.float(), want.float()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    big = want.abs() > 0.1
    max_rel = (diff[big] / want.abs()[big]).max().item() if big.any() else 0.0
    if key.startswith("fused_attn_part"):
        max_abs, fro, ok = attn_check(got, want, ATTN_FRO)
        tol = attn_tol_text(ATTN_FRO)
    else:
        max_abs = diff.max().item()
        fro = (diff.norm() / want.norm()).item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        tol = f"atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}*|ref|"
    log(f"kernel {label}: max_abs={max_abs:.6g} max_rel(|ref|>0.1)={max_rel:.6g} "
        f"rel_fro={fro:.4g} tol={tol} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    row = results.setdefault(key, {"max_abs_err": 0.0})
    row["max_abs_err"] = max(row["max_abs_err"], max_abs)


def where_text(model: str | None, s: int = S) -> str:
    return ("" if s == S else f" S={s}") + (
        "" if model is None else " ({}: D={}, {} heads)".format(model, *width(model)[:2]))


def phase_kernels(results: dict, model: str | None = None, batches: tuple = (1, 8),
                  seqs: tuple = (S, S_LONG), seed: int = SEED) -> None:
    """Each forward kernel of ``model``'s block route (dinov2-small's when
    None) at each of ``seqs`` vs its plain version at full width, bf16, at
    ``batches``: at S = 1297 the chains stream their attention through
    flash_fwd_kernel on the packed qkv."""
    from dino_pose_tpu_torch.ops import block as B

    d, heads, hidden = width(model)
    gen = torch.Generator().manual_seed(seed)
    for s in seqs:
        stream = B.block_route(d, s, heads, hidden, 2, lora=False, training=False) == "stream"
        for b in batches:
            x, p = block_inputs(b, gen, s, d, hidden)
            cases = kernel_cases(x, p, heads, stream=stream)
            for name, (kern, plain) in cases.items():
                check_kernel(results, result_key(name, model), kern(), plain(),
                             f"{name} B={b}{where_text(model, s)}")
            del x, p, cases


def dx_inputs(b: int, gen: torch.Generator, d: int = D, hidden: int = HIDDEN):
    """x2, a unit-scale seeded cotangent dy, and the MLP half's parameters."""
    from dino_pose_tpu_torch.ops.block import mlp_params

    x, p = block_inputs(b, gen, S, d, hidden)
    dy = torch.randn((b, S, d), generator=gen).to("cuda", torch.bfloat16)
    return x, dy, mlp_params(p)


def phase_mlp_dx(results: dict, model: str | None = None, seed: int = SEED + 3) -> None:
    """fused_mlp_dx vs mlp_dx_math at ``model``'s width (dinov2-small's when
    None), bf16, batch 1, 8 and 128."""
    from dino_pose_tpu_torch.ops import block as B

    d, _, hidden = width(model)
    gen = torch.Generator().manual_seed(seed)
    for b in (1, 8, TRAIN_BATCH):
        x2, dy, mp = dx_inputs(b, gen, d, hidden)
        check_kernel(results, result_key("fused_mlp_dx", model), B.fused_mlp_dx(x2, dy, mp, EPS),
                     B.mlp_dx_math(x2, dy, mp, eps=EPS), f"fused_mlp_dx B={b}{where_text(model)}")
        del x2, dy, mp


def train_cases(x, dy, p, heads: int = H):
    """The trainable block's three wrappers and their plain versions, each
    returning a flat tuple: (y, x2), or (dx, *weight gradients)."""
    from dino_pose_tpu_torch.ops import block as B

    mp, atp = B.mlp_params(p), B.attn_train_params(p)
    return {
        "fused_block_train": (lambda: B.fused_block_train(x, p, heads, EPS),
                              lambda: B.block_train_math(x, p, num_heads=heads, eps=EPS)),
        "fused_mlp_bwd": (lambda: flat(B.fused_mlp_bwd(x, dy, mp, EPS)),
                          lambda: flat(B.mlp_bwd_math(x, dy, mp, eps=EPS))),
        "fused_attn_bwd": (lambda: flat(B.fused_attn_bwd(x, dy, atp, heads, EPS)),
                           lambda: flat(B.attn_bwd_math(x, dy, atp, num_heads=heads, eps=EPS))),
    }


def flat(out) -> tuple:
    """(dx, grads) -> (dx, *grads); a tuple of tensors stays as it is."""
    first, rest = out
    return (first, *rest) if isinstance(rest, tuple) else (first, rest)


def compare_outputs(got: tuple, want: tuple, act_scale: float = 1.0) -> tuple[float, float, bool]:
    """Activations (3-D, 4-D) within atol*act_scale + rtol*|ref|, weight gradients
    elementwise within GRAD_TOL of their largest magnitude. Returns (max abs
    error of the activations, largest gradient error over its largest
    magnitude, ok)."""
    act_err, grad_rel, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        ok &= g.shape == w.shape and bool(torch.isfinite(g).all())
        err = (g - w).abs()
        if g.dim() >= 3:
            act_err = max(act_err, err.max().item())
            ok &= bool((err <= KERNEL_ATOL * act_scale + KERNEL_RTOL * w.abs()).all())
        else:
            scale = w.abs().max().item()
            grad_rel = max(grad_rel, err.max().item() / scale)
            ok &= scale > 0 and err.max().item() <= GRAD_TOL * scale
    return act_err, grad_rel, ok


def compare_train(name: str, got: tuple, want: tuple,
                  act_scale: float = 1.0) -> tuple[float, float, float, bool]:
    """``compare_outputs``, and the outputs ``NO_RESIDUAL`` names also held
    in relative Frobenius norm to ATTN_FRO: (max abs error of the
    activations, largest gradient error over its largest magnitude, largest
    rel Frobenius error of the no-residual outputs, ok)."""
    act_err, grad_rel, ok = compare_outputs(got, want, act_scale=act_scale)
    fro = max((rel_err(got[i], want[i]) for i in NO_RESIDUAL.get(name, ())), default=0.0)
    return act_err, grad_rel, fro, ok and fro <= ATTN_FRO


def stream_train_cases(x, dy, p, heads: int):
    """The trainable streamed halves' three wrappers and their plain
    versions, each returning a flat tuple: (y, h2), or (dx, *weight
    gradients). The MLP backward reads the h2 its plain forward gives."""
    from dino_pose_tpu_torch.ops import block as B

    ap, mp = B.attn_params(p), B.mlp_params(p)
    h2 = B.mlp_part_stream_train_math(x, mp, eps=EPS)[1]
    return {
        "fused_mlp_part_stream_train": (lambda: B.fused_mlp_part_stream_train(x, mp, EPS),
                                        lambda: B.mlp_part_stream_train_math(x, mp, eps=EPS)),
        "fused_mlp_bwd_stream": (lambda: flat(B.fused_mlp_bwd_stream(x, dy, h2, mp, EPS)),
                                 lambda: flat(B.mlp_stream_bwd_math(x, dy, h2, mp, eps=EPS))),
        "fused_attn_bwd_stream": (
            lambda: flat(B.fused_attn_bwd_stream(x, dy, ap, heads, EPS)),
            lambda: flat(B.attn_stream_bwd_math(x, dy, ap, num_heads=heads, eps=EPS))),
    }


def phase_stream_train(results: dict) -> dict:
    """The trainable streamed halves against their plain versions at
    dinov2-base's and dinov2-large's widths (D = 768, 12 heads; D = 1024,
    16 heads), S = 257, bf16, batch 1, 8 and 128, with a unit-scale seeded
    cotangent, on every output (fused_attn_part_stream too at D = 768,
    where base's trainable blocks run it); then their kernel, plain and
    bound times. Returns the times by batch (dinov2-large's under the
    wrapper's name, dinov2-base's under ``<name>_dinov2_base``)."""
    from dino_pose_tpu_torch.ops import block as B

    gen = torch.Generator().manual_seed(SEED + 14)
    by_batch: dict = {}
    for model in WIDE:
        d, heads, hidden = width(model)
        flops = B.block_flops(S, d, hidden)
        for b in (1, 8, TRAIN_BATCH):
            x, p = block_inputs(b, gen, S, d, hidden)
            dy = torch.randn((b, S, d), generator=gen).to("cuda", torch.bfloat16)
            if model == "dinov2-base":
                kern, plain = kernel_cases(x, p, heads, stream=True)["fused_attn_part_stream"]
                check_kernel(results, "fused_attn_part_stream", kern(), plain(),
                             f"fused_attn_part_stream B={b}{where_text(model)}")
            cases = stream_train_cases(x, dy, p, heads)
            for name, (kern, plain) in cases.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                act_err, grad_rel, fro, ok = compare_train(name, got, want)
                log(f"kernel {name} B={b}{where_text(model)}: max_abs(activations)={act_err:.6g} "
                    f"rel_fro(no-residual outputs)={fro:.4g} max_err/max|ref|(weight grads)="
                    f"{grad_rel:.6g} tol=atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}*|ref| (no "
                    f"residual: and rel Frobenius {ATTN_FRO}), grads {GRAD_TOL}*max|ref| -> "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
                    log(f"  per output max_abs: {errs}")
                    raise AssertionError(f"{name} at B={b} ({model}) disagrees with its plain "
                                         "version")
                row = results.setdefault(result_key(name, model), {"max_abs_err": 0.0})
                row["max_abs_err"] = max(row["max_abs_err"], act_err)
                if name != "fused_mlp_part_stream_train":
                    row["max_grad_err_rel"] = max(row.get("max_grad_err_rel", 0.0), grad_rel)
                del got, want
                time_kernel(by_batch, result_key(name, model), b, kern, plain, b * flops[name],
                            B.block_bytes(b, S, d, hidden)[name], 10, 5, 2)
            del x, p, dy, cases
    return by_batch


def phase_train_kernels(results: dict, model: str | None = None,
                        cases: tuple = ((1, S), (8, S), (TRAIN_BATCH, S), (LONG_BATCH, S_LONG)),
                        ) -> None:
    """fused_block_train, fused_mlp_bwd and fused_attn_bwd vs their plain
    versions at ``model``'s width (dinov2-small's when None), bf16, at each
    (batch, S) of ``cases``: by default batch 1, 8 and 128 at S = 257, and
    the 504² step's batch 32 at S = 1297 (where fused_block_train streams
    its attention and fused_attn_bwd its recomputed forward and backward, on
    the packed qkv), with a unit-scale seeded cotangent, on every output."""
    d, heads, hidden = width(model)
    gen = torch.Generator().manual_seed(SEED + 5)
    for b, s in cases:
        x, p = block_inputs(b, gen, s, d, hidden)
        dy = torch.randn((b, s, d), generator=gen).to("cuda", torch.bfloat16)
        for name, (kern, plain) in train_cases(x, dy, p, heads).items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            act_err, grad_rel, ok = compare_outputs(got, want)
            where = where_text(model, s)
            log(f"kernel {name} B={b}{where}: max_abs(activations)={act_err:.6g} "
                f"max_err/max|ref|(weight grads)={grad_rel:.6g} tol=atol {KERNEL_ATOL} + rtol "
                f"{KERNEL_RTOL}*|ref|, grads {GRAD_TOL}*max|ref| -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} at B={b}{where} disagrees with its plain version")
            row = results.setdefault(result_key(name, model),
                                     {"max_abs_err": 0.0, "max_grad_err_rel": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], act_err)
            row["max_grad_err_rel"] = max(row.get("max_grad_err_rel", 0.0), grad_rel)


def flash_inputs(b: int, gen: torch.Generator, shape: tuple = (H, S_LONG, D // H)) -> list:
    """Seeded q, k, v and a unit-scale cotangent, (b, *shape) bf16 drawn on
    the card: by default the attention of dinov2-small at 504², (b, 6, 1297,
    64)."""
    return [cuda_randn((b, *shape), gen).to(torch.bfloat16) for _ in range(4)]


def check_flash(results: dict, q, k, v, g, where: str) -> None:
    """flash_attention's forward launch and backward pair against flash_math
    and flash_bwd_math on o, dq, dk and dv, at the attention tolerance."""
    from dino_pose_tpu_torch.ops import attention as A

    scale = q.shape[-1] ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = A.flash_attention(*leaves, scale)
    o.backward(g)
    checks = (("flash_attention", (o.detach(),), (A.flash_math(q, k, v, scale),)),
              ("flash_attention_bwd", tuple(t.grad for t in leaves),
               A.flash_bwd_math(q, k, v, g, scale)))
    torch.cuda.synchronize()
    for name, got, want in checks:
        errs, fros, oks = zip(*(attn_check(x, w, FLASH_FRO) for x, w in zip(got, want)))
        ok = all(oks)
        outs = "o" if len(got) == 1 else "dq dk dv"
        log(f"kernel {name} {where}: max_abs ({outs}) = {' '.join(f'{e:.6g}' for e in errs)} "
            f"rel_fro = {' '.join(f'{e:.4g}' for e in fros)} max|ref| = "
            f"{' '.join(f'{w.float().abs().max().item():.4g}' for w in want)} "
            f"tol={attn_tol_text(FLASH_FRO)} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} at {where} disagrees with its plain version")
        row = results.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], *errs)


def time_flash(q, k, v, g, label: str, full: bool) -> dict:
    """The streamed pair's forward and backward beside torch's
    scaled_dot_product_attention (forward; backward alone on a kept graph),
    the library yardstick the port never calls, the replaced kernels'
    clocks (OLD_FLASH), the bound (JAX's FLOP count, ``attention.flash_cost``)
    and the rate on the FLOPs the kernels execute: with ``full``,
    host-inclusive and device ms (``cuda_ms``, ``device_ms``: the flash
    phase leaves out ``clocks``' host clock and medians, which doubled its
    time) beside the plain versions' ms; else (FastViT's short shapes) on
    the device clock alone. Logs one line a direction and returns
    {"flash_attention": ..., "flash_attention_bwd": ...}."""
    import torch.nn.functional as F

    from dino_pose_tpu_torch.ops import attention as A
    from dino_pose_tpu_torch.ops import block as B

    b, heads, s, dh = q.shape
    scale = dh ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    _, stats = A.flash_fwd(q, k, v, scale)
    sdpa_out = F.scaled_dot_product_attention(*leaves, scale=scale)
    iters = 10 if b * heads * s * s > 10**9 or not full else 20
    runs = {
        "flash_attention": (
            lambda: A.flash_fwd(q, k, v, scale), lambda: A.flash_math(q, k, v, scale),
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
        "flash_attention_bwd": (
            lambda: A.flash_bwd(q, k, v, g, stats, scale),
            lambda: A.flash_bwd_math(q, k, v, g, scale),
            lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True)),
    }
    cost = A.flash_cost(b, heads, s, dh)

    def clock(fn) -> dict:
        t = {"device_ms": device_ms(fn, iters, reps=2)}
        if full:
            t["ms"] = cuda_ms(fn, iters=iters, warmup=2)
        return t

    def text(t: dict) -> str:
        host = f"{t['ms']:.4f} ms, " if "ms" in t else ""
        return f"{host}device {t['device_ms']:.4f} ms"

    out = {}
    for (name, (kern, plain_fn, lib_fn)), kind in zip(runs.items(), ("fwd", "bwd")):
        t = clock(kern)
        lib = clock(lib_fn)
        flops, nbytes, executed = cost[name]
        bound, by = B.bound_ms(flops, nbytes)
        rate = executed / t["device_ms"] / 1e9
        row = {**t, "bound_ms": bound, "bound_by": by, "executed_tflops": rate,
               **{f"library_{key}": val for key, val in lib.items()}}
        if full:
            row["plain_ms"] = cuda_ms(plain_fn, iters=5, warmup=1)
        old = OLD_FLASH.get(f"{label} {kind}")
        old_clocks = "" if old is None else (
            clocks_text(dict(zip(("ms", "device_ms", "host_us"), old))) if full
            else text({"device_ms": old[1]}))
        old_text = "" if old is None else (
            f"; replaced mma.sync kernel {old_clocks} "
            f"(new/old device {t['device_ms'] / old[1]:.3f})")
        if old is not None:
            row["old_device_ms"] = old[1]
        plain_text = f", plain {row['plain_ms']:.4f} ms" if full else ""
        log(f"time {name} {label} ({heads} heads, S={s}, dh={dh}): kernel {text(t)} "
            f"({rate:.1f} TFLOP/s on the {executed:.4g} FLOPs it executes){plain_text}, "
            f"scaled_dot_product_attention {text(lib)} (kernel/library device "
            f"{t['device_ms'] / lib['device_ms']:.3f}){old_text}; bound {bound:.5f} ms ({by})")
        out[name] = row
    del sdpa_out, leaves, stats
    return out


def phase_flash(results: dict, model: str | None = None) -> dict:
    """flash_attention's kernels (a forward launch, a backward pair) against
    flash_math and flash_bwd_math on o, dq, dk and dv, bf16, B = 1, 8, 32:
    at (B, heads, 1297, 64), ``model``'s attention at 504² (dinov2-small's 6
    heads when None, -base's 12, -large's 16), and, for dinov2-small, at
    fastvit_sa12's (B, 16, 64, 32) and fastvit_ma36's (B, 19, 64, 32)
    attention stages at 256² (32-wide heads; their train batch is 32), the
    chains' packed layout at the ragged S = 1300 (FLASH_PACKED), and two
    launches of each giving the same bits; then ``time_flash`` at
    ``model``'s shape and, for dinov2-small, the forward's 128-row form
    beside its 64-row one (the form every launch takes: the measurement
    behind that choice) and ``time_flash`` at sa12's shape on the device
    clock alone. Operands are drawn on the card. Logs each batch's wall
    seconds and returns the times by batch, under each wrapper's
    ``result_key``."""
    from dino_pose_tpu_torch.ops import _ext
    from dino_pose_tpu_torch.ops import attention as A
    from dino_pose_tpu_torch.ops import block as B

    gen = torch.Generator().manual_seed(SEED + 6)
    d, heads, _ = width(model)
    dh = d // heads
    scale = dh ** -0.5
    lib = _ext.lib()
    times = {}
    label = model or "dinov2-small"
    where = "" if model is None else where_text(model, S_LONG)
    saved = dict(B.LAUNCHES)
    if model is None:
        t0 = time.perf_counter()
        for s, p_heads, p_dh in FLASH_PACKED:
            qkv, dctx = attention_core_inputs(2, p_heads, s, p_dh, gen)
            check_attention_core(results, qkv, dctx, p_heads, True,
                                 f"B=2 ({p_heads} heads of {p_dh}, S={s}, packed)")
            del qkv, dctx
        log(f"wall flash packed checks: {time.perf_counter() - t0:.1f} s")
    for b in FLASH_BATCHES:
        marks = [time.perf_counter()]
        q, k, v, g = flash_inputs(b, gen, (heads, S_LONG, dh))
        check_flash(results, q, k, v, g, f"B={b}{where}")
        small = {}
        for fv, shape in (FASTVIT_FLASH_SHAPES.items() if model is None else ()):
            small[fv] = flash_inputs(b, gen, shape)
            check_flash(results, *small[fv],
                        f"B={b} ({fv}: {shape[0]} heads, S={shape[1]}, dh={shape[2]})")
        marks.append(time.perf_counter())
        runs = []
        for _ in range(2):
            o, stats = A.flash_fwd(q, k, v, scale)
            runs.append((o, stats, *A.flash_bwd(q, k, v, g, stats, scale)))
        torch.cuda.synchronize()
        # stats' third row is the backward's (written into flash_bwd's copy).
        (o0, st0, *g0), (o1, st1, *g1) = runs
        same = torch.equal(st0[:, :, :2], st1[:, :, :2]) and all(
            torch.equal(x, y) for x, y in zip((o0, *g0), (o1, *g1)))
        log(f"flash_attention B={b}{where}: two launches of the forward "
            f"and the backward pair give {'the same bits' if same else 'DIFFERENT bits'}")
        if not same:
            raise AssertionError(f"flash kernels at B={b} are not deterministic")
        del runs, o0, st0, g0, o1, st1, g1
        marks.append(time.perf_counter())
        t = time_flash(q, k, v, g, f"{label} B={b}", full=True)
        marks.append(time.perf_counter())
        if model is None:
            # The 64-row form is the one every launch takes: time_flash's.
            tiles = {64: t["flash_attention"]["device_ms"]}
            lib.dp_flash_fwd_rows(128)
            try:
                tiles[128] = device_ms(lambda: A.flash_fwd(q, k, v, scale), iters=10, reps=2)
            finally:
                lib.dp_flash_fwd_rows(0)
            log(f"time flash_attention B={b} by query rows a block, device ms: 64 rows "
                f"{tiles[64]:.4f} ({b * H * -(-S_LONG // 64)} blocks), 128 rows "
                f"{tiles[128]:.4f} ({b * H * -(-S_LONG // 128)} blocks)")
            t["flash_attention"]["device_ms_by_rows"] = tiles
            sa12 = small["fastvit_sa12"]
            t.update({f"{name}_fastvit_sa12": row for name, row in
                      time_flash(*sa12, f"fastvit_sa12 B={b}", full=False).items()})
        for name, row in t.items():
            times.setdefault(b, {})[result_key(name, model)] = row
        del q, k, v, g, small
        marks.append(time.perf_counter())
        parts = np.diff(marks)
        log(f"wall flash B={b}{where}: {marks[-1] - marks[0]:.1f} s (checks {parts[0]:.1f}, "
            f"same bits {parts[1]:.1f}, time_flash {parts[2]:.1f}, 128 rows and sa12 "
            f"{parts[3]:.1f})")
    B.LAUNCHES.update(saved)  # timing launches are not main-path launches
    return times


# The chains' attention step on both of its routes across the resident
# route's range of S (block_kernels.cu resident_limit: 320 forward and 304
# backward at head width 64, 400 and 384 at 32), at dinov2-small's 6 heads
# of 64 and 12 heads of 32, at 224² serving's and training's batches.
CROSSOVER_SEQS = {64: (64, 128, 192, 257, 304), 32: (64, 128, 257, 384)}
CROSSOVER_HEADS = {64: 6, 32: 12}


def flash_crossover() -> dict:
    """packed_attention and packed_attention_bwd on the resident route and
    on the streamed one, device ms, at each S of CROSSOVER_SEQS, B = 8 and
    128: where, if anywhere, the streamed pair overtakes the resident pair
    inside the resident route's range. The chains keep their choice by
    resident_limit (no rounding point moves between the routes); this only
    measures it. Returns the times by "dh=<dh> S=<s> B=<b>"."""
    from dino_pose_tpu_torch.ops import block as B

    gen = torch.Generator().manual_seed(SEED + 12)
    saved = dict(B.LAUNCHES)
    out = {}
    for dh, seqs in CROSSOVER_SEQS.items():
        heads = CROSSOVER_HEADS[dh]
        for s in seqs:
            for b in (8, TRAIN_BATCH):
                qkv, dctx = attention_core_inputs(b, heads, s, dh, gen)
                row = {}
                for route, streamed in (("resident", False), ("flash", True)):
                    row[f"{route}_fwd"] = device_ms(
                        lambda: B.packed_attention(qkv, heads, streamed=streamed), 10, reps=2)
                    row[f"{route}_bwd"] = device_ms(
                        lambda: B.packed_attention_bwd(qkv, dctx, heads, streamed=streamed),
                        10, reps=2)
                log(f"crossover attention_core dh={dh} ({heads} heads) S={s} B={b}, device ms "
                    f"resident / flash: forward {row['resident_fwd']:.4f} / "
                    f"{row['flash_fwd']:.4f} ({row['flash_fwd'] / row['resident_fwd']:.3f}), "
                    f"backward {row['resident_bwd']:.4f} / {row['flash_bwd']:.4f} "
                    f"({row['flash_bwd'] / row['resident_bwd']:.3f})")
                out[f"dh={dh} S={s} B={b}"] = row
                del qkv, dctx
    B.LAUNCHES.update(saved)  # timing launches are not main-path launches
    return out


def randomise_for_serving(model, gen: torch.Generator) -> None:
    """Make no path an identity: LoRA B, BN running stats and LayerScale
    (dinov2's, and FastViT's ConvLoRA B and LayerScales, at 1e-5 by default)."""
    from torch import nn

    from dino_pose_tpu_torch.models.fastvit import ConvLoRA
    from dino_pose_tpu_torch.models.vit import LoRAAdapter, _LayerScale

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LoRAAdapter):
                m.lora_B.copy_(torch.randn(m.lora_B.shape, generator=gen) * 0.02)
            elif isinstance(m, ConvLoRA):
                w = m.lora_B.weight
                w.copy_(torch.randn(w.shape, generator=gen).to(w.device) * 0.02)
            elif isinstance(m, nn.BatchNorm2d):
                c = m.running_mean.shape[0]
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
            elif isinstance(m, _LayerScale):
                m.lambda1.copy_(torch.rand(m.lambda1.shape, generator=gen) * 0.9 + 0.1)
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("layer_scale", "layer_scale_1", "layer_scale_2"):
                p.copy_(torch.rand(p.shape, generator=gen).to(p.device) * 0.9 + 0.1)


# (height, width) of the seeded requests and of phase_fit's dataset images.
IMAGE_SIZES = [(320, 240), (480, 640), (224, 224), (500, 333), (256, 300)]


def seeded_images(rng: np.random.Generator, n: int):
    from PIL import Image

    return [
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        for h, w in (IMAGE_SIZES[i % len(IMAGE_SIZES)] for i in range(n))
    ]


def compare_paths(model, pixels: np.ndarray, out, tag: str) -> None:
    """The served outputs vs the same model through the plain versions."""
    from dino_pose_tpu_torch.ops.decode import decode_heatmaps

    kp, z, hm = out
    for name, arr in (("keypoints", kp), ("z", z), ("heatmaps", hm)):
        if not np.isfinite(arr).all():
            raise AssertionError(f"{tag}: {name} has non-finite values")
    x = torch.from_numpy(pixels).cuda().to(torch.bfloat16)
    size = pixels.shape[-1]
    with torch.inference_mode():
        hm_p, z_p = model(x, kernels=False)
        kp_p = decode_heatmaps(hm_p, (size, size)).float().cpu().numpy()
    for name, got, want in (("heatmaps", hm, hm_p.float().cpu().numpy()),
                            ("z", z, z_p.float().cpu().numpy())):
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        ok = err <= MODEL_REL_TOL * scale
        log(f"{tag} {name}: max_abs={err:.6g} vs {MODEL_REL_TOL}*max|plain|={MODEL_REL_TOL * scale:.6g}"
            f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: {name} kernels vs plain out of tolerance")
    cell = size / hm.shape[-1]
    dist = np.linalg.norm(kp - kp_p, axis=-1)
    untied = ~bf16_ties(hm_p)
    agree = float((dist[untied] <= cell).mean()) if untied.any() else 1.0
    log(f"{tag} keypoints: {agree:.3f} of {int(untied.sum())} untied within {cell:.3f} px "
        f"(all {dist.size}: {float((dist <= cell).mean()):.3f}; need {KP_AGREE})")
    if agree < KP_AGREE:
        raise AssertionError(f"{tag}: keypoints kernels vs plain disagree")


def bf16_ties(hm: torch.Tensor) -> np.ndarray:
    """(B, K) bools: the heatmap holds, more than one cell (Chebyshev) from
    its argmax, a value within one bf16 ulp of its peak."""
    b, k, h, w = hm.shape
    flat = hm.float().reshape(b, k, h * w)
    peak, idx = flat.max(dim=-1)
    ulp = torch.exp2(torch.floor(torch.log2(peak.abs().clamp_min(1e-30))) - 7)
    rows = torch.arange(h, device=hm.device).repeat_interleave(w)
    cols = torch.arange(w, device=hm.device).repeat(h)
    far = ((rows - (idx // w)[..., None]).abs() > 1) | ((cols - (idx % w)[..., None]).abs() > 1)
    return ((flat >= (peak - ulp)[..., None]) & far).any(dim=-1).cpu().numpy()


def phase_serving(results: dict, serving: dict, tag: str = "serving", image_size: int = 224,
                  per_forward_launches: dict = SERVING_LAUNCHES, n_lat: int = 30,
                  n_batches: int = 10, fwd_iters: int = 20, config: dict = LORA_CONFIG,
                  pil: bool = True, model=None, recorded: tuple = ()):
    """A model (by default the repo's: dinov2-small + LoRA r=8 on layer 11,
    seeded, with ``randomise_for_serving``; or ``model`` as it is) behind
    ``serve.make_predictor``: 4 batch-1 requests and 1 batch-8 request,
    each checked (launches per forward, shapes, agreement with the plain
    path), then timed. With ``pil`` the requests are PIL images of
    several sizes (the model's preprocessor crops them to its input size);
    otherwise (B, 3, image_size, image_size) pixel arrays, seeded. The
    first and last call of each ``recorded`` wrapper in the batch-8 request
    are held against its plain version on their own tensors."""
    from dino_pose_tpu_torch.data.preprocess import create_preprocessor
    from dino_pose_tpu_torch.models.registry import create_model_from_config
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.serve import make_predictor

    if model is None:
        model = create_model_from_config(dict(config), seed=SEED, device="cuda",
                                         pretrained=False)
        randomise_for_serving(model, torch.Generator().manual_seed(SEED + 1))
    predict = make_predictor(model)
    rng = np.random.default_rng(SEED)
    if pil:
        preprocessor = create_preprocessor(model.model_name)
        requests = [[im] for im in seeded_images(rng, 4)] + [seeded_images(rng, 8)]

        def pixels_of(request):
            return preprocessor(request)["pixel_values"]
    else:
        requests = [rng.standard_normal((b, 3, image_size, image_size)).astype(np.float32)
                    for b in (1, 1, 1, 1, 8)]

        def pixels_of(request):
            return request

    # Serving runs no backward: the backward wrappers stay at 0.
    per_forward = expected(per_forward_launches)
    B.reset_launches()
    for i, request in enumerate(requests):
        before = dict(B.LAUNCHES)
        with recording(recorded if i == len(requests) - 1 else ()) as calls:
            out = predict(request)
        torch.cuda.synchronize()
        delta = {k: B.LAUNCHES[k] - before[k] for k in B.LAUNCHES}
        n = len(request)
        log(f"{tag} request {i} (batch {n}): launches {delta}")
        if delta != per_forward:
            raise AssertionError(f"{tag} request {i}: launches {delta}, want {per_forward}")
        kp, z, hm = out
        if kp.shape != (n, 24, 2) or z.shape != (n, 24) or hm.shape != (n, 24, 48, 48):
            raise AssertionError(f"{tag} request {i}: shapes {kp.shape} {z.shape} {hm.shape}")
        compare_paths(model, pixels_of(request), out, f"{tag} request {i}")
    with torch.inference_mode():
        check_calls(tag, recorded, *calls, serving, what="batch-8 request")
    del calls
    launches = dict(B.LAUNCHES)
    record_launches(results, tag, launches)
    log(f"{tag}-path launches over {len(requests)} requests: {launches}")

    # Serving times: host clock around predict (preprocess, upload, forward,
    # decode, download), batch-1 p50 and batch-8 images/s.
    one = requests[0]
    eight = requests[-1]
    for _ in range(3):
        predict(one)
        predict(eight)
    lat = []
    for _ in range(n_lat):
        t0 = time.perf_counter()
        predict(one)
        lat.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        predict(eight)
    dt = time.perf_counter() - t0
    serving["b1_latency_ms_p50"] = float(np.median(lat))
    serving["b1_latency_ms_p90"] = float(np.percentile(lat, 90))
    serving["b8_images_per_s"] = 8 * n_batches / dt

    # Device forward alone (CUDA events), kernels vs plain, batch 1 and 8.
    for b, pix in ((1, pixels_of(one)), (8, pixels_of(eight))):
        x = torch.from_numpy(pix).cuda().to(torch.bfloat16)
        with torch.inference_mode():
            serving[f"forward_ms_b{b}"] = cuda_ms(lambda: model(x), iters=fwd_iters)
            serving[f"forward_plain_ms_b{b}"] = cuda_ms(lambda: model(x, kernels=False),
                                                        iters=fwd_iters, warmup=2)
    log(f"{tag} " + json.dumps(serving))
    return model


def synthetic_batch(batch_size: int, image_size: int = 224, seed: int = 0) -> dict:
    """bench.py's synthetic fine-tune batch (loader contract: f32 pixels,
    keypoints all visible, z), made on the host from ``seed`` and moved to
    the card once; the heatmap targets are rendered inside the step."""
    rng = np.random.default_rng(seed)
    kps = rng.uniform(20, image_size - 24, (batch_size, 24, 3)).astype(np.float32)
    kps[..., 2] = 2.0
    batch = {
        "image": rng.standard_normal((batch_size, 3, image_size, image_size)).astype(np.float32),
        "2d_keypoints": kps,
        "z_coords": rng.standard_normal((batch_size, 24)).astype(np.float32),
    }
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def make_step(model, config: dict, kernels: bool, dtype=torch.bfloat16, image_size: int = 224):
    from dino_pose_tpu_torch.train.state import create_train_state
    from dino_pose_tpu_torch.train.step import make_train_step, prepare_batch

    state, optimizer, partition = create_train_state(model, config)
    step = prepare_batch(make_train_step(model, optimizer, partition, kernels=kernels),
                         device_targets=(image_size, 48), compute_dtype=dtype)
    return state, step


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def clone(obj):
    """Tensors cloned, tuples (named ones too) cloned elementwise."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple):
        items = [clone(o) for o in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


def plain_pair(name: str, args: tuple, out) -> tuple:
    """A recorded wrapper call's (outputs, its plain version's outputs on the
    same inputs, the incoming cotangent or None for a forward)."""
    from dino_pose_tpu_torch.ops import attention as A
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.ops import convffn as CF
    from dino_pose_tpu_torch.ops import dwconv as DW

    from dino_pose_tpu_torch.ops import layernorm as LN

    forward = {"fused_block": B.block_math, "fused_attn_part": B.attn_part_math,
               "fused_attn_part_stream": B.attn_part_stream_math,
               "fused_mlp_part": B.mlp_part_math, "fused_mlp_part_stream": B.mlp_part_stream_math,
               "fused_attn_part_partial": B.attn_part_math_partial,
               "fused_mlp_part_partial": B.mlp_part_math_partial}
    if name in forward:
        x, p, *heads, eps = args
        kw = {"num_heads": heads[0]} if heads else {}
        return (out,), (forward[name](x, p, eps=eps, **kw),), None
    if name == "fused_block_train":
        x, p, heads, eps = args
        return tuple(out), tuple(B.block_train_math(x, p, num_heads=heads, eps=eps)), None
    if name == "fused_mlp_dx":
        x2, dy, mp, eps = args
        return (out,), (B.mlp_dx_math(x2, dy, mp, eps=eps),), dy
    if name == "fused_mlp_partial_dx":
        x2, dp, pp, eps = args
        return (out,), (B.mlp_partial_dx_math(x2, dp, pp, eps=eps),), dp
    if name == "fused_layernorm":
        return (out,), (LN.layernorm_reference(*args),), None
    if name == "fused_mlp_bwd":
        x2, dy, mp, eps = args
        return flat(out), flat(B.mlp_bwd_math(x2, dy, mp, eps=eps)), dy
    if name == "fused_attn_bwd":
        x, dy, atp, num_heads, eps = args
        return flat(out), flat(B.attn_bwd_math(x, dy, atp, num_heads=num_heads, eps=eps)), dy
    if name == "fused_mlp_part_stream_train":
        x2, mp, eps = args
        return out, B.mlp_part_stream_train_math(x2, mp, eps=eps), None
    if name == "fused_mlp_bwd_stream":
        x2, dy, h2, mp, eps = args
        return flat(out), flat(B.mlp_stream_bwd_math(x2, dy, h2, mp, eps=eps)), dy
    if name == "fused_attn_bwd_stream":
        x, do, ap, num_heads, eps = args
        return flat(out), flat(B.attn_stream_bwd_math(x, do, ap, num_heads=num_heads,
                                                      eps=eps)), do
    if name == "fused_convffn":
        y, p, s_lora = args
        return (out,), (CF.convffn_math(y, p, s_lora),), None
    if name == "fused_convffn_bwd":
        y, df, p, s_lora = args
        return flat(out), flat(CF.convffn_bwd_math(y, df, p, s_lora)), df
    if name == "fused_convffn_res":
        return (out,), (CF.convffn_res_math(*args),), None
    if name == "fused_dw_conv":
        return (out,), (DW.dw_conv_math(*args),), None
    if name == "fused_combine_dw":
        return out, DW.combine_dw_math(*args), None
    if name == "fused_combine_dw_bwd":
        _, _, dx2bar, dy7bar, *_ = args
        ct = torch.maximum(dx2bar.float().abs().amax(), dy7bar.float().abs().amax())
        return out, DW.combine_dw_bwd_math(*args), ct
    if name == "flash_fwd":
        q, k, v, scale = args
        return out[:1], (A.flash_math(q, k, v, scale),), None
    q, k, v, do, _, scale = args  # flash_bwd
    return out, A.flash_bwd_math(q, k, v, do, scale), do


def shard_f32(name: str, args: tuple) -> torch.Tensor:
    """A shard wrapper's plain version in f32 on the same inputs (the
    activations and the bf16 weights as f32): the yardstick of the shard
    outputs' relative Frobenius limit."""
    from dino_pose_tpu_torch.ops import block as B

    f32 = tuple(type(a)(*(t.float() for t in a)) if isinstance(a, tuple)
                else a.float() if isinstance(a, torch.Tensor) else a for a in args)
    if name == "fused_attn_part_partial":
        x, pp, heads, eps = f32
        return B.attn_part_math_partial(x, pp, num_heads=heads, eps=eps)
    if name == "fused_mlp_part_partial":
        x2, pp, eps = f32
        return B.mlp_part_math_partial(x2, pp, eps=eps)
    x2, dp, pp, eps = f32
    return B.mlp_partial_dx_math(x2, dp, pp, eps=eps)


def shard_check(got: torch.Tensor, want: torch.Tensor, want_f32: torch.Tensor, attention: bool,
                atol_scale: float = 1.0) -> tuple[float, float, float, bool]:
    """A shard's output, which adds no bias or residual, against its plain
    version: elementwise at the attention tolerance (the attention half's)
    or the kernel tolerance, the absolute part scaled by ``atol_scale``, and
    in relative Frobenius norm within the plain bf16 version's own distance
    from the plain f32 one on the same inputs. ATTN_FRO does not carry over:
    without the bias the partials are smaller (dinov2-base's shard o is 0.67
    of the whole half's norm), and an H100 measured 3.04e-3 for the base
    shard's attention at batch 1, where plain bf16 sits 6.0e-3 from f32.
    Returns (max abs error, rel Frobenius error, plain's own, ok)."""
    got, want, want_f32 = got.float(), want.float(), want_f32.float()
    err = (got - want).abs()
    atol, rtol = (ATTN_ATOL, ATTN_RTOL) if attention else (KERNEL_ATOL, KERNEL_RTOL)
    fro, noise = rel_err(got, want), rel_err(want, want_f32)
    ok = (bool(torch.isfinite(got).all()) and fro <= noise
          and bool((err <= atol * atol_scale + rtol * want.abs()).all()))
    return err.max().item(), fro, noise, ok


def check_step_tensors(tag: str, name: str, which: str, args: tuple, out,
                       training: dict, what: str = "train step 0") -> bool:
    """A wrapper's output in the first train step against its plain version
    on the same inputs (the step's own activations, cotangent and weights).
    A backward's outputs are linear in the incoming cotangent, so the
    absolute part of the tolerance is scaled by its max|.|. Activations at
    the kernel tolerance and each weight gradient within GRAD_TOL of its
    largest magnitude; the flash outputs and the attention halves' at the
    attention tolerance."""
    got, want, ct = plain_pair(name, args, out)
    ct_max = 1.0 if ct is None else ct.float().abs().max().item()
    if name in TP_SHARD:
        act_err, fro, noise, ok = shard_check(got[0], want[0], shard_f32(name, args),
                                              name == "fused_attn_part_partial", ct_max)
        extra = {"rel_fro": fro, "plain_bf16_vs_f32": noise}
        tol = ("atol {} + rtol {}*|ref| and rel Frobenius within plain bf16's own vs f32".format(
            *((ATTN_ATOL, ATTN_RTOL) if name == "fused_attn_part_partial"
              else (KERNEL_ATOL, KERNEL_RTOL))))
    elif name.startswith(("flash", "fused_attn_part")):
        fro_tol = FLASH_FRO if name.startswith("flash") else ATTN_FRO
        errs, fros, oks = zip(*(attn_check(g, w, fro_tol, ct_max) for g, w in zip(got, want)))
        act_err, ok = max(errs), all(oks)
        extra = {"rel_fro": max(fros)}
        tol = attn_tol_text(fro_tol)
    elif name in NO_RESIDUAL:
        act_err, grad_rel, fro, ok = compare_train(name, got, want, act_scale=ct_max)
        extra = {"rel_fro": fro, **({"max_grad_err_rel": grad_rel} if len(got) > 2 else {})}
        tol = (f"atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}*|ref| (no residual: and rel "
               f"Frobenius {ATTN_FRO}), grads {GRAD_TOL}*max|ref|")
    else:
        act_err, grad_rel, ok = compare_outputs(got, want, act_scale=ct_max)
        extra = {"max_grad_err_rel": grad_rel} if len(got) > 1 else {}
        tol = f"atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}*|ref|, grads {GRAD_TOL}*max|ref|"
    ok &= ct_max > 0
    training.setdefault("step1_tensors", {})[f"{name} {which}"] = {
        "max_abs": act_err, "max_ct": ct_max, "max_abs_over_max_ct": act_err / ct_max, **extra}
    log(f"{tag} {what} {name} ({which} call) on its own tensors: max_abs={act_err:.6g} "
        f"max|ct|={ct_max:.6g} (ratio {act_err / ct_max:.4g})"
        + "".join(f" {k}={v:.4g}" for k, v in extra.items())
        + f"; tol={tol}, atol scaled by max|ct| -> {'ok' if ok else 'FAIL'}")
    return ok


def wrapper_modules(name: str) -> tuple:
    """The modules whose global ``name`` a recorded wrapper is called by: the
    dinov2 block's forward wrappers and the gated final LayerNorm by
    models/vit.py (fused_attn_part_stream also by ops/block.py, in a
    trainable streamed block), the MLP halves, the tensor-parallel shard
    wrappers and the backward ones by ops/block.py; fused_convffn by
    ops/convffn.py in training and by models/fastvit.py in eval."""
    from dino_pose_tpu_torch.models import fastvit as FV
    from dino_pose_tpu_torch.models import vit as V
    from dino_pose_tpu_torch.ops import attention as A
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.ops import convffn as CF
    from dino_pose_tpu_torch.ops import dwconv as DW

    if name == "fused_attn_part_stream":
        return V, B
    if name in ("fused_block", "fused_attn_part", "fused_layernorm"):
        return (V,)
    if name in ("fused_dw_conv", "fused_combine_dw", "fused_combine_dw_bwd"):
        return (DW,)
    if name == "fused_convffn":
        return CF, FV
    return (CF if name.startswith("fused_convffn") else A if name.startswith("flash") else B,)


@contextlib.contextmanager
def recording(recorded: tuple):
    """While the block runs, the first and the last call of each wrapper
    named in ``recorded`` (a backward's first call is the top layer's, its
    last the bottom one's) with its inputs and outputs cloned: yields the
    dicts (first, last), filled as calls come."""
    first, last = {}, {}
    originals = {(m, name): getattr(m, name) for name in recorded for m in wrapper_modules(name)}

    def recorder(name):
        fn = originals[wrapper_modules(name)[0], name]

        def record(*args):
            out = fn(*args)
            entry = (clone(args), clone(out))
            first.setdefault(name, entry)
            last[name] = entry  # the first entry itself when there is one call
            return out
        return record

    for name in recorded:
        rec = recorder(name)
        for m in wrapper_modules(name):
            setattr(m, name, rec)
    try:
        yield first, last
    finally:
        for (m, name), fn in originals.items():
            setattr(m, name, fn)


def check_calls(tag: str, recorded: tuple, first: dict, last: dict, into: dict,
                what: str = "train step 0") -> None:
    """Each recorded wrapper's first and last call against its plain version
    on the call's own tensors (``check_step_tensors``); raises if any
    disagrees or if a recorded wrapper was not called."""
    missing = [name for name in recorded if name not in first]
    if missing:
        raise AssertionError(f"{tag}: {missing} not called on the path")
    calls = [(name, which, entry) for name in recorded
             for which, entry in (("first", first[name]), ("last", last[name]))
             if which == "first" or entry is not first[name]]
    bad = [f"{name} ({which} call)" for name, which, entry in calls
           if not check_step_tensors(tag, name, which, *entry, into, what)]
    if bad:
        raise AssertionError(f"{tag}: {bad} disagree with their plain versions on the "
                             f"{what}'s tensors")


def step1_grads(model, config: dict, kernels: bool, dtype, batch: dict, image_size: int,
                names: tuple) -> dict:
    """The gradients of ``names`` in one train step of a copy of ``model``."""
    m = copy.deepcopy(model)
    state, step = make_step(m, config, kernels=kernels, dtype=dtype, image_size=image_size)
    step(state, batch, LR, SEED)
    return {n: p.grad for n, p in m.named_parameters() if n in names}


def phase_train(results: dict, training: dict, tag: str, config: dict, per_step: dict,
                grad_names: tuple, recorded: tuple, batch_size: int = TRAIN_BATCH,
                image_size: int = 224, steps: int = TRAIN_STEPS, timed: int = 5,
                grad_batches: int = 1, grad_factor: float = GRAD_NOISE_FACTOR, model=None):
    """``steps`` fine-tune steps of the model ``config`` names (dinov2, or a
    FastViT; seeded, with ``randomise_for_serving``, or a copy of ``model``
    as it is) at ``batch_size`` through the kernels, as many from an
    identical copy through the plain versions (the same dropout masks),
    compared step by step; the first step's first and last call of each
    ``recorded`` wrapper (a backward's first call is the top layer's, its
    last the bottom one's) held against its plain version on its own
    inputs; then step times over ``timed`` steps. The step-1 gradients of
    ``grad_batches`` seeded batches (the first the steps' own) are each held
    to ``grad_factor`` times the plain path's error against f32."""
    from dino_pose_tpu_torch.models.registry import create_model_from_config
    from dino_pose_tpu_torch.ops import block as B

    if model is None:
        model = create_model_from_config(dict(config), seed=SEED, device="cuda",
                                         pretrained=False)
        randomise_for_serving(model, torch.Generator().manual_seed(SEED + 4))
    else:
        model = copy.deepcopy(model)
    plain_model = copy.deepcopy(model)
    ref_model = copy.deepcopy(model)
    init_model = copy.deepcopy(model) if grad_batches > 1 else None
    batch = synthetic_batch(batch_size, image_size)
    state, step = make_step(model, config, kernels=True, image_size=image_size)
    pstate, pstep = make_step(plain_model, config, kernels=False, image_size=image_size)

    want_step = expected(per_step)
    B.reset_launches()
    kstats, grads = [], {}
    params = dict(model.named_parameters())
    for i in range(steps):
        before = dict(B.LAUNCHES)
        with recording(recorded if i == 0 else ()) as calls:
            state, stats = step(state, batch, LR, SEED)
        if i == 0:
            first, last = calls
        torch.cuda.synchronize()
        delta = {k: B.LAUNCHES[k] - before[k] for k in B.LAUNCHES}
        log(f"{tag} train step {i} (batch {batch_size}): launches {delta}")
        if delta != want_step:
            raise AssertionError(f"{tag} train step {i}: launches {delta}, want {want_step}")
        kstats.append({k: v.item() for k, v in stats.items()})
        if i == 0:
            grads = {n: params[n].grad.detach().clone() for n in grad_names}
    launches = dict(B.LAUNCHES)
    record_launches(results, f"{tag}_train", launches)
    log(f"{tag} training-path launches over {steps} steps: {launches}")

    check_calls(tag, recorded, first, last, training)
    del first, last, calls

    # The step-1 gradients in f32 (plain versions, TF32 off) from the same
    # weights and dropout masks: the yardstick for both bf16 paths.
    rstate, rstep = make_step(ref_model, config, kernels=False, dtype=torch.float32,
                              image_size=image_size)
    rstep(rstate, batch, LR, SEED)
    ref_grads = {n: p.grad for n, p in ref_model.named_parameters() if n in grad_names}
    del ref_model, rstate, rstep

    # The step-1 gradients of further seeded batches, each way from the
    # initial weights; their launches are not main-path launches.
    extra = []
    saved = dict(B.LAUNCHES)
    for seed in range(1, grad_batches):
        more = synthetic_batch(batch_size, image_size, seed)
        extra.append(tuple(step1_grads(init_model, config, kernels, dtype, more, image_size,
                                       grad_names)
                           for kernels, dtype in ((True, torch.bfloat16), (False, torch.bfloat16),
                                                  (False, torch.float32))))
        del more
    B.LAUNCHES.update(saved)
    del init_model

    failures = []
    pparams = dict(plain_model.named_parameters())
    for i in range(steps):
        pstate, pstats = pstep(pstate, batch, LR, SEED)
        pstats = {k: v.item() for k, v in pstats.items()}
        for k in ("loss", "kp_loss", "z_loss", "weight"):
            got, want = kstats[i][k], pstats[k]
            ok = np.isfinite(got) and abs(got - want) <= LOSS_RTOL * abs(want)
            log(f"{tag} train step {i} {k}: kernels {got:.7g} plain {want:.7g} "
                f"rel {abs(got - want) / abs(want):.3g} (tol {LOSS_RTOL}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"train step {i}: {k}")
        if i == 0:
            sets = [(grads, {n: pparams[n].grad for n in grad_names}, ref_grads), *extra]
            for n in grad_names:
                errs = [(rel_err(kg[n], pg[n]), rel_err(kg[n], fg[n]), rel_err(pg[n], fg[n]))
                        for kg, pg, fg in sets]
                tols = [grad_factor * p_ref + GRAD_NOISE_SLACK for _, _, p_ref in errs]
                ok = all(bool(torch.isfinite(kg[n]).all()) for kg, _, _ in sets)
                ok &= all(max(rel, k_ref) <= tol for (rel, k_ref, _), tol in zip(errs, tols))
                (rel, k_ref, p_ref), tol = errs[0], tols[0]
                ratio = max(k_ref / p_ref for _, k_ref, p_ref in errs)
                more = "".join(f"; batch {j}: {a:.4g}, {b:.4g}, {c:.4g} (tol {t:.4g})"
                               for j, ((a, b, c), t) in enumerate(zip(errs, tols)) if j)
                log(f"{tag} step-1 grad {n}: rel Frobenius kernels vs plain {rel:.4g}, kernels vs "
                    f"f32 {k_ref:.4g}, plain vs f32 {p_ref:.4g} (tol {grad_factor}*plain+"
                    f"{GRAD_NOISE_SLACK} = {tol:.4g}){more}; largest kernels/plain ratio vs f32 "
                    f"{ratio:.4g}; |g| {ref_grads[n].norm().item():.4g} -> {'ok' if ok else 'FAIL'}")
                training.setdefault("grad_rel", {})[n] = {
                    "kernels_vs_plain": rel, "kernels_vs_f32": k_ref, "plain_vs_f32": p_ref,
                    **({"per_batch": errs, "max_ratio": ratio} if len(sets) > 1 else {})}
                if not ok:
                    failures.append(f"step-1 gradient of {n}")
            del sets, extra
    if failures:
        raise AssertionError(f"{tag}: kernels vs plain out of tolerance: " + "; ".join(failures))
    training["steps"] = {"kernels": kstats}

    # Step time (CUDA events around ``timed`` steps after 2 warm-up steps), in
    # turns kernels, plain, plain, kernels; the timing launches are not
    # counted.
    def step_ms(fn, st, n=timed):
        for _ in range(2):
            st, _ = fn(st, batch, LR, SEED)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            st, _ = fn(st, batch, LR, SEED)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    runs = {"kernels": [], "plain": []}
    for which in ("kernels", "plain", "plain", "kernels"):
        fn, st = (step, state) if which == "kernels" else (pstep, pstate)
        runs[which].append(step_ms(fn, st))
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, batch, LR, SEED)
    torch.cuda.synchronize()
    for which, ms in runs.items():
        mean = float(np.mean(ms))
        training[f"step_ms_{which}"] = mean
        training[f"step_ms_{which}_runs"] = ms
        training[f"images_per_s_{which}"] = batch_size * 1e3 / mean
    training["peak_mem_gib_kernels"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag} training " + json.dumps(training))
    return step, state, batch


def backbone_leaf(name: str, param: torch.nn.Parameter) -> bool:
    """A trainable leaf of the backbone's own blocks: a LoRA matrix, or a
    parameter of a trainable (unfrozen) dinov2 block but its key bias, whose
    true gradient is zero (a constant added to every score of a query leaves
    its softmax unchanged), so that each path holds only its own roundoff
    there."""
    return param.requires_grad and ("lora_" in name or name.startswith("backbone.encoder.")
                                     and not name.endswith("attention.key.bias"))


def phase_backbone_grads(training: dict, tag: str, config: dict, batch_size: int,
                         image_size: int = FASTVIT_IMAGE) -> None:
    """The backbone's trainable leaves' gradients alone (its LoRA matrices,
    or its trainable blocks' parameters), in train mode, under a seeded
    unit cotangent on its feature map (FastViT) or tokens (dinov2), from one
    seeded model and one dropout generator: kernels (bf16), plain (bf16) and
    plain f32 (TF32 off). The whole step's gradients pass the heads'
    train-mode BatchNorms and ReLUs, which amplify any rounding (JAX's own
    bf16 FastViT step moves them ~40% from its f32,
    tests/test_torch_fastvit_train.py), so the step compares them only
    loosely; with no head in the way bf16 moves these a few percent, and
    every leaf's gradient through the kernels must stay within
    GRAD_NOISE_FACTOR times the plain path's error against f32, plus
    GRAD_NOISE_SLACK. Every kernel of the backbone's forward and of its
    backward runs here; their launches are not main-path launches."""
    from dino_pose_tpu_torch.models.registry import create_model_from_config
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.train.step import step_generator

    model = create_model_from_config(dict(config), seed=SEED, device="cuda",
                                     pretrained=False)
    randomise_for_serving(model, torch.Generator().manual_seed(SEED + 4))
    gen = torch.Generator().manual_seed(SEED + 9)
    x = torch.randn((batch_size, 3, image_size, image_size), generator=gen).cuda()
    saved = dict(B.LAUNCHES)
    grads, ct = {}, None
    for which, kernels, dtype in (("kernels", True, torch.bfloat16),
                                  ("plain", False, torch.bfloat16),
                                  ("f32", False, torch.float32)):
        m = copy.deepcopy(model).train()
        fmap = m.backbone(x.to(dtype), kernels=kernels,
                          generator=step_generator(SEED, 0, x.device))
        if isinstance(fmap, tuple):  # dinov2: (tokens, patch grid)
            fmap = fmap[0]
        if ct is None:
            ct = torch.randn(fmap.shape, generator=gen).cuda()
        fmap.float().backward(ct)
        grads[which] = {n: p.grad for n, p in m.named_parameters() if backbone_leaf(n, p)}
        del m, fmap
    torch.cuda.synchronize()
    B.LAUNCHES.update(saved)

    rows, bad = {}, []
    for n, want in grads["f32"].items():
        got, plain = grads["kernels"][n], grads["plain"][n]
        k_ref, p_ref, kp = rel_err(got, want), rel_err(plain, want), rel_err(got, plain)
        tol = GRAD_NOISE_FACTOR * p_ref + GRAD_NOISE_SLACK
        rows[n] = {"kernels_vs_f32": k_ref, "plain_vs_f32": p_ref, "kernels_vs_plain": kp}
        if not (bool(torch.isfinite(got).all()) and want.abs().max() > 0 and k_ref <= tol):
            bad.append(n)
            log(f"{tag} backbone grad {n}: kernels vs f32 {k_ref:.4g}, plain vs f32 "
                f"{p_ref:.4g} (tol {tol:.4g}) -> FAIL")
    worst = max(rows, key=lambda n: rows[n]["kernels_vs_f32"] / rows[n]["plain_vs_f32"])
    stat = {k: max(r[k] for r in rows.values()) for k in rows[worst]}
    training["backbone_grad_rel"] = {"max": stat, "worst": {worst: rows[worst]}, "leaves": rows}
    log(f"{tag} backbone {'LoRA' if 'lora' in worst else 'block'} grads ({len(rows)} leaves, "
        f"batch {batch_size}, seeded cotangent on "
        f"the feature map): largest rel Frobenius kernels vs f32 {stat['kernels_vs_f32']:.4g}, "
        f"plain vs f32 {stat['plain_vs_f32']:.4g}, kernels vs plain "
        f"{stat['kernels_vs_plain']:.4g}; worst kernels/plain ratio {worst} "
        f"{rows[worst]['kernels_vs_f32']:.4g}/{rows[worst]['plain_vs_f32']:.4g} (tol "
        f"{GRAD_NOISE_FACTOR}*plain+{GRAD_NOISE_SLACK}) -> {'FAIL' if bad else 'ok'}")
    if bad:
        raise AssertionError(f"{tag}: backbone gradients out of tolerance: {bad}")


def time_kernel(times: dict, key: str, b: int, kern, plain, flops: float, nbytes: float,
                iters: int, plain_iters: int, plain_warmup: int = 5) -> None:
    """Kernel, plain and bound times of one wrapper at batch ``b`` into
    ``times[b][key]``; the timing launches are not main-path launches."""
    from dino_pose_tpu_torch.ops import block as B

    saved = dict(B.LAUNCHES)
    with torch.inference_mode():
        ms = cuda_ms(kern, iters=iters)
        plain_ms = cuda_ms(plain, iters=plain_iters, warmup=plain_warmup)
    B.LAUNCHES.update(saved)
    bound, by = B.bound_ms(flops, nbytes)
    times.setdefault(b, {})[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                                    "bound_by": by}
    log(f"time {key} B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound:.5f} ms ({by})")


def phase_times(model: str | None = None) -> dict:
    """Kernel, plain and bound times at the main-path shapes of ``model``'s
    width (dinov2-small's when None, with its trainable block's kernels):
    the forward wrappers of its block route at batch 1 and 8, fused_mlp_dx
    at 1, 8 and 128. The wider models' slower plain versions take fewer
    iterations."""
    from dino_pose_tpu_torch.ops import block as B

    d, heads, hidden = width(model)
    small = model is None
    gen = torch.Generator().manual_seed(SEED + 2 if small else SEED + 13)
    flops = B.block_flops(S, d, hidden)
    by_batch: dict = {}
    for b in (1, 8):
        x, p = block_inputs(b, gen, S, d, hidden)
        nbytes = B.block_bytes(b, S, d, hidden)
        for name, (kern, plain) in kernel_cases(x, p, heads, model == "dinov2-large").items():
            time_kernel(by_batch, result_key(name, model), b, kern, plain, b * flops[name],
                        nbytes[name], *((50, 50) if small else (20, 10, 2)))
        del x, p
    for b in (1, 8, TRAIN_BATCH):
        x2, dy, mp = dx_inputs(b, gen, d, hidden)
        time_kernel(by_batch, result_key("fused_mlp_dx", model), b,
                    lambda: B.fused_mlp_dx(x2, dy, mp, EPS),
                    lambda: B.mlp_dx_math(x2, dy, mp, eps=EPS), b * flops["fused_mlp_dx"],
                    B.block_bytes(b, S, d, hidden)["fused_mlp_dx"],
                    *((20, 20) if small else (10, 5, 2)))
        del x2, dy, mp
    if not small:
        return by_batch
    for b in (1, 8, TRAIN_BATCH):
        x, p = block_inputs(b, gen)
        dy = torch.randn((b, S, D), generator=gen).to("cuda", torch.bfloat16)
        for name, (kern, plain) in train_cases(x, dy, p).items():
            time_kernel(by_batch, name, b, kern, plain, b * flops[name],
                        B.block_bytes(b, S, D, HIDDEN)[name], 20, 10, 2)
    return by_batch


def convffn_inputs(b: int, s: int, c: int, h: int, r: int, gen: torch.Generator):
    """Seeded (b, s, c) bf16 rows and ConvFFN parameters: weights scaled like
    trained ones, the BN affine near identity; rank r with Dropout2d-style
    masks (zeros and 1/keep), or rank 0 as rank-1 zero adapters, ones masks."""
    from dino_pose_tpu_torch.ops.convffn import ConvFFNParams

    def n(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=gen) * std + mean

    if r:
        lora = dict(a1=n(c, r, std=c**-0.5), b1l=n(r, h, std=0.05),
                    a2=n(h, r, std=h**-0.5), b2l=n(r, c, std=0.05))
        m1, m2 = ((torch.rand((b, r), generator=gen) > 0.1).float() / 0.9 for _ in range(2))
    else:
        lora = dict(a1=torch.zeros(c, 1), b1l=torch.zeros(1, h), a2=torch.zeros(h, 1),
                    b2l=torch.zeros(1, c))
        m1 = m2 = torch.ones(b, 1)
    p = dict(inv=n(c, std=0.1, mean=1.0), shift=n(c, std=0.05), w1=n(c, h, std=c**-0.5),
             b1=n(h, std=0.05), w2=n(h, c, std=h**-0.5), b2=n(c, std=0.05), **lora, m1=m1, m2=m2)
    p = ConvFFNParams(**{
        k: v.to("cuda", torch.bfloat16 if v.dim() == 2 and k not in ("m1", "m2")
                else torch.float32).contiguous()
        for k, v in p.items()})
    return cuda_randn((b, s, c), gen).to(torch.bfloat16), p


def phase_convffn(results: dict, backward: bool) -> dict:
    """fused_convffn (with ``backward``, fused_convffn_bwd) against
    convffn_math (convffn_bwd_math, with a unit-scale seeded cotangent) at
    every fastvit_t8, fastvit_sa12 and fastvit_ma36 stage shape (256² input;
    ma36's C = 76 and 152 through the wrappers' zero padding), bf16, at
    batch 1, 8 and the model's train batch (128, 32; ma36 32): the forward
    at batch 1 and 8 at the serving rank (t8 and ma36: 8, sa12: 0, rank-1
    zero adapters with ones masks), everything else at rank 8 with
    Dropout2d-style masks.
    Outputs at the kernel tolerance, each parameter gradient within GRAD_TOL
    of its largest magnitude; then kernel, plain and bound times. Returns, by
    batch, each model's sums over the launches of one forward (step) (stage
    time x blocks) and the per-stage numbers."""
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.ops import convffn as CF

    name = "fused_convffn_bwd" if backward else "fused_convffn"
    gen = torch.Generator().manual_seed(SEED + (8 if backward else 7))
    gen_train = gen if backward else torch.Generator().manual_seed(SEED + 11)
    out: dict = {}
    for model, stages in CONVFFN_STAGES.items():
        train_batch = {"t8": T8_TRAIN_BATCH, "sa12": SA12_TRAIN_BATCH,
                       "ma36": MA36_TRAIN_BATCH}[model]
        rank = 8 if backward else CONVFFN_RANK[model]
        for b, r, g in ((1, rank, gen), (8, rank, gen), (train_batch, 8, gen_train)):
            s_lora = 16.0 / r if r else 1.0
            total = {"ms": 0.0, "device_ms": 0.0, "host_us": 0.0, "plain_ms": 0.0, "flops": 0,
                     "bytes": 0}
            for i, (c, h, s, blocks) in enumerate(stages):
                y, p = convffn_inputs(b, s, c, h, r, g)
                if backward:
                    df = cuda_randn((b, s, c), g).to(torch.bfloat16)

                    def kern():
                        return flat(CF.fused_convffn_bwd(y, df, p, s_lora))

                    def plain():
                        return flat(CF.convffn_bwd_math(y, df, p, s_lora))
                    flops, nbytes = CF.convffn_bwd_cost(b, s, c, h, r)
                else:
                    def kern():
                        return (CF.fused_convffn(y, p, s_lora),)

                    def plain():
                        return (CF.convffn_math(y, p, s_lora),)
                    flops, nbytes = CF.convffn_cost(b, s, c, h, max(r, 1))
                got, want = kern(), plain()
                torch.cuda.synchronize()
                act_err, grad_rel, ok = compare_outputs(got, want)
                where = f"{model} stage {i} (C={c}, H={h}, S={s}, R={r}) B={b}"
                grads = (f" max_err/max|ref|(grads)={grad_rel:.6g}" if backward else "")
                log(f"kernel {name} {where}: max_abs={act_err:.6g} max|ref|="
                    f"{want[0].float().abs().max().item():.4g}{grads} tol=atol {KERNEL_ATOL} + "
                    f"rtol {KERNEL_RTOL}*|ref|{f', grads {GRAD_TOL}*max|ref|' if backward else ''}"
                    f" -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} at {where} disagrees with its plain version")
                row = results.setdefault(name, {"max_abs_err": 0.0})
                row["max_abs_err"] = max(row["max_abs_err"], act_err)
                if backward:
                    row["max_grad_err_rel"] = max(row.get("max_grad_err_rel", 0.0), grad_rel)
                del got, want
                saved = dict(B.LAUNCHES)
                with torch.inference_mode():
                    t = clocks(kern, iters=10 if backward else 20, warmup=2 if backward else 5)
                    plain_ms = cuda_ms(plain, iters=3 if backward else 10,
                                       warmup=1 if backward else 2)
                B.LAUNCHES.update(saved)  # timing launches are not main-path launches
                bound, by = B.bound_ms(flops, nbytes)
                old = OLD_CONVFFN.get(f"{model} stage {i} B={b} {'bwd' if backward else 'fwd'}")
                tflops = flops / t["device_ms"] / 1e9
                log(f"time {name} {where}: kernel {clocks_text(t)} ({tflops:.1f} TFLOP/s, "
                    f"{100 * bound / t['device_ms']:.1f}% of the bound), "
                    + ("" if old is None else f"old kernel {old[0]:.4f} ms, device {old[1]:.4f} "
                       f"ms, host {old[2]:.1f} us/call (x{old[1] / t['device_ms']:.2f}), ")
                    + f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({by}); x{blocks} blocks a "
                    f"{'step' if backward else 'forward'}")
                out.setdefault(b, {}).setdefault(f"{model}_stages", []).append({
                    "C": c, "H": h, "S": s, "R": r, "blocks": blocks, **t, "tflops": tflops,
                    **({} if old is None else dict(zip(("old_ms", "old_device_ms", "old_host_us"),
                                                       old))),
                    "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "max_abs_err": act_err, **({"max_grad_err_rel": grad_rel} if backward else {})})
                for k in ("device_ms", "host_us"):
                    total[k] += blocks * t[k]
                total["ms"] += blocks * t["ms"]
                if old is not None:
                    for k, v in zip(("old_ms", "old_device_ms", "old_host_us"), old):
                        total[k] = total.get(k, 0.0) + blocks * v
                total["plain_ms"] += blocks * plain_ms
                total["flops"] += blocks * flops
                total["bytes"] += blocks * nbytes
            bound, by = B.bound_ms(total["flops"], total["bytes"])
            out[b][model] = {**{k: total[k] for k in ("ms", "device_ms", "host_us", "plain_ms")},
                             "bound_ms": bound, "bound_by": by, "library_ms": None,
                             **{k: total[k] for k in ("old_ms", "old_device_ms", "old_host_us")
                                if k in total}}
            old_text = ("" if "old_ms" not in total else
                        f", old kernels {clocks_text(total, 'old_')} "
                        f"(x{total['old_device_ms'] / total['device_ms']:.2f})")
            log(f"time {name} {model} {'step' if backward else 'forward'} "
                f"({sum(st[3] for st in stages)} launches) B={b}: kernel {clocks_text(total)} "
                f"({total['flops'] / total['device_ms'] / 1e9:.1f} TFLOP/s){old_text}, "
                f"plain {total['plain_ms']:.4f} ms, bound {bound:.5f} ms ({by})")
    return out


@contextlib.contextmanager
def gates(env: dict):
    """Set the environment ``env`` (JAX's switches, the hub cache) for one
    phase and restore it after, also when the phase fails (the failure still
    ends the run)."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dw_inputs(b: int, h: int, c: int, kk: int, gen: torch.Generator):
    """Seeded bf16 (b, h, h, c) x, y0 and unit-scale cotangents dx2bar,
    dy7bar; f32 a ~ 1, b, bias (the reuse-form RepMixer's coefficients at
    LayerScale ~ 0.1-1) and an HWIO conv kernel scaled like a trained
    depthwise conv."""
    def n(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=gen) * std + mean

    acts = [n(b, h, h, c).to("cuda", torch.bfloat16) for _ in range(4)]
    vecs = [n(c, std=0.1, mean=1.0), n(c, std=0.3), n(c, std=0.1)]
    return acts, [v.cuda() for v in vecs], n(kk, kk, 1, c, std=1.0 / kk).cuda()


def check_dw(results: dict, name: str, got: tuple, want: tuple, where: str) -> float:
    """A depthwise-arm wrapper against its plain version: activations at the
    kernel tolerance, the backward's f32 (C,) sums within GRAD_TOL of their
    largest magnitude. Keeps the largest errors under ``name``."""
    torch.cuda.synchronize()
    act_err, grad_rel, ok = compare_outputs(got, want)
    sums = len(got) > 2
    log(f"kernel {name} {where}: max_abs={act_err:.6g}"
        + (f" max_err/max|ref|(sums)={grad_rel:.6g}" if sums else "")
        + f" tol=atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}*|ref|"
        + (f", sums {GRAD_TOL}*max|ref|" if sums else "") + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} at {where} disagrees with its plain version")
    row = results.setdefault(name, {"max_abs_err": 0.0})
    row["max_abs_err"] = max(row["max_abs_err"], act_err)
    if sums:
        row["max_grad_err_rel"] = max(row.get("max_grad_err_rel", 0.0), grad_rel)
    return act_err


def pair_unfused(x, y0, dx2, dy7, a, b, bias, kern):
    """The segment from library calls, the yardstick beside pair_kernel (two
    or more calls, so no row's "library ms"): forward DW._combine, then
    cuDNN's grouped conv with bf16 taps (as row 24's is timed); backward
    cuDNN's grouped conv on the mirrored bf16 taps, the elementwise products
    and ``.sum``. Returns (forward, backward) callables."""
    import torch.nn.functional as F

    from dino_pose_tpu_torch.ops import dwconv as DW

    kk, c = kern.shape[0], x.shape[-1]
    w = kern.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
    wf = kern.flip(0, 1).permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()

    def fwd():
        x2 = DW._combine(x, y0, a, b, bias)
        return x2, F.conv2d(x2.permute(0, 3, 1, 2), w, None, 1, kk // 2, 1, c)

    def bwd():
        conv = F.conv2d(dy7.permute(0, 3, 1, 2), wf, None, 1, kk // 2, 1, c)
        d2 = dx2.float() + conv.permute(0, 2, 3, 1).float()
        dims = (0, 1, 2)
        return ((d2 * a).to(x.dtype), (d2 * b).to(x.dtype), (d2 * x.float()).sum(dims),
                (d2 * y0.float()).sum(dims), d2.sum(dims))

    return fwd, bwd


PAIR_NAMES = ("fused_combine_dw", "fused_combine_dw_bwd")
OLD_CLOCKS = ("old_ms", "old_device_ms", "old_host_us")
UNFUSED_CLOCKS = ("unfused_ms", "unfused_device_ms", "unfused_host_us")


def phase_dwconv(results: dict) -> dict:
    """FastViT's opt-in arms' wrappers against their plain versions at t8's
    stage 0 and 1 shapes (256²), bf16, batch 1, 8 and 128: fused_dw_conv
    (also with flip=True, its transpose), fused_combine_dw and
    fused_combine_dw_bwd at k = 3 and 7, and fused_convffn_res at rank 8
    with Dropout2d-style masks; the conv kernels also at ragged H = 24 and
    56 (the conv at batch 8, the segment at 1, 8 and 128). The segment's x2
    is held bit-equal to DW._combine's, and a second call of each segment
    kernel to the first's bits. Then kernel (``clocks``: host-inclusive,
    device-only and host us a call), plain, bound and (for the conv) cuDNN's
    grouped conv times at the path's shapes; beside the segment kernels the
    replaced kernels' (OLD_DWPAIR) and the unfused library yardstick's
    (``pair_unfused``). Returns, by batch, each wrapper's per-stage numbers
    and its sums over the launches of one forward (the conv at batch 1, k =
    7: the serving path) or one step (the segment and the residual ConvFFN
    at batch 128, k = 7)."""
    import torch.nn.functional as F

    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.ops import convffn as CF
    from dino_pose_tpu_torch.ops import dwconv as DW

    gen = torch.Generator().manual_seed(SEED + 14)
    saved = dict(B.LAUNCHES)
    out: dict = {}

    def pair_cases(b, h, c, kk, x, y0, dx2, dy7, a, bv, bias, kern):
        unf_fwd, unf_bwd = pair_unfused(x, y0, dx2, dy7, a, bv, bias, kern)
        return {
            "fused_combine_dw": (lambda: DW.fused_combine_dw(x, y0, a, bv, bias, kern),
                                 lambda: DW.combine_dw_math(x, y0, a, bv, bias, kern),
                                 DW.combine_dw_cost(b, h, h, c, kk), unf_fwd),
            "fused_combine_dw_bwd": (
                lambda: DW.fused_combine_dw_bwd(x, y0, dx2, dy7, a, bv, kern),
                lambda: DW.combine_dw_bwd_math(x, y0, dx2, dy7, a, bv, kern),
                DW.combine_dw_bwd_cost(b, h, h, c, kk), unf_bwd),
        }

    def check_pair(name, kern_fn, plain_fn, where) -> float:
        got, want = kern_fn(), plain_fn()
        err = check_dw(results, name, got, want, where)
        if name == "fused_combine_dw" and not torch.equal(got[0], want[0]):
            raise AssertionError(f"{name} at {where}: x2 is not DW._combine's bits")
        if not all(torch.equal(p, q) for p, q in zip(got, kern_fn())):
            raise AssertionError(f"{name} at {where}: a second call gave other bits")
        return err

    def time_pair(name, key, kern_fn, plain_fn, flops, nbytes, unf_fn, where, b) -> dict:
        with torch.inference_mode():
            t = clocks(kern_fn)
            plain_ms = cuda_ms(plain_fn, iters=5 if b > 8 else 10, warmup=2)
            unf = {f"unfused_{k}": v for k, v in clocks(unf_fn).items()}
        bound, by = B.bound_ms(flops, nbytes, B.F32_FLOPS)
        old = dict(zip(OLD_CLOCKS, OLD_DWPAIR[key]))
        log(f"time {name} {where}: kernel {clocks_text(t)}, old kernel {old['old_ms']:.4f} ms, "
            f"device {old['old_device_ms']:.4f} ms, host {old['old_host_us']:.1f} us/call "
            f"(x{old['old_device_ms'] / t['device_ms']:.2f} device), plain {plain_ms:.4f} ms, "
            f"unfused library {clocks_text(unf, 'unfused_')}, bound {bound:.5f} ms ({by})")
        return {**t, **old, **unf, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}

    for c, h in ARM_RAGGED:
        for kk in DW.KERNEL_SIZES:
            (x, y0, dx2, dy7), (a, bv, bias), kern = dw_inputs(8, h, c, kk, gen)
            where = f"(ragged: C={c}, H=W={h}, k={kk}) B=8"
            check_dw(results, "fused_dw_conv", (DW.fused_dw_conv(x, kern),),
                     (DW.dw_conv_math(x, kern),), where)
            check_dw(results, "fused_dw_conv", (DW.fused_dw_conv(x, kern, flip=True),),
                     (DW.dw_conv_math(x, kern.flip(0, 1)),), where + " flip")
            for b in (1, 8, T8_TRAIN_BATCH):
                (x, y0, dx2, dy7), (a, bv, bias), kern = dw_inputs(b, h, c, kk, gen)
                where = f"(ragged: C={c}, H=W={h}, k={kk}) B={b}"
                cases = pair_cases(b, h, c, kk, x, y0, dx2, dy7, a, bv, bias, kern)
                for name, (kern_fn, plain_fn, (flops, nbytes), unf_fn) in cases.items():
                    err = check_pair(name, kern_fn, plain_fn, where)
                    row = time_pair(name, f"{name} C={c} H={h} k={kk} B={b}", kern_fn, plain_fn,
                                    flops, nbytes, unf_fn, where, b)
                    out.setdefault(b, {}).setdefault(f"{name}_ragged", []).append({
                        "C": c, "H": h, "k": kk, **row, "flops": flops, "bytes": nbytes,
                        "max_abs_err": err})
            del x, y0, dx2, dy7
    for b in (1, 8, T8_TRAIN_BATCH):
        for c, h, hidden, n_serve, n_fwd, n_bwd in ARM_STAGES:
            for kk in DW.KERNEL_SIZES:
                (x, y0, dx2, dy7), (a, bv, bias), kern = dw_inputs(b, h, c, kk, gen)
                where = f"t8 stage C={c}, H=W={h}, k={kk} B={b}"
                x_nchw = x.permute(0, 3, 1, 2)  # channels_last, as the model holds it
                w_lib = kern.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
                # The conv's transpose (dw_conv_frozen's dx): the taps read mirrored.
                check_dw(results, "fused_dw_conv", (DW.fused_dw_conv(x, kern, flip=True),),
                         (DW.dw_conv_math(x, kern.flip(0, 1)),), where + " flip")
                err = check_dw(results, "fused_dw_conv", (DW.fused_dw_conv(x, kern),),
                               (DW.dw_conv_math(x, kern),), where)
                flops, nbytes = DW.dwconv_cost(b, h, h, c, kk)
                with torch.inference_mode():
                    t = clocks(lambda: DW.fused_dw_conv(x, kern))
                    plain_ms = cuda_ms(lambda: DW.dw_conv_math(x, kern),
                                       iters=5 if b > 8 else 10, warmup=2)
                    lib = {f"library_{k}": v for k, v in clocks(
                        lambda: F.conv2d(x_nchw, w_lib, None, 1, kk // 2, 1, c)).items()}
                bound, by = B.bound_ms(flops, nbytes, B.F32_FLOPS)
                log(f"time fused_dw_conv {where}: kernel {clocks_text(t)}, plain {plain_ms:.4f} "
                    f"ms, bound {bound:.5f} ms ({by}), cuDNN grouped conv (bf16 taps) "
                    f"{clocks_text(lib, 'library_')}")
                out.setdefault(b, {}).setdefault("fused_dw_conv_stages", []).append({
                    "C": c, "H": h, "k": kk, "launches": n_serve, **t, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": by, **lib, "flops": flops, "bytes": nbytes,
                    "max_abs_err": err})
                cases = pair_cases(b, h, c, kk, x, y0, dx2, dy7, a, bv, bias, kern)
                for name, (kern_fn, plain_fn, (flops, nbytes), unf_fn) in cases.items():
                    err = check_pair(name, kern_fn, plain_fn, where)
                    row = time_pair(name, f"{name} C={c} H={h} k={kk} B={b}", kern_fn, plain_fn,
                                    flops, nbytes, unf_fn, where, b)
                    out[b].setdefault(f"{name}_stages", []).append({
                        "C": c, "H": h, "k": kk,
                        "launches": n_fwd if name == "fused_combine_dw" else n_bwd, **row,
                        **dict.fromkeys(LIBRARY_CLOCKS), "flops": flops, "bytes": nbytes,
                        "max_abs_err": err})
                del x, y0, dx2, dy7
            y, p = convffn_inputs(b, h * h, c, hidden, 8, gen)
            res = torch.randn((b, h * h, c), generator=gen).to("cuda", torch.bfloat16)
            where = f"t8 stage C={c}, H={hidden}, S={h * h}, R=8 B={b}"
            err = check_dw(results, "fused_convffn_res", (CF.fused_convffn_res(y, res, p, 2.0),),
                           (CF.convffn_res_math(y, res, p, 2.0),), where)
            with torch.inference_mode():
                t = clocks(lambda: CF.fused_convffn_res(y, res, p, 2.0))
                plain_ms = cuda_ms(lambda: CF.convffn_res_math(y, res, p, 2.0), iters=5, warmup=2)
            flops, nbytes = CF.convffn_cost(b, h * h, c, hidden, 8, res=True)
            bound, by = B.bound_ms(flops, nbytes)
            old = OLD_CONVFFN[f"t8 stage {ARM_STAGES.index((c, h, hidden, n_serve, n_fwd, n_bwd))}"
                              f" B={b} res"]
            log(f"time fused_convffn_res {where}: kernel {clocks_text(t)}, old kernel "
                f"{old[0]:.4f} ms, device {old[1]:.4f} ms, host {old[2]:.1f} us/call "
                f"(x{old[1] / t['device_ms']:.2f}), plain {plain_ms:.4f} ms, bound {bound:.5f} ms "
                f"({by})")
            out[b].setdefault("fused_convffn_res_stages", []).append({
                "C": c, "H": hidden, "S": h * h, "launches": n_fwd, **t,
                **dict(zip(OLD_CLOCKS, old)),
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                **dict.fromkeys(LIBRARY_CLOCKS), "flops": flops, "bytes": nbytes,
                "max_abs_err": err})
            del y, p, res
    B.LAUNCHES.update(saved)  # checks and timing launches are not main-path launches

    # Sums over the launches of one serving forward (batch 1) or one step (128).
    for name, b in (("fused_dw_conv", 1), ("fused_combine_dw", T8_TRAIN_BATCH),
                    ("fused_combine_dw_bwd", T8_TRAIN_BATCH),
                    ("fused_convffn_res", T8_TRAIN_BATCH)):
        rows = [r for r in out[b][f"{name}_stages"] if r.get("k", 7) == 7]
        keys = ("ms", "device_ms", "host_us", "plain_ms", "flops", "bytes") + (
            OLD_CLOCKS if name in ("fused_convffn_res", *PAIR_NAMES) else ()) + (
            UNFUSED_CLOCKS if name in PAIR_NAMES else ())
        total = {k: sum(r["launches"] * r[k] for r in rows) for k in keys}
        bound, by = (B.bound_ms(total["flops"], total["bytes"]) if name == "fused_convffn_res"
                     else B.bound_ms(total["flops"], total["bytes"], B.F32_FLOPS))
        out[b][name] = {**{k: total[k] for k in keys if k not in ("flops", "bytes")},
                        "bound_ms": bound, "bound_by": by, **{
                            k: None if rows[0][k] is None else sum(r["launches"] * r[k]
                                                                   for r in rows)
                            for k in LIBRARY_CLOCKS}}
        log(f"time {name} t8 {'forward' if b == 1 else 'step'} "
            f"({sum(r['launches'] for r in rows)} launches, k=7) B={b}: " + json.dumps(out[b][name]))
    return out


def phase_tp(results: dict) -> dict:
    """One tensor-parallel shard's kernels against their plain versions, on
    every shard: the attention half's partial product, the MLP half's and
    its partial dx (a unit-scale seeded cotangent) at dinov2-base's shard
    shapes (tp = 2) at B = 1, 8 and 128 and dinov2-large's (tp = 2 and 4)
    at B = 1 and 8, bf16, S = 257 (``shard_check``); the shards' all-reduce
    plus the bias (and the MLP half's LayerScale and residual) against the
    whole half's plain version. Then shard 0's kernel, plain and bound times
    (the shard's widths in ``block_flops``/``block_bytes``). Returns the
    times by batch: dinov2-base's under the wrapper's name, dinov2-large's
    under ``<name>_dinov2_large_tp<tp>``."""
    from dino_pose_tpu_torch.core.mesh import MeshSpec, create_mesh
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.ops import dispatch

    gen = torch.Generator().manual_seed(SEED + 15)
    saved = dict(B.LAUNCHES)
    by_batch: dict = {}
    for model, (d, heads, hidden, tp) in TP_SHAPES.items():
        with dispatch.scoped():
            mesh = create_mesh(MeshSpec(1, tp))
        flops = B.block_flops(S, d, hidden, tp)
        suffix = "" if model == "dinov2-base" else f"_dinov2_large_tp{tp}"
        where = f"({model.split('-tp')[0]} shard: D={d}, tp={tp}, {heads // tp} heads, " \
                f"MLP {hidden // tp})"
        for b in ((1, 8, TRAIN_BATCH) if model == "dinov2-base" else (1, 8)):
            x, p = block_inputs(b, gen, S, d, hidden)
            dp = torch.randn((b, S, d), generator=gen).to("cuda", torch.bfloat16)
            ap, mp = B.attn_params(p), B.mlp_params(p)
            parts_a, parts_m = [], []
            for r in range(tp):
                pa = B.AttnPartialParams(*(t.contiguous() for t in B.shard_attn(ap, tp, r)))
                pm = B.MlpPartialParams(*(t.contiguous() for t in B.shard_mlp(mp, tp, r)))
                cases = {
                    "fused_attn_part_partial": (
                        lambda: B.fused_attn_part_partial(x, pa, heads // tp, EPS),
                        lambda: B.attn_part_math_partial(x, pa, num_heads=heads // tp, eps=EPS),
                        (x, pa, heads // tp, EPS)),
                    "fused_mlp_part_partial": (lambda: B.fused_mlp_part_partial(x, pm, EPS),
                                               lambda: B.mlp_part_math_partial(x, pm, eps=EPS),
                                               (x, pm, EPS)),
                    "fused_mlp_partial_dx": (lambda: B.fused_mlp_partial_dx(x, dp, pm, EPS),
                                             lambda: B.mlp_partial_dx_math(x, dp, pm, eps=EPS),
                                             (x, dp, pm, EPS)),
                }
                for name, (kern, plain, args) in cases.items():
                    got = kern()
                    max_abs, fro, noise, ok = shard_check(got, plain(), shard_f32(name, args),
                                                          name == "fused_attn_part_partial")
                    log(f"kernel {name} B={b} shard {r} {where}: max_abs={max_abs:.6g} "
                        f"rel_fro={fro:.4g} (plain bf16 vs f32 {noise:.4g}) -> "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{name} shard {r} at B={b} {where} disagrees with "
                                             "its plain version")
                    row = results.setdefault(name + suffix, {"max_abs_err": 0.0})
                    row["max_abs_err"] = max(row["max_abs_err"], max_abs)
                    if name == "fused_attn_part_partial":
                        parts_a.append(got)
                    elif name == "fused_mlp_part_partial":
                        parts_m.append(got)
                    if r == 0:
                        time_kernel(by_batch, name + suffix, b, kern, plain, b * flops[name],
                                    B.block_bytes(b, S, d, hidden, tp)[name],
                                    *((20, 10, 2) if b < TRAIN_BATCH else (10, 3, 1)))
            # The all-reduce of the shards' partials and the half's tail.
            o = mesh.all_reduce(parts_a) + ap.bo.to(torch.bfloat16)
            want = B.attn_part_math(x, ap, num_heads=heads, eps=EPS)
            f32 = B.AttnParams(*(t.float() for t in ap))
            max_abs, fro, noise, ok = shard_check(
                o, want, B.attn_part_math(x.float(), f32, num_heads=heads, eps=EPS), True)
            y = x + (mesh.all_reduce(parts_m) + mp.bf2.to(torch.bfloat16)) * mp.ls2.to(
                torch.bfloat16)
            y_err = (y.float() - B.mlp_part_math(x, mp, eps=EPS).float()).abs().max().item()
            ok &= torch.allclose(y.float(), B.mlp_part_math(x, mp, eps=EPS).float(),
                                 atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
            log(f"kernel all_reduce(shards) + bias B={b} {where}: attention half max_abs="
                f"{max_abs:.6g} rel_fro={fro:.4g} (plain bf16 vs f32 {noise:.4g}) vs "
                f"attn_part_math; MLP half max_abs={y_err:.6g} vs mlp_part_math (tol atol "
                f"{KERNEL_ATOL} + rtol {KERNEL_RTOL}*|ref|) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the shards' sum at B={b} {where} disagrees with the "
                                     "whole half")
            if model != "dinov2-base" and b == 1:
                # x2's cotangent through mlp_part_tp under autograd, where
                # JAX's backward takes its unfused vjp at tp = 2: every
                # shard's fused_mlp_partial_dx, against the plain path.
                shards = [B.MlpPartialParams(*(t.contiguous() for t in B.shard_mlp(mp, tp, r)))
                          for r in range(tp)]
                grads = []
                for kernels in (True, False):
                    before = B.LAUNCHES["fused_mlp_partial_dx"]
                    xg = x.clone().requires_grad_()
                    B.mlp_part_tp(xg, mp, EPS, mesh, kernels=kernels, shards=shards).backward(dp)
                    grads.append(xg.grad.float())
                    launched = B.LAUNCHES["fused_mlp_partial_dx"] - before
                    if launched != (tp if kernels else 0):
                        raise AssertionError(f"mlp_part_tp's backward {where} launched "
                                             f"fused_mlp_partial_dx {launched} times")
                err = (grads[0] - grads[1]).abs()
                ok = bool(torch.isfinite(grads[0]).all()) and bool(
                    (err <= KERNEL_ATOL + KERNEL_RTOL * grads[1].abs()).all())
                log(f"kernel mlp_part_tp backward B=1 {where}: {tp} fused_mlp_partial_dx, "
                    f"x2 grad max_abs={err.max().item():.6g} vs the plain path (tol atol "
                    f"{KERNEL_ATOL} + rtol {KERNEL_RTOL}*|ref|) -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"mlp_part_tp's backward {where} disagrees with the "
                                         "plain path")
                del shards, grads, xg
            del x, p, dp, cases, parts_a, parts_m, o, y
    B.LAUNCHES.update(saved)  # checks and timing launches are not main-path launches
    return by_batch


def phase_fastvit_tp_kernels(results: dict) -> None:
    """The ConvFFN kernels and the flash pair at FastViT's shard widths
    under a (1, 2) mesh. For every fastvit_t8 and fastvit_sa12 stage (256²),
    one seeded ConvFFN at rank 8 with Dropout2d-style masks, cut as
    models/fastvit.py cuts it (hidden units [r*H/2, (r+1)*H/2): fc1's
    columns, its bias and LoRA B columns, fc2's rows and LoRA A rows, fc2's
    bias zero): each shard's fused_convffn at B = 1, 8 and the train batch
    (128, 32) and its fused_convffn_bwd (a unit-scale seeded cotangent) at
    the train batch, against convffn_math / convffn_bwd_math on the same
    cut (``compare_outputs``: the kernel tolerance, gradients within
    GRAD_TOL); the mesh's all-reduce of the shards' outputs plus fc2's bias
    against the whole ConvFFN's plain version. Then flash_attention at
    sa12's shard of 8 heads of 32 over S = 64, B = 1, 8, 32. Checks are not
    main-path launches."""
    from dino_pose_tpu_torch.core.mesh import Mesh, MeshSpec
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.ops import convffn as CF

    gen = torch.Generator().manual_seed(SEED + 50)
    mesh = Mesh(MeshSpec(1, TP))
    saved = dict(B.LAUNCHES)
    r = 8
    s_lora = 16.0 / r
    for model, train_batch in (("t8", T8_TRAIN_BATCH), ("sa12", SA12_TRAIN_BATCH)):
        for b in (1, 8, train_batch):
            for i, (c, h, s, _) in enumerate(CONVFFN_STAGES[model]):
                y, p = convffn_inputs(b, s, c, h, r, gen)
                df = cuda_randn((b, s, c), gen).to(torch.bfloat16)
                n = h // TP
                parts = []
                for sh in range(TP):
                    def cut(t, dim, sh=sh):
                        return t.narrow(dim, sh * n, n).clone()

                    ps = p._replace(w1=cut(p.w1, 1), b1=cut(p.b1, 0), w2=cut(p.w2, 0),
                                    b2=torch.zeros_like(p.b2), b1l=cut(p.b1l, 1),
                                    a2=cut(p.a2, 0))
                    where = f"{model} stage {i} shard {sh} (C={c}, H/tp={n}, S={s}, R={r}) B={b}"
                    cases = [("fused_convffn", (CF.fused_convffn(y, ps, s_lora),),
                              (CF.convffn_math(y, ps, s_lora),))]
                    if b == train_batch:
                        cases.append(("fused_convffn_bwd",
                                      flat(CF.fused_convffn_bwd(y, df, ps, s_lora)),
                                      flat(CF.convffn_bwd_math(y, df, ps, s_lora))))
                    parts.append(cases[0][1][0])
                    torch.cuda.synchronize()
                    for name, got, want in cases:
                        act_err, grad_rel, ok = compare_outputs(got, want)
                        log(f"kernel {name} {where}: max_abs={act_err:.6g}"
                            + (f" max_err/max|ref|(grads)={grad_rel:.6g}" if len(got) > 1
                               else "") + f" -> {'ok' if ok else 'FAIL'}")
                        if not ok:
                            raise AssertionError(f"{name} at {where} disagrees with its plain "
                                                 "version")
                        row = results.setdefault(name, {"max_abs_err": 0.0})
                        row["max_abs_err"] = max(row["max_abs_err"], act_err)
                        if len(got) > 1:
                            row["max_grad_err_rel"] = max(row.get("max_grad_err_rel", 0.0),
                                                          grad_rel)
                total = mesh.all_reduce(parts) + p.b2.to(torch.bfloat16)
                act_err, _, ok = compare_outputs((total,), (CF.convffn_math(y, p, s_lora),))
                log(f"kernel all_reduce(fused_convffn shards) + b2 {model} stage {i} B={b}: "
                    f"max_abs={act_err:.6g} vs the whole ConvFFN's plain version (tol atol "
                    f"{KERNEL_ATOL} + rtol {KERNEL_RTOL}*|ref|) -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"the ConvFFN shards' sum at {model} stage {i} B={b} "
                                         "disagrees with the whole ConvFFN")
                del y, p, df, parts, total
    heads, sq, dh = SA12_TP_FLASH_SHAPE
    for b in (1, 8, SA12_TRAIN_BATCH):
        check_flash(results, *flash_inputs(b, gen, SA12_TP_FLASH_SHAPE),
                    f"B={b} (fastvit_sa12 shard: {heads} heads of {dh}, S={sq})")
    torch.cuda.synchronize()
    B.LAUNCHES.update(saved)


def phase_fastvit_tp_one_card(tag: str, config: dict, batch_size: int) -> dict:
    """A FastViT + LoRA model under the (1, 2) mesh against the same seeded
    model on one card (tp = 1), both on the kernels: a batch-8 eval forward
    (heatmaps and z) and the step-1 gradients of FASTVIT_GRAD_NAMES on the
    seeded batch. The tp = 2 forward must sit from the one-card forward no
    farther than plain bf16 sits from plain f32 (relative Frobenius); the
    tp = 2 gradients by the bf16 noise rule: within GRAD_NOISE_FACTOR times
    the plain bf16 step's distance from the f32 one, plus GRAD_NOISE_SLACK.
    Launches restored."""
    from dino_pose_tpu_torch.core.mesh import MeshSpec, create_mesh
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.ops import dispatch

    model = seeded_model(config)
    saved = dict(B.LAUNCHES)
    pixels = synthetic_batch(8, FASTVIT_IMAGE, seed=3)["image"]
    batch = synthetic_batch(batch_size, FASTVIT_IMAGE)
    runs: dict = {}
    for which, kernels, dtype, tp in (("tp2", True, torch.bfloat16, TP),
                                      ("one", True, torch.bfloat16, 1),
                                      ("plain", False, torch.bfloat16, 1),
                                      ("f32", False, torch.float32, 1)):
        with dispatch.scoped():
            if tp > 1:
                create_mesh(MeshSpec(1, tp))
            with torch.inference_mode():
                hm, z = model.eval()(pixels.to(dtype), kernels=kernels)
            grads = step1_grads(model, config, kernels, dtype, batch, FASTVIT_IMAGE,
                                FASTVIT_GRAD_NAMES)
        runs[which] = {"hm": hm.float(), "z": z.float(), "grads": grads}
    torch.cuda.synchronize()
    B.LAUNCHES.update(saved)
    out: dict = {"forward": {}, "grads": {}}
    bad = []
    for k in ("hm", "z"):
        d_tp, noise = rel_err(runs["tp2"][k], runs["one"][k]), rel_err(runs["plain"][k],
                                                                       runs["f32"][k])
        ok = bool(torch.isfinite(runs["tp2"][k]).all()) and d_tp <= noise
        out["forward"][k] = {"tp2_vs_one_card": d_tp, "plain_vs_f32": noise,
                             "tp2_vs_f32": rel_err(runs["tp2"][k], runs["f32"][k])}
        log(f"{tag} forward {k} (batch 8): rel Frobenius tp=2 vs one card {d_tp:.4g}, plain "
            f"bf16 vs f32 {noise:.4g} (the limit), tp=2 vs f32 "
            f"{out['forward'][k]['tp2_vs_f32']:.4g} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"forward {k}")
    for n in FASTVIT_GRAD_NAMES:
        f32 = runs["f32"]["grads"][n]
        k_ref, p_ref = rel_err(runs["tp2"]["grads"][n], f32), rel_err(runs["plain"]["grads"][n],
                                                                      f32)
        one = rel_err(runs["one"]["grads"][n], f32)
        tol = GRAD_NOISE_FACTOR * p_ref + GRAD_NOISE_SLACK
        ok = bool(torch.isfinite(runs["tp2"]["grads"][n]).all()) and k_ref <= tol
        out["grads"][n] = {"tp2_vs_f32": k_ref, "one_card_vs_f32": one, "plain_vs_f32": p_ref,
                           "tp2_vs_one_card": rel_err(runs["tp2"]["grads"][n],
                                                      runs["one"]["grads"][n])}
        log(f"{tag} step-1 grad {n}: rel Frobenius vs f32: tp=2 {k_ref:.4g}, one card "
            f"{one:.4g}, plain bf16 {p_ref:.4g} (tol {GRAD_NOISE_FACTOR}*plain+"
            f"{GRAD_NOISE_SLACK} = {tol:.4g}); tp=2 vs one card "
            f"{out['grads'][n]['tp2_vs_one_card']:.4g} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"grad {n}")
    if bad:
        raise AssertionError(f"{tag}: tp=2 vs the one-card route out of tolerance: {bad}")
    return out


def phase_mlp_heads(results: dict) -> dict:
    """models/heads.PoseHeads (the MLP variant) at heatmap 48 and 40: seeded
    on the CPU with its running statistics moved off (0, 1), its eval
    forward in f32 there, the same weights on the card in bf16 on the same
    features. Heatmaps and z within MODEL_REL_TOL of the f32 result's
    largest magnitude, as a served model is held against its plain path."""
    from dino_pose_tpu_torch.models.heads import PoseHeads

    out = {}
    gen = torch.Generator().manual_seed(SEED + 60)
    feats = torch.randn((MLP_HEADS_BATCH, MLP_HEADS_FEATURES), generator=gen)
    for hm_size in (48, 40):
        torch.manual_seed(SEED + hm_size)
        heads = PoseHeads(MLP_HEADS_FEATURES, 24, hm_size)
        with torch.no_grad():
            for m in heads.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                    m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
        heads.eval()
        with torch.inference_mode():
            want = heads(feats)
            card = copy.deepcopy(heads).to("cuda", torch.bfloat16)
            got = card(feats.to("cuda", torch.bfloat16))
            torch.cuda.synchronize()
        row = {}
        for name, g, w in zip(("heatmaps", "z"), got, want):
            g = g.float().cpu()
            err, scale = (g - w).abs().max().item(), w.abs().max().item()
            ok = g.shape == w.shape and bool(torch.isfinite(g).all()) and err <= MODEL_REL_TOL * scale
            row[name] = {"max_abs": err, "max_ref": scale, "rel_fro": rel_err(g, w), "ok": ok}
            log(f"mlp_heads heatmap {hm_size} {name} {tuple(g.shape)} (card bf16 vs CPU f32): "
                f"max_abs={err:.6g} vs {MODEL_REL_TOL}*max|ref|={MODEL_REL_TOL * scale:.6g}, "
                f"rel_fro={row[name]['rel_fro']:.4g} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"PoseHeads at heatmap {hm_size}: {name} on the card "
                                     "disagrees with the CPU")
        out[hm_size] = row
    return out


def cuda_randn(shape: tuple, gen: torch.Generator) -> torch.Tensor:
    """Standard-normal f32 of ``shape`` drawn on the card by a CUDA
    generator seeded from ``gen``: the row operands of the GEMM and
    attention-core checks run to 32896 x 4096, the ConvFFN checks' rows to
    128 x 4096 x 512, which would cost the host more than the checks."""
    seed = int(torch.randint(0, 2**62, (1,), generator=gen))
    return torch.randn(shape, generator=torch.Generator("cuda").manual_seed(seed),
                       device="cuda")


def gemm_shapes() -> list:
    """(label, K, N, epilogues) of every product in GEMM_MODELS."""
    shapes = []
    for model, (d, hidden, tp) in GEMM_MODELS.items():
        kn = {"qkv": (d, 3 * d // tp), "out": (d // tp, d), "fc1": (d, hidden // tp),
              "fc2": (hidden // tp, d)}
        for prod, (k, n) in kn.items():
            shapes.append((f"{model} {prod}", k, n, GEMM_EPIS[prod][tp > 1]))
    return shapes


def outputs(out) -> tuple:
    """A wrapper's output as a tuple of tensors."""
    return out if isinstance(out, tuple) else (out,)


def check_gemm(got, want, label: str) -> float:
    """One fused_gemm output against gemm_math's: elementwise at the kernel
    tolerance and within ATTN_FRO in relative Frobenius norm (a sum-order
    difference flips single bf16 roundings; a dropped K tile or a wrong
    swizzle moves the whole tensor). Returns the largest error."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    fro = (diff.norm() / want.norm().clamp_min(1e-30)).item()
    ok = (bool(torch.isfinite(got).all()) and fro <= ATTN_FRO
          and bool((diff <= KERNEL_ATOL + KERNEL_RTOL * want.abs()).all()))
    if not ok:
        raise AssertionError(f"fused_gemm {label} disagrees with gemm_math: max_abs="
                             f"{diff.max().item():.6g} rel_fro={fro:.4g}")
    return diff.max().item()


def phase_gemm(results: dict) -> dict:
    """The chains' GEMM kernel alone (fused_gemm) against gemm_math at every
    (epilogue, shape) of gemm_shapes() and every M of GEMM_ROWS, twice with
    the same bits; then, for the epilogue-free product, three clocks of the
    kernel and of torch.matmul (cuBLAS, bf16 in, f32 sums, one rounding:
    the same function) beside the old kernel's (OLD_GEMM), TFLOP/s on
    2*M*N*K at the device clock and the bound. Returns the times by label."""
    from dino_pose_tpu_torch.ops import block as B

    gen = torch.Generator().manual_seed(SEED + 17)
    saved = dict(B.LAUNCHES)
    # cuBLAS's yardstick sums in f32 and rounds once, as the kernel does.
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out: dict = {}
    worst = 0.0
    for d in (D, 768, 1024):
        # The LayerNorm rows every chain's first product reads: the old
        # prologue's arithmetic, against the plain LayerNorm's one rounding.
        x = (cuda_randn((TRAIN_BATCH * S, d), gen) * 3 + 1).to(torch.bfloat16)
        g = (torch.rand(d, generator=gen) + 0.5).cuda()
        b = (torch.randn(d, generator=gen) * 0.1).cuda()
        got, want = B.ln_rows(x, g, b, EPS), B._ln_fwd(x, g, b, EPS)[0]
        mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(1e-30)
        err = (got.float() - want.float()).abs()
        flips = (got != want).float().mean().item()
        ok = flips <= 1e-3 and bool((err <= torch.exp2(torch.floor(torch.log2(mag)) - 7)
                                     + 1e-5).all())
        log(f"kernel ln_rows ({TRAIN_BATCH * S}, {d}): {flips:.3g} of elements round the other "
            f"way, max_abs={err.max().item():.6g} (tol one ulp + 1e-5, at most 1e-3 flipped) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ln_rows at D={d} disagrees with the plain LayerNorm")
        del x, got, want
    for label, k, n, epis in gemm_shapes():
        w = (torch.randn((k, n), generator=gen) * k**-0.5).to("cuda", torch.bfloat16)
        bias = (torch.randn(n, generator=gen) * 0.05).cuda()
        ls = (torch.rand(n, generator=gen) * 0.9 + 0.1).cuda()
        for m in GEMM_ROWS:
            a = cuda_randn((m, k), gen).to(torch.bfloat16)
            res = cuda_randn((m, n), gen).to(torch.bfloat16)
            for epi in epis:
                kw = {"bias": bias, "ls": ls, "res": res}
                with torch.inference_mode():
                    got = outputs(B.fused_gemm(a, w, epi, **kw))
                    again = outputs(B.fused_gemm(a, w, epi, **kw))
                    want = outputs(B.gemm_math(a, w, epi, **kw))
                torch.cuda.synchronize()
                if not all(torch.equal(g, h) for g, h in zip(got, again)):
                    raise AssertionError(f"fused_gemm {label} M={m} {epi}: two runs differ")
                for i, (g, h) in enumerate(zip(got, want)):
                    worst = max(worst, check_gemm(g, h, f"{label} M={m} {epi} output {i}"))
            log(f"kernel fused_gemm {label} M={m} K={k} N={n} ({', '.join(epis)}): ok, "
                f"same bits twice")
            flops, nbytes = B.gemm_cost(m, n, k)
            bound, by = B.bound_ms(flops, nbytes)
            iters = 10 if m > 8 * S else 20
            with torch.inference_mode():
                kern = clocks(lambda: B.fused_gemm(a, w, "none"), iters=iters)
                lib = clocks(lambda: torch.matmul(a, w), iters=iters)
            key = f"{label} M={m}"
            old = OLD_GEMM[label][GEMM_ROWS.index(m)] if label in OLD_GEMM else None
            t = {"M": m, "K": k, "N": n, **kern, **{f"library_{x}": v for x, v in lib.items()},
                 "tflops": flops / kern["device_ms"] / 1e9,
                 "library_tflops": flops / lib["device_ms"] / 1e9, "bound_ms": bound,
                 "bound_by": by}
            if old:
                t.update(old_ms=old[0], old_device_ms=old[1], old_host_us=old[2])
            out[key] = t
            old_text = "" if old is None else \
                f", old kernel {old[0]:.4f} ms, device {old[1]:.4f} ms, host {old[2]:.1f} us/call"
            log(f"time fused_gemm {key} K={k} N={n}: kernel {clocks_text(kern)} "
                f"({t['tflops']:.1f} TFLOP/s), torch.matmul {clocks_text(lib)} "
                f"({t['library_tflops']:.1f} TFLOP/s){old_text}, bound {bound:.5f} ms ({by})")
            del a, res, got, again, want
        del w
    results.setdefault("fused_gemm", {"max_abs_err": 0.0})["max_abs_err"] = worst
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    B.LAUNCHES.update(saved)
    return out


def gemm_bwd_shapes() -> list:
    """(label, kind, K or K_in, N, forms, rows) of every backward product in
    GEMM_BWD_MODELS."""
    shapes = []
    for model, (d, hidden, tp) in GEMM_BWD_MODELS.items():
        rows = GEMM_ROWS + ((LONG_BATCH * S_LONG,) if model == "dinov2-small" else ())
        for i, (prod, (kind, kn, forms)) in enumerate(GEMM_BWD_PRODUCTS.items()):
            if tp > 1 and prod not in ("dh1b", "dm"):
                continue
            forms = GEMM_BWD_SHARD[i] if tp > 1 else forms
            shapes.append((f"{model} {prod}", kind, *kn(d, hidden // tp), forms, rows))
    return shapes


def check_sums(got: torch.Tensor, want: torch.Tensor, label: str) -> float:
    """An f32 sum over every row (a weight gradient, column sums) against the
    plain version's: elementwise within GRAD_TOL of its largest magnitude
    (the same bf16 terms, added in another order). Returns the largest
    error over that magnitude."""
    err = (got - want).abs().max().item() / want.abs().max().clamp_min(1e-30).item()
    if not (bool(torch.isfinite(got).all()) and err <= GRAD_TOL):
        raise AssertionError(f"{label} disagrees with its plain version: max_abs/max|ref| = "
                             f"{err:.4g} (tol {GRAD_TOL})")
    return err


def phase_gemm_bwd(results: dict) -> dict:
    """The chains' backward products alone (fused_gemm_nt, fused_gemm_tn)
    against gemm_nt_math / gemm_tn_math at every product, form and M of
    gemm_bwd_shapes(), twice with the same bits; bf16 and f32 outputs as
    check_gemm, the f32 sums (dW, column sums) as check_sums. Then the timed
    form's three clocks beside torch.matmul's on the same bf16 operands
    (a @ w^T, a^T @ g; cuBLAS rounds its output to bf16, else the same
    product), the bare product's where the timed form does more (the GELU
    gradient, column sums), and the old kernels' (OLD_GEMM_BWD), TFLOP/s on
    2*M*N*K at the device clock and the bound (gemm_nt_cost, gemm_tn_cost).
    Returns the times by label."""
    from dino_pose_tpu_torch.ops import block as B

    gen = torch.Generator().manual_seed(SEED + 19)
    saved = dict(B.LAUNCHES)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out: dict = {}
    worst = {"fused_gemm_nt": 0.0, "fused_gemm_tn": 0.0}
    for label, kind, k, n, forms, rows in gemm_bwd_shapes():
        name = f"fused_gemm_{kind}"
        # nt: w (N, K), the forward weight read transposed; tn: the scale
        # multiplies g's N columns.
        w = (torch.randn((n, k), generator=gen) * k**-0.5).to("cuda", torch.bfloat16)
        scale = (torch.rand(k if kind == "nt" else n, generator=gen) * 0.9 + 0.1).cuda()
        for m in rows:
            a = cuda_randn((m, k), gen).to(torch.bfloat16)
            other = (cuda_randn((m, n), gen) * 2).to(torch.bfloat16)
            for form in forms:
                sc = scale if form.get("scale") else None
                if kind == "nt":
                    args = (a, w, form["epi"])
                    kw = {"scale": sc, "aux": other, "colsum": form.get("colsum", False)}
                    kern, plain = B.fused_gemm_nt, B.gemm_nt_math
                else:
                    args, kw = (a, other), {"scale": sc, "gsum": form.get("gsum", False)}
                    kern, plain = B.fused_gemm_tn, B.gemm_tn_math
                with torch.inference_mode():
                    got = outputs(kern(*args, **kw))
                    again = outputs(kern(*args, **kw))
                    want = outputs(plain(*args, **kw))
                torch.cuda.synchronize()
                what = f"{name} {label} M={m} {form}"
                if not all(torch.equal(g, h) for g, h in zip(got, again)):
                    raise AssertionError(f"{what}: two runs differ")
                for i, (g, h) in enumerate(zip(got, want)):
                    check = check_gemm if kind == "nt" and i == 0 else check_sums
                    worst[name] = max(worst[name], check(g, h, f"{what} output {i}"))
                del got, again, want
            log(f"kernel {name} {label} M={m} K={k} N={n} ({len(forms)} forms): ok, same bits "
                "twice")
            timed = forms[0]
            if kind == "nt":
                flops, nbytes = B.gemm_nt_cost(m, n, k, timed["epi"], timed.get("colsum", False))

                def kfn():
                    return B.fused_gemm_nt(a, w, timed["epi"], aux=other,
                                           colsum=timed.get("colsum", False))

                def lfn():
                    return torch.matmul(a, w.t())
            else:
                flops, nbytes = B.gemm_tn_cost(m, k, n, timed.get("gsum", False))

                def kfn():
                    return B.fused_gemm_tn(a, other, gsum=timed.get("gsum", False))

                def lfn():
                    return torch.matmul(a.t(), other)
            bound, by = B.bound_ms(flops, nbytes)
            iters = 10 if m > 8 * S else 20
            with torch.inference_mode():
                kt = clocks(kfn, iters=iters)
                lt = clocks(lfn, iters=iters)
                # Where the chains' form does more than the bare product
                # (the GELU gradient, column sums), the bare one too: what
                # torch.matmul computes.
                bare = None
                if timed.get("epi") == "gelu_grad" or timed.get("gsum"):
                    bare = clocks((lambda: B.fused_gemm_nt(a, w, "bf16")) if kind == "nt"
                                  else (lambda: B.fused_gemm_tn(a, other)), iters=iters)
            key = f"{label} M={m}"
            old = OLD_GEMM_BWD.get(key)
            t = {"M": m, "K": k, "N": n, "form": timed, **kt,
                 **{f"library_{x}": v for x, v in lt.items()},
                 **({f"bare_{x}": v for x, v in bare.items()} if bare else {}),
                 "tflops": flops / kt["device_ms"] / 1e9,
                 "library_tflops": flops / lt["device_ms"] / 1e9, "bound_ms": bound,
                 "bound_by": by}
            if old:
                t.update(old_ms=old[0], old_device_ms=old[1], old_host_us=old[2])
            out[key] = t
            old_text = "" if old is None else \
                f", old kernel {old[0]:.4f} ms, device {old[1]:.4f} ms, host {old[2]:.1f} us/call"
            bare_text = "" if bare is None else \
                f", bare product {clocks_text(bare)} ({flops / bare['device_ms'] / 1e9:.1f} TFLOP/s)"
            log(f"time {name} {key} K={k} N={n} {timed}: kernel {clocks_text(kt)} "
                f"({t['tflops']:.1f} TFLOP/s), torch.matmul {clocks_text(lt)} "
                f"({t['library_tflops']:.1f} TFLOP/s){bare_text}{old_text}, bound {bound:.5f} ms "
                f"({by})")
            del a, other
        del w
    for name, err in worst.items():
        results.setdefault(name, {"max_abs_err": 0.0})["max_abs_err"] = err
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    B.LAUNCHES.update(saved)
    return out


def attention_core_inputs(b: int, heads: int, s: int, dh: int, gen: torch.Generator):
    """A seeded packed qkv (b, s, 3*heads*dh) and a unit-scale cotangent of its
    ctx (b, s, heads*dh), bf16 on the card."""
    qkv = cuda_randn((b, s, 3 * heads * dh), gen).to(torch.bfloat16)
    dctx = cuda_randn((b, s, heads * dh), gen).to(torch.bfloat16)
    return qkv, dctx


def check_attention_core(results: dict, qkv, dctx, heads: int, streamed: bool,
                         where: str) -> None:
    """The attention step alone (packed_attention, packed_attention_bwd) on
    one route against its plain versions: ctx, and dq, dk, dv of dqkv, at the
    attention tolerance with FLASH_FRO. The resident kernels' largest errors
    are kept under attention_core and attention_core_bwd. The backward is
    held where its route takes the shape (the resident pair up to S = 304 at
    head width 64)."""
    from dino_pose_tpu_torch.ops import _ext
    from dino_pose_tpu_torch.ops import block as B

    b, s, d3 = qkv.shape
    dh = d3 // 3 // heads
    kind = "flash" if streamed else "resident"
    cases = [("attention_core", lambda: (B.packed_attention(qkv, heads, streamed=streamed),),
              lambda: (B._heads_attention(qkv, heads),), "ctx")]
    if streamed or not _ext.lib().dp_flash_backward(s, dh):
        cases.append(("attention_core_bwd",
                      lambda: B.packed_attention_bwd(qkv, dctx, heads, streamed=streamed).chunk(3, -1),
                      lambda: B.packed_attention_bwd_math(qkv, dctx, heads).chunk(3, -1),
                      "dq dk dv"))
    for name, kern, plain, outs in cases:
        with torch.inference_mode():
            got, want = kern(), plain()
        torch.cuda.synchronize()
        # At S = 1 dq and dk are zero (P = 1, dS = 0), where a relative norm
        # means nothing: held to the tolerance's absolute part.
        errs, fros, oks = zip(*(
            attn_check(x, w, FLASH_FRO) if bool(w.any()) else
            (x.float().abs().max().item(), 0.0, bool((x.float().abs() <= ATTN_ATOL).all()))
            for x, w in zip(got, want)))
        ok = all(oks)
        log(f"kernel {name} {kind} {where}: max_abs ({outs}) = "
            f"{' '.join(f'{e:.6g}' for e in errs)} rel_fro = {' '.join(f'{e:.4g}' for e in fros)} "
            f"tol={attn_tol_text(FLASH_FRO)} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {kind} at {where} disagrees with its plain version")
        if not streamed:
            row = results.setdefault(name, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], *errs)
        del got, want


def phase_attention_core(results: dict) -> dict:
    """The chains' attention step alone on the packed layout: the resident
    pair (attn_fwd_kernel; attn_bwd_dq_kernel + attn_bwd_dkv_kernel, through
    packed_attention and packed_attention_bwd) and the streamed flash pair
    held against their plain versions at every ROUTE_HEADS shape (S = 257)
    at B = 1 and 8, and at ATTN_CORE_SEQS (head widths 64 and 32); then at
    each ROUTE_HEADS shape and B = 1, 8, 128 both routes' forward and
    backward on the three ``clocks`` beside torch's
    scaled_dot_product_attention (forward, and its backward alone on a kept
    graph) on (B, H, S, dh) views of the same tensors, the library
    yardstick, which the port never calls; the old WMMA kernels' times
    (OLD_ATTN); TFLOP/s on JAX's FLOPs at the device clock (and, for the
    resident kernels, on the FLOPs they execute); and the bound
    (attention_core_cost). Returns the times by shape, dinov2-small's at
    B = 128 also under the batch for the kernels line."""
    import torch.nn.functional as F

    from dino_pose_tpu_torch.ops import block as B

    gen = torch.Generator().manual_seed(SEED + 18)
    saved = dict(B.LAUNCHES)
    out: dict = {}
    for heads, dh in ((H, 64), (2 * H, 32)):
        for s in ATTN_CORE_SEQS:
            qkv, dctx = attention_core_inputs(2, heads, s, dh, gen)
            for streamed in (False, True):
                check_attention_core(results, qkv, dctx, heads, streamed,
                                     f"B=2 ({heads} heads of {dh}, S={s})")
            del qkv, dctx
    for model, heads in ROUTE_HEADS.items():
        for b in (1, 8, TRAIN_BATCH):
            qkv, dctx = attention_core_inputs(b, heads, S, 64, gen)
            where = f"{model} B={b}"
            if b < TRAIN_BATCH:
                for streamed in (False, True):
                    check_attention_core(results, qkv, dctx, heads, streamed,
                                         f"B={b} ({model}: {heads} heads, S={S})")
            views = qkv.view(b, S, 3, heads, 64).permute(2, 0, 3, 1, 4)
            leaf = qkv.detach().requires_grad_()
            lviews = leaf.view(b, S, 3, heads, 64).permute(2, 0, 3, 1, 4)
            sdpa_out = F.scaled_dot_product_attention(*lviews)
            dout = dctx.view(b, S, heads, 64).transpose(1, 2)
            iters = 10 if b == TRAIN_BATCH else 20
            with torch.inference_mode():
                t = {
                    "fwd": clocks(lambda: B.packed_attention(qkv, heads, streamed=False),
                                  iters=iters),
                    "bwd": clocks(lambda: B.packed_attention_bwd(qkv, dctx, heads,
                                                                 streamed=False), iters=iters),
                    "flash_fwd": clocks(lambda: B.packed_attention(qkv, heads, streamed=True),
                                        iters=iters),
                    "flash_bwd": clocks(lambda: B.packed_attention_bwd(qkv, dctx, heads,
                                                                       streamed=True),
                                        iters=iters),
                    "sdpa_fwd": clocks(lambda: F.scaled_dot_product_attention(*views),
                                       iters=iters),
                }
            t["sdpa_bwd"] = clocks(lambda: torch.autograd.grad(sdpa_out, leaf, dout,
                                                               retain_graph=True), iters=iters)
            del sdpa_out, leaf, lviews
            if model == "dinov2-small" and b == TRAIN_BATCH:
                with torch.inference_mode():
                    t["plain_fwd_ms"] = cuda_ms(lambda: B._heads_attention(qkv, heads), iters=3,
                                                warmup=1)
                    t["plain_bwd_ms"] = cuda_ms(
                        lambda: B.packed_attention_bwd_math(qkv, dctx, heads), iters=3, warmup=1)
            for kind, backward in (("fwd", False), ("bwd", True)):
                flops, nbytes = B.attention_core_cost(b, heads, S, 64, backward)
                bound, by = B.bound_ms(flops, nbytes)
                t[f"{kind}_bound_ms"], t[f"{kind}_bound_by"] = bound, by
                old = OLD_ATTN.get(f"{where} {kind}")
                old_text = "" if old is None else (
                    f"; old WMMA kernel {old[0]:.4f} ms, device {old[1]:.4f} ms, host "
                    f"{old[2]:.1f} us/call")
                lib = t[f"sdpa_{kind}"]
                executed = B.attention_core_executed(b, heads, S, 64, backward)
                t[f"{kind}_tflops"] = flops / t[kind]["device_ms"] / 1e9
                t[f"{kind}_executed_tflops"] = executed / t[kind]["device_ms"] / 1e9
                log(f"time attention_core {kind} {where} ({heads} heads, S={S}): resident "
                    f"{clocks_text(t[kind])} ({t[kind + '_tflops']:.1f} TFLOP/s, "
                    f"{t[kind + '_executed_tflops']:.1f} on the {executed:.4g} FLOPs it "
                    "executes); "
                    f"flash {clocks_text(t['flash_' + kind])} "
                    f"({flops / t['flash_' + kind]['device_ms'] / 1e9:.1f} TFLOP/s); "
                    f"scaled_dot_product_attention {clocks_text(lib)} "
                    f"({flops / lib['device_ms'] / 1e9:.1f} TFLOP/s){old_text}; bound "
                    f"{bound:.5f} ms ({by}), JAX's {flops:.4g} FLOPs")
            out[where] = t
            del qkv, dctx, views, dout
    small = out[f"dinov2-small B={TRAIN_BATCH}"]
    for name, kind in (("attention_core", "fwd"), ("attention_core_bwd", "bwd")):
        lib = small[f"sdpa_{kind}"]
        out.setdefault(TRAIN_BATCH, {})[name] = {
            **small[kind], "plain_ms": small[f"plain_{kind}_ms"],
            "bound_ms": small[f"{kind}_bound_ms"], "bound_by": small[f"{kind}_bound_by"],
            **{f"library_{k}": v for k, v in lib.items()}}
    B.LAUNCHES.update(saved)
    return out


def phase_layernorm(results: dict) -> dict:
    """fused_layernorm against layernorm_reference at the gated path's rows,
    (257, 384) (a serving forward) and (128*257, D) for D = 384, 768, 1024
    (a step at batch 128), bf16 and f32: f32 within 1e-5 abs/rel, bf16
    within one ulp of the larger magnitude plus 1e-5 (tests/test_torch_cuda.py's
    reason); then kernel, plain, bound (bytes: each row read and written
    once, f32 scale and bias read once) and torch.nn.functional.layer_norm
    times, the library yardstick, on the same tensor with scale and bias in
    its dtype, each on the three ``clocks``. Returns the times: (257, 384)
    and (128*257, 384) in bf16 under ``fused_layernorm`` at batch 1 and 128,
    every case under ``cases``."""
    import torch.nn.functional as F

    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.ops import layernorm as LN

    gen = torch.Generator().manual_seed(SEED + 16)
    saved = dict(B.LAUNCHES)
    out: dict = {"cases": []}
    for rows, d in LN_CASES:
        x0 = torch.randn((rows, d), generator=gen) * 3 + 1
        scale = (torch.rand(d, generator=gen) + 0.5).cuda()
        bias = (torch.rand(d, generator=gen) * 2 - 1).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            x = x0.to("cuda", dtype)
            got = LN.fused_layernorm(x, scale, bias, EPS).float()
            want = LN.layernorm_reference(x, scale, bias, EPS).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            if dtype == torch.float32:
                ok = bool((err <= 1e-5 + 1e-5 * want.abs()).all())
                tol = "atol 1e-5 + rtol 1e-5*|ref|"
            else:
                mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
                ok = bool((err <= torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5).all())
                tol = "one ulp of the larger magnitude + 1e-5"
            where = f"({rows}, {d}) {str(dtype).split('.')[-1]}"
            log(f"kernel fused_layernorm {where}: max_abs={err.max().item():.6g} tol={tol} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fused_layernorm at {where} disagrees with its plain version")
            row = results.setdefault("fused_layernorm", {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err.max().item())
            w_lib, b_lib = scale.to(dtype), bias.to(dtype)
            with torch.inference_mode():
                kern = clocks(lambda: LN.fused_layernorm(x, scale, bias, EPS), iters=50)
                plain_ms = cuda_ms(lambda: LN.layernorm_reference(x, scale, bias, EPS), iters=20)
                lib = clocks(lambda: F.layer_norm(x, (d,), w_lib, b_lib, EPS), iters=50)
            flops, nbytes = LN.layernorm_cost(rows, d, x.element_size())
            bound, by = B.bound_ms(flops, nbytes, B.F32_FLOPS)
            t = {"rows": rows, "D": d, "dtype": str(dtype).split(".")[-1], **kern,
                 "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                 **{f"library_{k}": v for k, v in lib.items()}, "max_abs_err": err.max().item()}
            out["cases"].append(t)
            log(f"time fused_layernorm {where}: kernel {clocks_text(kern)}, plain {plain_ms:.4f} "
                f"ms, bound {bound:.5f} ms ({by}), F.layer_norm {clocks_text(lib)}")
            if d == D and dtype == torch.bfloat16:
                out.setdefault(1 if rows == S else TRAIN_BATCH, {})["fused_layernorm"] = t
            del x, got, want
    B.LAUNCHES.update(saved)
    return out


def write_coco(root: str, n: int, seed: int) -> tuple[str, str]:
    """``n`` seeded JPEGs at IMAGE_SIZES and a COCO keypoint file under
    ``root``: 24 keypoints each with mixed visibility (v = 0, 1, 2), and
    ``keypoints_z``. Returns (images dir, annotation path)."""
    images_dir = os.path.join(root, "images")
    os.makedirs(images_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    for i, img in enumerate(seeded_images(rng, n)):
        w, h = img.size
        img.save(os.path.join(images_dir, f"{i}.jpg"))
        kps = np.stack([rng.uniform(0.15 * w, 0.85 * w, 24), rng.uniform(0.15 * h, 0.85 * h, 24),
                        rng.choice([0.0, 1.0, 2.0], 24, p=[0.2, 0.3, 0.5])], 1)
        images.append({"id": i, "file_name": f"{i}.jpg", "width": w, "height": h})
        annotations.append({"id": i, "image_id": i, "num_keypoints": 24,
                            "keypoints": kps.reshape(-1).tolist(),
                            "keypoints_z": rng.uniform(-40, 40, 24).tolist()})
    path = os.path.join(root, "annotation.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return images_dir, path


FIT_CONFIG = """from dino_pose_tpu_torch.configs.config import get_default_configs as _defaults


def get_default_configs():
    dataset, training, preproc, model = _defaults()
    dataset.update(train_images_dir={ti!r}, train_annotation_json={ta!r},
                   val_images_dir={vi!r}, val_annotation_json={va!r})
    training.update(checkpoint_dir={ck!r}, num_epochs=2, save_freq=1{extra})
    return dataset, training, preproc, model
"""


def phase_fit(results: dict, root: str) -> dict:
    """The training entry point end to end: ``python -m
    dino_pose_tpu_torch.cli.train --config_file <file>`` (its ``main``) on the
    card with the port's default configuration (dinov2-small + LoRA r=8,
    batch 32, 224², bf16, the kernels on) on a seeded COCO-format dataset of
    FIT_TRAIN train and FIT_VAL validation JPEGs written under ``root``: two
    epochs (the PCKh baseline, 4 steps, a validation batch and a PCKh
    evaluation each), checked for finite losses, the CSV, the PCKh-gated
    checkpoints and each kernel's launches per step and per forward (in
    every run); the final checkpoint reloaded through ``load_model_smart``
    and served bit-equal to the trained model; the same command auto-resumed for a
    third epoch; one epoch with ``device_warp``, its first batch's warp on
    the card held against the CPU's; a fourth host epoch under the
    profiler, for the card's busy share; the step alone on one batch kept
    on the card, against the loop's dispatch a step."""
    import csv

    from dino_pose_tpu_torch.cli.train import main as train_main
    from dino_pose_tpu_torch.config import load_config_file
    from dino_pose_tpu_torch.data.dataset import create_dataloaders
    from dino_pose_tpu_torch.data.warp import WARP_KEYS, warp_batch
    from dino_pose_tpu_torch.io.checkpoint import load_model_smart
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.serve import make_predictor
    from dino_pose_tpu_torch.train.loop import MetricsWriter
    from dino_pose_tpu_torch.train.step import make_train_step, prepare_batch

    card = nvidia_smi()
    ti, ta = write_coco(os.path.join(root, "train"), FIT_TRAIN, SEED + 20)
    vi, va = write_coco(os.path.join(root, "valid"), FIT_VAL, SEED + 21)
    paths = {}
    prof_dir = os.path.join(root, "profile")
    for arm, extra, ck_arm in (("host", "", "host"),
                               ("device_warp", ", device_warp=True", "device_warp"),
                               ("profiled", f", profile_dir={prof_dir!r}", "host")):
        ck = os.path.join(root, f"checkpoints_{ck_arm}")
        paths[arm] = (os.path.join(root, f"config_{arm}.py"), ck)
        with open(paths[arm][0], "w") as f:
            f.write(FIT_CONFIG.format(ti=ti, ta=ta, vi=vi, va=va, ck=ck, extra=extra))
    config_file, ck = paths["host"]
    _, training, _, model_cfg = load_config_file(config_file)
    batch = training["batch_size"]
    steps_per_epoch = FIT_TRAIN // batch
    val_batches = -(-FIT_VAL // batch)
    fit: dict = {"card": card, "config": {"model": model_cfg, "batch_size": batch,
                                          "train_images": FIT_TRAIN, "val_images": FIT_VAL}}

    def train(tag: str, argv: list) -> tuple[dict, dict]:
        """``cli.train.main(argv)`` with the launch counts from 0: each train
        step 11/1/1/1 (+ 12 attn_fwd), each validation or PCKh forward 11/1/1
        (+ 12), 0 of every other wrapper."""
        B.reset_launches()
        history = train_main(argv)
        torch.cuda.synchronize()
        launches = dict(B.LAUNCHES)
        steps = len(history["train_loss"]) * steps_per_epoch
        forwards = (len(history["val_loss"]) + len(history["pckh"])) * val_batches
        want = {k: steps * LORA_LAUNCHES.get(k, 0) + forwards * SERVING_LAUNCHES.get(k, 0)
                for k in B.LAUNCHES}
        log(f"{tag} launches over {steps} train steps and {forwards} eval forwards: {launches}")
        if launches != want:
            raise AssertionError(f"{tag}: launches {launches}, want {want}")
        return history, launches

    # Two epochs: the main path.
    t0 = time.perf_counter()
    history, launches = train("fit", ["--config_file", config_file])
    run_s = time.perf_counter() - t0
    record_launches(results, "fit", launches)
    steps = 2 * steps_per_epoch
    losses = history["train_loss"] + history["val_loss"]
    if len(losses) != 4 or not np.isfinite(losses).all():
        raise AssertionError(f"fit: losses {losses}")
    with open(os.path.join(ck, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    if list(rows[0]) != MetricsWriter.FIELDS or [r["epoch"] for r in rows] != ["1", "2"]:
        raise AssertionError(f"fit: metrics.csv {rows}")
    best = list(history["pckh"][0])
    gated = []
    for r in rows:
        pckh = (float(r["pckh_2d"]), float(r["pckh_3d"]))
        passed = pckh[0] > best[0] or pckh[1] > best[1]
        best = [max(a, b) for a, b in zip(best, pckh)]
        exists = os.path.exists(os.path.join(ck, f"best_model_{r['epoch']}.pth"))
        if exists != passed:
            raise AssertionError(f"fit: epoch {r['epoch']} PCKh {pckh}, best_model file {exists}")
        gated += [int(r["epoch"])] if passed else []
    final_path = os.path.join(ck, "final_model.pth")
    if not os.path.exists(final_path) or history["state"].step != steps:
        raise AssertionError(f"fit: no {final_path} or step {history['state'].step} != {steps}")
    log(f"fit: losses {losses}, PCKh (2D, 3D) baseline and per epoch {history['pckh']}, "
        f"best_model files for epochs {gated}; wall {run_s:.2f} s")

    # The final checkpoint served bit-equal to the trained model.
    t0 = time.perf_counter()
    reloaded = load_model_smart(final_path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    images = seeded_images(np.random.default_rng(SEED + 22), 8)
    got = make_predictor(reloaded)(images)
    want_out = make_predictor(history["model"])(images)
    same = all(np.array_equal(a, b) for a, b in zip(got, want_out))
    log(f"fit reload: final_model.pth through load_model_smart in {load_s:.3f} s; "
        f"8 images served bit-equal to the trained model: {same}")
    if not same:
        raise AssertionError("fit: the reloaded checkpoint serves other outputs")
    del reloaded

    # Auto-resume: the same command, one epoch more.
    again, _ = train("fit resume", ["--config_file", config_file, "--num_epochs", "3"])
    adam_steps = {float(v["step"]) for v in again["state"].optimizer.state_dict()["state"].values()}
    log(f"fit resume: {len(again['train_loss'])} epoch, step {again['state'].step}, "
        f"AdamW steps {sorted(adam_steps)}")
    if len(again["train_loss"]) != 1 or again["state"].step != steps + steps_per_epoch \
            or adam_steps != {float(steps + steps_per_epoch)}:
        raise AssertionError("fit: auto-resume did not continue from step 8 for one epoch")

    # One epoch with the device warp; its first batch on the card vs the CPU.
    warp_file, _ = paths["device_warp"]
    _, warp_training, preproc, _ = load_config_file(warp_file)

    def loader(device_warp: bool):
        return create_dataloaders(preproc, model_cfg, ti, ta, batch_size=batch,
                                  num_workers=warp_training["multiprocessing_num"],
                                  render_targets=False, device_warp=device_warp)

    first = next(iter(loader(True)))
    args = [torch.from_numpy(first[k]) for k in WARP_KEYS]
    on_card = warp_batch(*(a.cuda() for a in args)).cpu()
    on_cpu = warp_batch(*args)
    warp_err = float((on_card - on_cpu).abs().max())
    log(f"fit device_warp: first batch's warp_batch on cuda vs cpu max_abs={warp_err:.3g} "
        f"(tol 1e-5) -> {'ok' if warp_err <= 1e-5 else 'FAIL'}")
    if not warp_err <= 1e-5:
        raise AssertionError("fit: warp_batch on the card disagrees with the CPU")
    warped, _ = train("fit device_warp", ["--config_file", warp_file, "--num_epochs", "1"])
    if len(warped["train_loss"]) != 1 or not np.isfinite(warped["train_loss"]).all():
        raise AssertionError(f"fit device_warp: losses {warped['train_loss']}")

    # A fourth host epoch under config_training["profile_dir"] (utils/profiling.trace,
    # resumed from the host arm's epoch 3): the card's busy share of the
    # traced train loop from the Chrome trace's kernel and copy events.
    traced, _ = train("fit profiled", ["--config_file", paths["profiled"][0], "--num_epochs", "4"])
    with open(os.path.join(prof_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    device_ms = {cat: sum(e.get("dur", 0) for e in events if e.get("cat") == cat) / 1e3
                 for cat in ("kernel", "gpu_memcpy", "gpu_memset")}
    epoch_ms = traced["epoch_seconds"][0] * 1e3
    busy = sum(device_ms.values()) / epoch_ms
    log(f"fit profiled epoch ({card}): {epoch_ms:.1f} ms (under the profiler), device "
        f"{json.dumps(device_ms)} ms: busy {busy:.3f}, idle {1 - busy:.3f}; kernel ms a step "
        f"{device_ms['kernel'] / steps_per_epoch:.3f}; dispatch s {traced['dispatch_s'][0]:.4f}, "
        f"input wait s {traced['input_wait_s'][0]:.4f}")
    if not device_ms["kernel"] > 0:
        raise AssertionError("fit profiled: the trace holds no kernel on the card")

    # The same step alone: the profiled run's model, optimizer and state on
    # one host-path batch copied to the card once; host clock over FIT_ALONE
    # steps ended by a synchronize, with no loader thread running and then
    # while a loader's workers augment three epochs beside it, against the
    # loop's dispatch a step.
    state = traced["state"]
    partition = frozenset(n for n, q in state.model.named_parameters() if q.requires_grad)
    step = prepare_batch(make_train_step(state.model, state.optimizer, partition),
                         (state.model.input_size, state.model.heatmap_size), torch.bfloat16)
    host_loader = loader(False)
    on_card = {k: torch.from_numpy(v).cuda() for k, v in next(iter(host_loader)).items()}

    def steps_ms() -> float:
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FIT_ALONE):
            state, _ = step(state, on_card, 1e-6, SEED)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / FIT_ALONE

    steps_ms()  # warm-up
    alone_ms = steps_ms()
    augmenting = threading.Thread(target=lambda: [b for _ in range(3) for b in host_loader])
    augmenting.start()
    beside_ms = steps_ms()
    augmenting.join()
    loop_ms = [s_ * 1e3 / steps_per_epoch for s_ in history["dispatch_s"] + again["dispatch_s"]]
    log(f"fit step alone ({card}): {alone_ms:.2f} ms a bs={batch} step (host clock, "
        f"{FIT_ALONE} steps), {beside_ms:.2f} ms beside the loader's workers; the loop's "
        f"dispatch {loop_ms} ms a step")

    fit.update(
        step_alone_ms=alone_ms, step_beside_loader_ms=beside_ms, loop_dispatch_ms=loop_ms,
        profiled={"epoch_ms": epoch_ms, "device_ms": device_ms, "busy": busy,
                  "dispatch_s": traced["dispatch_s"][0],
                  "input_wait_s": traced["input_wait_s"][0]},
        wall_s=run_s, load_s=load_s, save_s=history["save_seconds"], warp_max_abs_err=warp_err,
        pckh=history["pckh"], best_model_epochs=gated, launches=launches,
        history={k: history[k] for k in ("train_loss", "val_loss", "pckh", "epoch_seconds")},
        pckh_eval_s=history["pckh_seconds"] + again["pckh_seconds"],
        arms={arm: {k: h[k] for k in EPOCH_KEYS}
              for arm, h in (("host", {k: history[k] + again[k] for k in EPOCH_KEYS}),
                             ("device_warp", warped))})
    for arm, a in fit["arms"].items():
        log(f"fit {arm} ({card}): " + ", ".join(f"{k} {a[k]}" for k in EPOCH_KEYS))
    log(f"fit ({card}): PCKh eval s {fit['pckh_eval_s']}, checkpoint save s {fit['save_s']}, "
        f"load s {load_s}")
    return fit


# phase_pretrained: DINOv2 weights from a local Hugging Face hub cache. The
# script writes that cache itself, in the hub's layout
# (models--facebook--dinov2-small/refs/main naming snapshots/<commit>/ with
# config.json and model.safetensors), with its own safetensors writer, not
# the port's reader: dinov2-small's published config and seeded f32 tensors
# (PRETRAINED_SEED, not the model's seed) under HF Dinov2Model's plain key
# names. Nothing is downloaded. Every other phase runs with HF_HUB_CACHE on
# an empty folder (main), so that no cache on the machine moves its
# numbers.
PRETRAINED_NAME = "facebook/dinov2-small"
PRETRAINED_COMMIT = "a1b2c3d4e5f60718293a4b5c6d7e8f9012345678"
PRETRAINED_SEED = SEED + 40
DINOV2_SMALL_HF_CONFIG = {
    "architectures": ["Dinov2Model"], "model_type": "dinov2", "hidden_size": 384,
    "num_hidden_layers": 12, "num_attention_heads": 6, "mlp_ratio": 4, "patch_size": 14,
    "image_size": 518, "num_channels": 3, "layerscale_value": 1.0, "layer_norm_eps": 1e-6,
    "hidden_act": "gelu", "qkv_bias": True, "use_swiglu_ffn": False, "drop_path_rate": 0.0,
    "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
    "initializer_range": 0.02, "torch_dtype": "float32"}
# The pretrained LoRA step's checked step-1 gradients: LoRA B and two head
# convs (LoRA A's is zero at step 1, where B is the registry's zero).
PRETRAINED_GRAD_NAMES = LORA_GRAD_NAMES[1:]
UNAVAILABLE = ("Pre-trained weights for {} unavailable (OSError); initialising backbone "
               "randomly. Provide a checkpoint via config_model['load_model'] for real training.")


def dinov2_hf_tensors(gen: torch.Generator, d: int = D, layers: int = 12,
                      hidden: int = HIDDEN, patch: int = 14, grid: int = 37) -> dict:
    """Seeded f32 tensors under HF ``Dinov2Model``'s plain key names and
    shapes (linear weights (out, in)), scaled like trained ones."""
    def n(*shape, std, mean=0.0):
        return torch.randn(shape, generator=gen) * std + mean

    t = {"embeddings.cls_token": n(1, 1, d, std=0.1), "embeddings.mask_token": n(1, d, std=0.1),
         "embeddings.position_embeddings": n(1, grid * grid + 1, d, std=0.1),
         "embeddings.patch_embeddings.projection.weight": n(d, 3, patch, patch,
                                                            std=(3 * patch * patch) ** -0.5),
         "embeddings.patch_embeddings.projection.bias": n(d, std=0.05),
         "layernorm.weight": n(d, std=0.1, mean=1.0), "layernorm.bias": n(d, std=0.05)}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for norm in ("norm1", "norm2"):
            t[f"{p}{norm}.weight"] = n(d, std=0.1, mean=1.0)
            t[f"{p}{norm}.bias"] = n(d, std=0.05)
        for lin, out, k in (("attention.attention.query", d, d), ("attention.attention.key", d, d),
                            ("attention.attention.value", d, d), ("attention.output.dense", d, d),
                            ("mlp.fc1", hidden, d), ("mlp.fc2", d, hidden)):
            t[f"{p}{lin}.weight"] = n(out, k, std=k ** -0.5)
            t[f"{p}{lin}.bias"] = n(out, std=0.05)
        for ls in ("layer_scale1", "layer_scale2"):
            t[f"{p}{ls}.lambda1"] = torch.rand(d, generator=gen) * 0.9 + 0.1
    return t


def write_safetensors(path: str, tensors: dict) -> None:
    """f32 tensors in the safetensors format: an 8-byte little-endian header
    length, the JSON header (padded with spaces to 8 bytes), the raw bytes."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        data = t.detach().float().contiguous().numpy().astype("<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for data in blobs:
            f.write(data)


def write_hub_cache(root: str, repo_id: str, config: dict, tensors: dict) -> str:
    """``repo_id``'s entry in a hub cache at ``root``; returns its snapshot."""
    repo = os.path.join(root, "models--" + repo_id.replace("/", "--"))
    snapshot = os.path.join(repo, "snapshots", PRETRAINED_COMMIT)
    os.makedirs(snapshot)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(PRETRAINED_COMMIT)
    with open(os.path.join(snapshot, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    write_safetensors(os.path.join(snapshot, "model.safetensors"), tensors)
    return snapshot


def port_key(hf_key: str, lora_layer: int) -> str:
    """An HF plain key's name in the port's LoRA model."""
    plain = f"encoder.layer.{lora_layer}.attention."
    return "backbone." + hf_key.replace(plain, plain + "original_attention.")


def unavailable(caught: list) -> list:
    return [str(w.message) for w in caught if "unavailable" in str(w.message)]


def phase_pretrained(results: dict, serving: dict, training: dict, root: str) -> dict:
    """dinov2-small + LoRA r=8 from a DINOv2 cache that the phase writes
    under ``root`` (HF_HUB_CACHE set for this phase only): (a) the cache;
    (b) ``create_model_from_config`` with JAX's default ``pretrained``,
    every backbone tensor bit-equal to the written one, LoRA B zero, LoRA A
    and the heads equal to a ``pretrained=False`` build of the same seed, no
    warning; (c) 4 batch-1 and 1 batch-8 requests through
    ``serve.make_predictor`` and a bs=128 LoRA step on those weights as
    they are, exact launches, against the plain path; (d) ``cli.train`` for
    one epoch of the default config on phase_fit's seeded set, no
    "unavailable" warning, the saved ``final_model.pth``'s frozen backbone
    equal to the cache; (e) an empty cache: JAX's warning once, the seeded
    weights; (f) ``load_model_smart`` on (d)'s file with the cache removed:
    no warning, no cache read, the file's weights."""
    import shutil
    import warnings

    from dino_pose_tpu_torch.cli.train import main as train_main
    from dino_pose_tpu_torch.config import load_config_file
    from dino_pose_tpu_torch.io import hf_cache
    from dino_pose_tpu_torch.io.checkpoint import load_model_smart
    from dino_pose_tpu_torch.models.registry import create_model_from_config
    from dino_pose_tpu_torch.ops import block as B

    out: dict = {"card": nvidia_smi()}
    cache = os.path.join(root, "hub")
    lora_layer = 11
    written = dinov2_hf_tensors(torch.Generator().manual_seed(PRETRAINED_SEED))
    t0 = time.perf_counter()
    write_hub_cache(cache, PRETRAINED_NAME, DINOV2_SMALL_HF_CONFIG, written)
    out["write_s"] = time.perf_counter() - t0
    want = {port_key(k, lora_layer): v for k, v in written.items()}
    log(f"pretrained (a): {len(written)} tensors of {PRETRAINED_NAME} written to a hub cache "
        f"in {out['write_s']:.3f} s")

    with gates({"HF_HUB_CACHE": cache}):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            model = create_model_from_config(dict(LORA_CONFIG), seed=SEED, device="cuda")
            torch.cuda.synchronize()
            out["load_s"] = time.perf_counter() - t0
        seeded = create_model_from_config(dict(LORA_CONFIG), seed=SEED, device="cuda",
                                          pretrained=False).state_dict()
        sd = model.state_dict()
        backbone = {k for k in sd if k.startswith("backbone.") and "lora_output" not in k}
        differ = sorted(k for k in want if not torch.equal(sd[k].cpu(), want[k]))
        lora_b = sd[f"backbone.encoder.layer.{lora_layer}.attention.lora_output.lora_B"]
        kept = [k for k in sd if not k.startswith("backbone.") or "lora_A" in k]
        moved = sorted(k for k in kept if not torch.equal(sd[k], seeded[k]))
        ok = (not caught and backbone == set(want) and not differ and not moved
              and bool((lora_b == 0).all()))
        log(f"pretrained (b): create_model_from_config in {out['load_s']:.3f} s; "
            f"{len(want)} backbone tensors bit-equal to the cache: {not differ} "
            f"(keys match: {backbone == set(want)}), LoRA B zero: {bool((lora_b == 0).all())}, "
            f"LoRA A and {len(kept) - 1} head tensors as the seeded build: {not moved}; "
            f"warnings {[str(w.message) for w in caught]} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"pretrained (b): differ {differ[:5]}, moved {moved[:5]}")
        del seeded

        phase_serving(results, serving, "serving_pretrained", model=model)
        phase_train(results, training, "lora_pretrained", LORA_CONFIG, LORA_LAUNCHES,
                    PRETRAINED_GRAD_NAMES, ("fused_mlp_dx",), steps=2, timed=3, model=model)
        del model

        ti, ta = write_coco(os.path.join(root, "train"), FIT_TRAIN, SEED + 20)
        vi, va = write_coco(os.path.join(root, "valid"), FIT_VAL, SEED + 21)
        ck = os.path.join(root, "checkpoints")
        config_file = os.path.join(root, "config.py")
        with open(config_file, "w") as f:
            f.write(FIT_CONFIG.format(ti=ti, ta=ta, vi=vi, va=va, ck=ck, extra=""))
        B.reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            history = train_main(["--config_file", config_file, "--num_epochs", "1"])
            torch.cuda.synchronize()
            out["fit_s"] = time.perf_counter() - t0
        launches = dict(B.LAUNCHES)
        batch = load_config_file(config_file)[1]["batch_size"]
        steps = len(history["train_loss"]) * (FIT_TRAIN // batch)
        forwards = (len(history["val_loss"]) + len(history["pckh"])) * -(-FIT_VAL // batch)
        want_launches = {k: steps * LORA_LAUNCHES.get(k, 0) + forwards * SERVING_LAUNCHES.get(k, 0)
                         for k in B.LAUNCHES}
        record_launches(results, "pretrained_fit", launches)
        final_path = os.path.join(ck, "final_model.pth")
        saved = torch.load(final_path, map_location="cpu", weights_only=False)["model_state_dict"]
        differ = sorted(k for k in want if not torch.equal(saved[k], want[k]))
        losses = history["train_loss"] + history["val_loss"]
        ok = (not unavailable(caught) and launches == want_launches and not differ
              and len(losses) == 2 and bool(np.isfinite(losses).all()))
        log(f"pretrained (d): cli.train one epoch in {out['fit_s']:.2f} s, losses {losses}, "
            f"launches over {steps} steps and {forwards} forwards {launches}; 'unavailable' "
            f"warnings {unavailable(caught)}; final_model.pth's {len(want)} frozen backbone "
            f"tensors equal to the cache: {not differ} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"pretrained (d): launches {launches} (want {want_launches}), "
                                 f"differ {differ[:5]}")
        out["fit_losses"] = losses

    empty = os.path.join(root, "empty")
    os.makedirs(empty)
    with gates({"HF_HUB_CACHE": empty}):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model = create_model_from_config(dict(LORA_CONFIG), seed=SEED, device="cuda")
        seeded = create_model_from_config(dict(LORA_CONFIG), seed=SEED, device="cuda",
                                          pretrained=False).state_dict()
        same = all(torch.equal(v, seeded[k]) for k, v in model.state_dict().items())
        texts = [str(w.message) for w in caught]
        ok = texts == [UNAVAILABLE.format(PRETRAINED_NAME)] and same
        log(f"pretrained (e): empty cache: warnings {texts}; weights equal to the seeded "
            f"build: {same} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("pretrained (e): the empty cache's build")
        del model, seeded

    shutil.rmtree(cache)
    reads = []
    read = hf_cache.load_dinov2

    def counted(*args, **kwargs):
        reads.append(args)
        return read(*args, **kwargs)

    hf_cache.load_dinov2 = counted
    try:
        with gates({"HF_HUB_CACHE": cache}), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model = load_model_smart(final_path, device="cuda")
    finally:
        hf_cache.load_dinov2 = read
    same = all(torch.equal(v.cpu(), saved[k]) for k, v in model.state_dict().items())
    texts = [str(w.message) for w in caught]
    ok = not texts and not reads and same
    log(f"pretrained (f): load_model_smart(final_model.pth) with the cache removed: cache "
        f"reads {len(reads)}, warnings {texts}, weights equal to the file's: {same} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("pretrained (f): the checkpoint's reload read the cache or moved")
    log(f"pretrained ({out['card']}): " + json.dumps(out))
    return out


# phase_dist: the port's multi-process training on the one card, two ranks
# started as processes through torchrun's launch contract (WORLD_SIZE, RANK,
# LOCAL_RANK = 0, MASTER_ADDR, MASTER_PORT), both on cuda:0 under gloo with
# CUDA tensors (NCCL takes one card a rank), each ``python3 chip_smoke.py
# --dist-worker SPEC``. The steps: dinov2-small + LoRA r=8 at 224² and
# fastvit_t8 + LoRA r=8 at 256², each 2 ranks x DIST_BATCH / 2 images
# against one process x DIST_BATCH on the same weights and global batch.
# Their losses are held to LOSS_RTOL; their step-1 gradients and BatchNorm
# running-stat updates to the bf16 noise rule of the training phases (within
# GRAD_NOISE_FACTOR times the one process's own error against its f32 plain
# step, plus GRAD_NOISE_SLACK). A gradient that the f32 step gives as
# rounding (below DIST_ZERO_GRAD of the step's largest: a conv bias that the
# BatchNorm after it normalises away) has no relative error to hold: its
# distance from f32 is held to DIST_ZERO_FACTOR times the one process's (two
# independent roundings of a zero sum). One AdamW update is held
# elementwise within DIST_ADAM_TOL (AdamW's first step is lr * sign(g), so
# a gradient within roundoff of zero may step the other way: 2 * lr and the
# rounding of the weight decay), and it must step the same way as the one
# process's for at least as many elements as the one process's steps the
# same way as its f32 step, less DIST_SIGN_SLACK. Both ranks end
# bit-identical.
DIST_WORLD, DIST_BATCH, DIST_TIMED = 2, TRAIN_BATCH, 3
DIST_ZERO_GRAD, DIST_ZERO_FACTOR = 1e-5, 2.0
DIST_ADAM_TOL = 2 * LR * 1.01
DIST_SIGN_SLACK = 0.02
# fit across ranks (``cli.train``'s main on phase_fit's set, global batch 32):
# the ranks' global batches hold other images than the one process's (each
# rank loads its half of every epoch's order), so the epoch losses are held
# to DIST_FIT_RTOL of the one process's, and the baseline PCKh, on the same
# weights, to DIST_PCKH_ATOL (a few keypoints moved across the threshold by
# bf16 forwards at another batch size).
DIST_FIT_RTOL, DIST_PCKH_ATOL = 5e-2, 1e-2
# A worker run's limit (seconds); past it every worker is killed and the
# phase fails.
DIST_TIMEOUT = 900
# (f) fit with ('data', 'model') = (1, 2) across the two ranks on phase_fit's
# set at batch 32 (4 steps, a validation batch and the PCKh baseline and
# epoch evaluation, rank-local), for dinov2-base + LoRA (the tensor-parallel
# halves) and fastvit_sa12 + LoRA (the ConvFFN and attention shards), held
# bit for bit (cuDNN deterministic) against fit with the same mesh in one
# process; (g) fit with (2, 2) across four ranks on dinov2-small + LoRA at a
# global batch of 128 (64 a data shard): two epochs of one step, fit's own
# digest guard checking after each that every rank holds the same trained
# state, and the four final states equal. Launches a rank: a shard's kernels
# on the split steps and validation forwards, the one-card route's in the
# rank-local PCKh forwards.
DIST_FIT_TP = {"dinov2_base": (BASE_LORA_CONFIG, 32, 1), "fastvit_sa12": (SA12_LORA_CONFIG, 32, 1)}
DIST_FIT_MESH = {"dinov2_small": (LORA_CONFIG, 128, 2)}
DIST_FIT_LAUNCHES = {
    # (a train step's, a validation forward's launches on one model shard;
    # a rank-local PCKh forward's)
    "dinov2_base": ({"fused_attn_part_partial": 12, "fused_mlp_part_partial": 12,
                     "fused_mlp_partial_dx": 1, "attn_fwd": 12},
                    {"fused_attn_part_partial": 12, "fused_mlp_part_partial": 12, "attn_fwd": 12},
                    SERVING_LAUNCHES),
    "fastvit_sa12": ({"fused_convffn": 12, "fused_convffn_bwd": 12, "flash_fwd": 2,
                      "flash_bwd": 2}, {"fused_convffn": 12, "flash_fwd": 2},
                     SERVING_SA12_LAUNCHES),
    "dinov2_small": ({"fused_attn_part_partial": 12, "fused_mlp_part_partial": 12,
                      "fused_mlp_partial_dx": 1, "attn_fwd": 12},
                     {"fused_attn_part_partial": 12, "fused_mlp_part_partial": 12,
                      "attn_fwd": 12}, SERVING_LAUNCHES),
}


def dist_spawn(root: str, tag: str, jobs: list, world: int = DIST_WORLD,
               backend: str = "gloo", timeout: float = DIST_TIMEOUT) -> list:
    """Run ``jobs`` in ``world`` processes of this script (``--dist-worker``)
    under torchrun's contract on localhost, each one's output in a log under
    ``root``; returns each rank's results (``torch.save``'d by the worker).
    Raises if a worker fails or outlives ``timeout`` (every worker is then
    killed)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    spec = os.path.join(root, f"{tag}.json")
    with open(spec, "w") as f:
        json.dump({"out": root, "tag": tag, "jobs": jobs, "backend": backend}, f)
    procs, logs = [], []
    for r in range(world):
        logs.append(os.path.join(root, f"{tag}_rank{r}.log"))
        env = {"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo", **os.environ,
               "WORLD_SIZE": str(world), "RANK": str(r), "LOCAL_RANK": "0",
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        with open(logs[-1], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-worker", spec],
                stdout=out, stderr=subprocess.STDOUT, env=env,
                cwd=os.path.dirname(os.path.abspath(__file__))))
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"dist {tag}: a worker outlived {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for r, (p, path) in enumerate(zip(procs, logs)):
        with open(path) as f:
            texts.append(f.read())
        if p.returncode != 0:
            raise RuntimeError(f"dist {tag}: rank {r} exited {p.returncode}:\n{texts[-1][-4000:]}")
    return [{**torch.load(os.path.join(root, f"{tag}_rank{r}.pt"), weights_only=False),
             "log": texts[r]} for r in range(world)]


def dist_worker(spec_path: str) -> int:
    """One rank of phase_dist: ``maybe_initialize_distributed`` from the
    launch contract (gloo with CUDA tensors, or NCCL where the spec asks),
    then each job in order; its results go to ``<out>/<tag>_rank<r>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dino_pose_tpu_torch.core import distributed

    with open(spec_path) as f:
        spec = json.load(f)
    backend = spec.get("backend", "gloo")
    distributed.maybe_initialize_distributed("cuda:0", backend=backend)
    rank, world = distributed.rank(), distributed.world_size()
    out = {}
    for job in spec["jobs"]:
        t0 = time.perf_counter()
        out[job["name"]] = DIST_JOBS[job["kind"]](job, rank, world)
        out[job["name"]]["wall_s"] = time.perf_counter() - t0
        log(f"dist worker rank {rank}: {job['name']} done in {out[job['name']]['wall_s']:.2f} s")
    torch.save(out, os.path.join(spec["out"], f"{spec['tag']}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def seeded_model(config: dict):
    from dino_pose_tpu_torch.models.registry import create_model_from_config

    model = create_model_from_config(dict(config), seed=SEED, device="cuda",
                                     pretrained=False)
    randomise_for_serving(model, torch.Generator().manual_seed(SEED + 4))
    return model


def timed_steps_ms(step, state, batch, n: int = DIST_TIMED) -> tuple:
    """Host-clock ms a step over ``n`` steps after one warm-up, closed by a
    synchronize (and, across ranks, a barrier on each side)."""
    from dino_pose_tpu_torch.core import distributed

    state, _ = step(state, batch, LR, SEED)
    torch.cuda.synchronize()
    if distributed.is_initialized():
        torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = step(state, batch, LR, SEED)
    torch.cuda.synchronize()
    if distributed.is_initialized():
        torch.distributed.barrier()
    return (time.perf_counter() - t0) * 1e3 / n, state


def step_record(model, config: dict, batch: dict, image_size: int) -> dict:
    """One kernel-path bf16 train step of ``model`` on ``batch``: its
    launches, stats, the trainable parameters before it, their gradients,
    the state dict after it (on the host); then the step's time."""
    from dino_pose_tpu_torch.ops import block as B

    state, step = make_step(model, config, kernels=True, image_size=image_size)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    # What a step changes: the trainable parameters and the buffers (the
    # frozen weights are held bitwise unchanged by the training phases).
    kept = set(names) | {n for n, _ in model.named_buffers()}

    def host_state() -> dict:
        return {k: v.detach().cpu().clone() for k, v in model.state_dict().items() if k in kept}

    before = host_state()
    B.reset_launches()
    state, stats = step(state, batch, LR, SEED)
    torch.cuda.synchronize()
    launches = dict(B.LAUNCHES)
    params = dict(model.named_parameters())
    rec = {"launches": launches, "stats": {k: v.item() for k, v in stats.items()},
           "before": before, "grads": {n: params[n].grad.detach().cpu() for n in names},
           "after": host_state()}
    rec["step_ms"], _ = timed_steps_ms(step, state, batch)
    return rec


def dist_job_step(job: dict, rank: int, world: int) -> dict:
    """(a)/(b): this rank's rows of the seeded global batch under the
    default mesh (every rank a data shard)."""
    from dino_pose_tpu_torch.core.mesh import create_mesh
    from dino_pose_tpu_torch.ops import dispatch

    model = seeded_model(job["config"])
    full = synthetic_batch(job["batch"], job["image_size"])
    b = job["batch"] // world
    local = {k: v[rank * b:(rank + 1) * b].contiguous() for k, v in full.items()}
    with dispatch.scoped():
        create_mesh(device="cuda:0")
        return step_record(model, job["config"], local, job["image_size"])


def dist_job_tp(job: dict, rank: int, world: int) -> dict:
    """(d): dinov2-base + LoRA under ('data', 'model') = (1, world) across
    the ranks: a batch-8 forward and one train step."""
    from dino_pose_tpu_torch.core.mesh import MeshSpec, create_mesh
    from dino_pose_tpu_torch.ops import dispatch

    with dispatch.scoped(), deterministic_cudnn():
        create_mesh(MeshSpec(1, world), device="cuda:0")
        return tp_record(job["config"], job["batch"])


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for a block: the heads' convolution
    backward otherwise sums with atomics, in an order that differs from run
    to run."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def tp_record(config: dict, batch_size: int) -> dict:
    """The recorded mesh's dinov2-base + LoRA: a batch-8 eval forward and
    one train step at ``batch_size`` (launches of each)."""
    from dino_pose_tpu_torch.ops import block as B

    model = seeded_model(config)
    pixels = synthetic_batch(8)["image"].to(torch.bfloat16)
    B.reset_launches()
    with torch.no_grad():
        hm, z = model.eval()(pixels)
    torch.cuda.synchronize()
    fwd = dict(B.LAUNCHES)
    rec = step_record(model, config, synthetic_batch(batch_size), 224)
    rec.update(fwd_launches=fwd, hm=hm.float().cpu(), z=z.float().cpu())
    return rec


def dist_job_fit(job: dict, rank: int, world: int) -> dict:
    """(c): ``cli.train``'s main with this rank's config file (its own
    checkpoint directory); with ``pretend_no_ckpt``, rank 1 acts as if no
    ``.pth`` were on its filesystem."""
    from dino_pose_tpu_torch.cli.train import main as train_main
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.train import evaluate

    if job.get("pretend_no_ckpt") and rank > 0:
        real = os.path.isfile
        os.path.isfile = lambda p: False if str(p).endswith(".pth") else real(p)
    B.reset_launches()
    history = train_main(job["argv"][rank])
    torch.cuda.synchronize()
    return {"launches": dict(B.LAUNCHES), "eval_info": dict(evaluate.last_eval_info),
            "state_sha256": state_sha256(history["model"]), "step": history["state"].step,
            **{k: history[k] for k in ("train_loss", "val_loss", "pckh", "epoch_seconds",
                                       "images_per_sec")}}


def state_sha256(model) -> str:
    """The sha256 of every tensor of ``model``'s state dict, bit for bit."""
    import hashlib

    digest = hashlib.sha256()
    for k, v in model.state_dict().items():
        digest.update(k.encode())
        digest.update(v.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def fit_configs(root: str, tag: str, config: dict, batch_size: int, epochs: int) -> list:
    """The port's default configuration on phase_fit's set (``root``), with
    ``config``'s model, the global batch and the epochs; its own checkpoint
    directory."""
    from dino_pose_tpu_torch.config import get_default_configs

    d, t, p, m = get_default_configs()
    d.update(train_images_dir=os.path.join(root, "train", "images"),
             train_annotation_json=os.path.join(root, "train", "annotation.json"),
             val_images_dir=os.path.join(root, "valid", "images"),
             val_annotation_json=os.path.join(root, "valid", "annotation.json"))
    t.update(checkpoint_dir=os.path.join(root, f"checkpoints_{tag}"), batch_size=batch_size,
             num_epochs=epochs, save_freq=1)
    m.update(config)
    return [d, t, p, m]


def fit_record(configs: list, mesh: tuple) -> dict:
    """``fit`` on this process under ('data', 'model') = ``mesh`` (cuDNN
    deterministic): launches, history, the final state's digest."""
    from dino_pose_tpu_torch.core.mesh import MeshSpec
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.train.loop import fit

    B.reset_launches()
    with deterministic_cudnn():
        history = fit(*configs, device="cuda:0", mesh=MeshSpec(*mesh), progress=False)
    torch.cuda.synchronize()
    return {"launches": dict(B.LAUNCHES), "state_sha256": state_sha256(history["model"]),
            "step": history["state"].step,
            **{k: history[k] for k in ("train_loss", "val_loss", "pckh", "epoch_seconds",
                                       "dispatch_s", "images_per_sec")}}


def dist_job_fit_mesh(job: dict, rank: int, world: int) -> dict:
    """(f)/(g): ``fit`` on this rank with the job's (dp, tp) mesh across
    the ranks."""
    return fit_record(job["configs"], tuple(job["mesh"]))


def dist_job_nccl(job: dict, rank: int, world: int) -> dict:
    """(e): a world of one under NCCL: the collectives of core/distributed
    on CUDA tensors, AdamW's host-side ``step`` tensors included."""
    import torch.distributed as dist

    from dino_pose_tpu_torch.core import distributed
    from dino_pose_tpu_torch.train.state import make_optimizer
    from dino_pose_tpu_torch.train.weighting import LossWeightState

    out = {"backend": dist.get_backend(), "device": str(distributed.collective_device()),
           "string": distributed.broadcast_string("final_model.pth")}
    model = torch.nn.Sequential(torch.nn.Linear(16, 8), torch.nn.BatchNorm1d(8)).cuda()
    opt = make_optimizer(model.parameters(), 1e-6)
    opt.param_groups[0]["lr"] = 1e-3
    model(torch.randn(4, 16, device="cuda")).square().sum().backward()
    opt.step()
    steps = [st["step"] for st in opt.state.values()]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = [st["exp_avg"].clone() for st in opt.state.values()]
    lw = LossWeightState.create(0.3, device="cuda")
    distributed.check_same_structure(distributed.state_description(model, opt), "nccl")
    lw2, scalars = distributed.broadcast_state(model, opt, lw, [3, 1e-4])
    t = torch.arange(4.0, device="cuda", requires_grad=True)
    summed = distributed._DataSum.apply(t, None)
    summed.sum().backward()
    out.update(
        steps_on_host=all(s.device.type == "cpu" for s in steps),
        steps=[float(s) for s in steps], scalars=scalars, weight=float(lw2.weight),
        state_kept=all(torch.equal(before[k], v) for k, v in model.state_dict().items()),
        moments_kept=all(torch.equal(m, st["exp_avg"]) for m, st in zip(moments,
                                                                        opt.state.values())),
        sum_ok=bool(torch.equal(summed.detach(), t.detach())),
        grad_ok=bool(torch.equal(t.grad, torch.ones_like(t))))
    return out


DIST_JOBS = {"step": dist_job_step, "tp": dist_job_tp, "fit": dist_job_fit,
             "fit_mesh": dist_job_fit_mesh, "nccl": dist_job_nccl}


def fit_launches(tag: str, history: dict, shards: int, val_batches: int = 1) -> dict:
    """The launches ``fit`` should count for DIST_FIT_LAUNCHES[tag] with
    ``shards`` model shards in the process: the split kernels ``shards``
    times a step and a validation forward, the one-card route's once a
    rank-local PCKh forward (one batch each)."""
    step, val, pckh = DIST_FIT_LAUNCHES[tag]
    n_val, n_pckh = val_batches * len(history["val_loss"]), len(history["pckh"])
    keys = set(step) | set(val) | set(pckh)
    return {k: shards * (history["step"] * step.get(k, 0) + n_val * val.get(k, 0))
            + n_pckh * pckh.get(k, 0) for k in keys}


def dist_hold_step(tag: str, two: list, one: dict, ref_grads: dict, ref_after: dict,
                   failures: list) -> dict:
    """(a)/(b)'s checks of the two ranks' step against one process's."""
    r0 = two[0]
    rec = {"losses": {}, "grads": {}, "stats_updates": {}}
    for k in ("loss", "kp_loss", "z_loss", "weight"):
        got, want = r0["stats"][k], one["stats"][k]
        rel = abs(got - want) / abs(want)
        ok = np.isfinite(got) and rel <= LOSS_RTOL
        rec["losses"][k] = (got, want, rel)
        log(f"dist {tag} {k}: 2 ranks {got:.7g}, 1 process {want:.7g}, rel {rel:.3g} "
            f"(tol {LOSS_RTOL}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{tag} {k}")
    worst, zeros = 0.0, []
    largest = max(float(g.norm()) for g in ref_grads.values())
    for n, g in r0["grads"].items():
        if not ref_grads[n].any():
            # A leaf this input does not reach: zero on every path.
            if g.any() or one["grads"][n].any():
                failures.append(f"{tag} gradient {n} not zero")
            continue
        g1, gf = one["grads"][n], ref_grads[n]
        if float(gf.norm()) < DIST_ZERO_GRAD * largest:
            d2, d1 = float((g.float() - gf).norm()), float((g1.float() - gf).norm())
            zeros.append((n, d2, d1))
            if not (bool(torch.isfinite(g).all()) and d2 <= DIST_ZERO_FACTOR * d1):
                failures.append(f"{tag} gradient {n}")
                log(f"dist {tag} grad {n} (rounding in f32): |2 ranks - f32| {d2:.4g}, "
                    f"|1 process - f32| {d1:.4g} (tol {DIST_ZERO_FACTOR}x) -> FAIL")
            continue
        rel, k_ref, p_ref = rel_err(g, g1), rel_err(g, gf), rel_err(g1, gf)
        tol = GRAD_NOISE_FACTOR * p_ref + GRAD_NOISE_SLACK
        ok = bool(torch.isfinite(g).all()) and max(rel, k_ref) <= tol
        worst = max(worst, max(rel, k_ref) / tol)
        rec["grads"][n] = (rel, k_ref, p_ref)
        if not ok:
            failures.append(f"{tag} gradient {n}")
            log(f"dist {tag} grad {n}: 2 ranks vs 1 process {rel:.4g}, vs f32 {k_ref:.4g}, "
                f"1 process vs f32 {p_ref:.4g} (tol {tol:.4g}) -> FAIL")
    rec["rounding_grads"] = zeros
    log(f"dist {tag}: {len(rec['grads'])} step-1 gradients within the bf16 noise rule, worst "
        f"{worst:.3f} of its tolerance; {len(zeros)} that f32 gives as rounding (below "
        f"{DIST_ZERO_GRAD} of the largest), their distance from f32 at most "
        f"{max((d2 / d1 for _, d2, d1 in zeros), default=0.0):.3f}x the one process's "
        f"(tol {DIST_ZERO_FACTOR}x)")
    # The BatchNorm running statistics' update over the step, by the same rule.
    for k, v in r0["after"].items():
        if k.endswith(("running_mean", "running_var")):
            d2, d1, df = (v - r0["before"][k], one["after"][k] - one["before"][k],
                          ref_after[k] - one["before"][k])
            if not df.any():
                # A BatchNorm this input does not reach: no update on any path.
                if d2.any() or d1.any():
                    failures.append(f"{tag} running stat {k} moved")
                continue
            rel, k_ref, p_ref = rel_err(d2, d1), rel_err(d2, df), rel_err(d1, df)
            tol = GRAD_NOISE_FACTOR * p_ref + GRAD_NOISE_SLACK
            rec["stats_updates"][k] = (rel, k_ref, p_ref)
            if not max(rel, k_ref) <= tol:
                failures.append(f"{tag} running stat {k}")
                log(f"dist {tag} {k} update: 2 ranks vs 1 process {rel:.4g}, vs f32 "
                    f"{k_ref:.4g}, 1 process vs f32 {p_ref:.4g} (tol {tol:.4g}) -> FAIL")
    if rec["stats_updates"]:
        log(f"dist {tag}: {len(rec['stats_updates'])} BatchNorm running-stat updates held, worst "
            f"2 ranks vs 1 process {max(r[0] for r in rec['stats_updates'].values()):.4g}")
    # One AdamW update of every trainable parameter, against the one
    # process's, and the one process's against its f32 step.
    diffs, agree, agree_f32, total = [], 0, 0, 0
    for n in r0["grads"]:
        u2, u1 = r0["after"][n] - r0["before"][n], one["after"][n] - one["before"][n]
        uf = ref_after[n] - one["before"][n]
        diffs.append(float((u2 - u1).abs().max()))
        agree += int((torch.sign(u2) == torch.sign(u1)).sum())
        agree_f32 += int((torch.sign(u1) == torch.sign(uf)).sum())
        total += u1.numel()
    rec["adam_max_diff"], rec["adam_sign_agree"] = max(diffs), agree / total
    rec["adam_sign_agree_one_vs_f32"] = agree_f32 / total
    floor = rec["adam_sign_agree_one_vs_f32"] - DIST_SIGN_SLACK
    ok = rec["adam_max_diff"] <= DIST_ADAM_TOL and rec["adam_sign_agree"] >= floor
    log(f"dist {tag} AdamW update: max |2 ranks - 1 process| {rec['adam_max_diff']:.3g} "
        f"(tol {DIST_ADAM_TOL:.3g}); same direction as 1 process {rec['adam_sign_agree']:.4f}, "
        f"1 process as its f32 step {rec['adam_sign_agree_one_vs_f32']:.4f} (at least "
        f"{floor:.4f}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{tag} AdamW update")
    same = all(torch.equal(v, two[1]["after"][k]) for k, v in r0["after"].items())
    log(f"dist {tag}: both ranks' parameters and buffers bit-identical: {same}")
    if not same:
        failures.append(f"{tag} ranks differ")
    if two[1]["launches"] != r0["launches"]:
        failures.append(f"{tag} launches differ across ranks")
    return rec


def dist_fit_tp_references(root: str) -> dict:
    """(f)'s references: fit with the (1, 2) mesh in this process, each
    model of DIST_FIT_TP on phase_fit's set."""
    refs = {}
    for tag, (config, bs, epochs) in DIST_FIT_TP.items():
        refs[tag] = fit_record(fit_configs(root, f"{tag}_one", config, bs, epochs),
                               (1, DIST_WORLD))
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def dist_fit_tp_jobs(root: str) -> list:
    """(f)'s jobs for the two ranks."""
    return [{"name": f"fit_tp_{tag}", "kind": "fit_mesh", "mesh": [1, DIST_WORLD],
             "configs": fit_configs(root, f"{tag}_ranks", config, bs, epochs)}
            for tag, (config, bs, epochs) in DIST_FIT_TP.items()]


def dist_hold_fit_tp(results: dict, two: list, fit_tp_one: dict, card: str, out: dict,
                     failures: list) -> None:
    """(f): fit with a model axis across the two ranks, bit for bit against
    the same mesh in one process; launches a rank and in the process."""
    out["fit_tp"] = {}
    for tag in DIST_FIT_TP:
        ranks, one = [r[f"fit_tp_{tag}"] for r in two], fit_tp_one[tag]
        want_rank, want_one = fit_launches(tag, ranks[0], 1), fit_launches(tag, one, DIST_WORLD)
        launches_ok = (all(r["launches"] == expected(want_rank) for r in ranks)
                       and one["launches"] == expected(want_one))
        same = all(r["state_sha256"] == one["state_sha256"] for r in ranks)
        hist_same = all(r[k] == one[k] for r in ranks
                        for k in ("train_loss", "val_loss", "pckh", "step"))
        ok = launches_ok and same and hist_same and one["step"] > 0 and all(
            np.isfinite(one["train_loss"]))
        log(f"dist fit_tp {tag}: fit with (1, 2) across 2 ranks vs in 1 process: states "
            f"bit-identical {same}, losses/PCKh/steps equal {hist_same} (steps {one['step']}, "
            f"train loss {one['train_loss']}, val loss {one['val_loss']}, PCKh {one['pckh']}); "
            f"launches a rank {ranks[0]['launches']} (want {expected(want_rank)}), in 1 process "
            f"{one['launches']} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"fit_tp {tag}")
        record_launches(results, f"dist_fit_tp_{tag}", ranks[0]["launches"])
        per_step = [e / max(1, one["step"]) for e in (ranks[0]["epoch_seconds"][0],
                                                      one["epoch_seconds"][0])]
        out["fit_tp"][tag] = {
            "bit_equal": same and hist_same, "step": one["step"],
            "epoch_seconds_two_ranks": ranks[0]["epoch_seconds"],
            "epoch_seconds_one_process": one["epoch_seconds"],
            "dispatch_s_two_ranks": ranks[0]["dispatch_s"],
            "dispatch_s_one_process": one["dispatch_s"],
            "launches_rank": ranks[0]["launches"], "launches_one_process": one["launches"]}
        log(f"dist fit_tp {tag} ({card}): epoch {ranks[0]['epoch_seconds'][0]:.2f} s on 2 ranks "
            f"(a model shard a rank, gloo, sharing the card) vs {one['epoch_seconds'][0]:.2f} s "
            f"in 1 process; {per_step[0]:.3f} vs {per_step[1]:.3f} s a step (epoch / steps, "
            f"the loader included)")



def dist_fit_mesh(results: dict, root: str, card: str, out: dict, failures: list) -> None:
    """(g): fit with (2, 2) across four ranks on phase_fit's set."""
    t0 = time.perf_counter()
    jobs = [{"name": f"fit_mesh_{tag}", "kind": "fit_mesh", "mesh": [2, 2],
             "configs": fit_configs(root, f"{tag}_mesh22", config, bs, epochs)}
            for tag, (config, bs, epochs) in DIST_FIT_MESH.items()]
    four = dist_spawn(root, "dist4", jobs, world=4)
    out["wall_s"]["four_ranks"] = time.perf_counter() - t0
    out["fit_mesh"] = {}
    for tag in DIST_FIT_MESH:
        ranks = [r[f"fit_mesh_{tag}"] for r in four]
        want = expected(fit_launches(tag, ranks[0], 1))
        same = len({r["state_sha256"] for r in ranks}) == 1
        hist_same = all(r[k] == ranks[0][k] for r in ranks for k in ("train_loss", "val_loss",
                                                                     "pckh", "step"))
        guard = all("the values differ" not in r["log"] for r in four)
        ok = (same and hist_same and guard and ranks[0]["step"] == 2
              and all(r["launches"] == want for r in ranks)
              and all(np.isfinite(ranks[0]["train_loss"])))
        log(f"dist fit_mesh {tag}: fit with (2, 2) across 4 ranks, {ranks[0]['step']} steps "
            f"(one an epoch, fit's digest guard after each): final states bit-identical on all "
            f"four {same}, histories equal {hist_same} (train loss {ranks[0]['train_loss']}, "
            f"PCKh {ranks[0]['pckh']}); launches a rank {ranks[0]['launches']} (want {want}) "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"fit_mesh {tag}")
        record_launches(results, f"dist_fit_mesh22_{tag}", ranks[0]["launches"])
        out["fit_mesh"][tag] = {"bit_identical": same, "steps": ranks[0]["step"],
                                "train_loss": ranks[0]["train_loss"],
                                "epoch_seconds": ranks[0]["epoch_seconds"],
                                "launches_rank": ranks[0]["launches"]}
        log(f"dist fit_mesh {tag} ({card}): epochs {ranks[0]['epoch_seconds']} s on 4 ranks "
            f"sharing the card (wall {out['wall_s']['four_ranks']:.1f} s with the ranks' "
            "start-up)")


def phase_dist(results: dict, root: str, fit_history: dict) -> dict:
    """Multi-process training on the one card (see DIST_WORLD above): (a)
    dinov2-small + LoRA r=8 and (b) fastvit_t8 + LoRA r=8, one step on two
    ranks against one process on the same global batch; (c) ``cli.train``
    across two ranks on phase_fit's set (``root``) against phase_fit's one
    process (``fit_history``), then an auto-resumed epoch with rank 1
    pretending the checkpoint is absent; (d) dinov2-base + LoRA under
    ('data', 'model') = (1, 2) across two ranks against the one-card tp = 2
    route, bit for bit; (e) a world of one under NCCL; (f) fit with a model
    axis across the two ranks, dinov2-base and fastvit_sa12 + LoRA, bit for
    bit against the same mesh in one process; (g) fit with (2, 2) across
    four ranks (DIST_FIT_TP, DIST_FIT_MESH above). Launches per rank per
    step, and wall seconds of each part."""
    from dino_pose_tpu_torch.core.mesh import MeshSpec, create_mesh
    from dino_pose_tpu_torch.ops import dispatch

    card = nvidia_smi()
    out: dict = {"card": card, "wall_s": {}}
    failures: list = []
    t_phase = time.perf_counter()

    # One process's references, each from the same seeded weights and batch:
    # the bf16 kernel step and the f32 plain step (the noise yardstick).
    refs = {}
    t0 = time.perf_counter()
    for tag, config, b, img in (("dinov2_small_lora", LORA_CONFIG, DIST_BATCH, 224),
                                ("fastvit_t8_lora", T8_CONFIG, DIST_BATCH, FASTVIT_IMAGE)):
        model = seeded_model(config)
        ref = copy.deepcopy(model)
        batch = synthetic_batch(b, img)
        one = step_record(model, config, batch, img)
        rstate, rstep = make_step(ref, config, kernels=False, dtype=torch.float32,
                                  image_size=img)
        rstep(rstate, batch, LR, SEED)
        ref_grads = {n: p.grad.detach().cpu() for n, p in ref.named_parameters()
                     if p.requires_grad}
        ref_after = {k: v.detach().cpu() for k, v in ref.state_dict().items()}
        refs[tag] = (config, b, img, one, ref_grads, ref_after)
        del model, ref, rstate, rstep, batch
        gc.collect()
        torch.cuda.empty_cache()
    with dispatch.scoped(), deterministic_cudnn():
        create_mesh(MeshSpec(1, DIST_WORLD))
        card_tp = tp_record(BASE_LORA_CONFIG, DIST_BATCH)
    gc.collect()
    torch.cuda.empty_cache()
    fit_tp_one = dist_fit_tp_references(root)
    out["wall_s"]["references"] = time.perf_counter() - t0

    # The two ranks: (a), (b), (d), then (c) and its resume.
    argv = {}
    for arm in ("fit", "resume"):
        argv[arm] = []
        for r in range(DIST_WORLD):
            path = os.path.join(root, f"config_dist_{r}.py")
            with open(path, "w") as f:
                f.write(FIT_CONFIG.format(
                    ti=os.path.join(root, "train", "images"),
                    ta=os.path.join(root, "train", "annotation.json"),
                    vi=os.path.join(root, "valid", "images"),
                    va=os.path.join(root, "valid", "annotation.json"),
                    ck=os.path.join(root, f"checkpoints_dist_{r}"), extra=""))
            argv[arm].append(["--config_file", path] + (["--num_epochs", "3"]
                                                        if arm == "resume" else []))
    jobs = [{"name": tag, "kind": "step", "config": refs[tag][0], "batch": refs[tag][1],
             "image_size": refs[tag][2]} for tag in refs]
    jobs += [{"name": "dinov2_base_lora_tp2", "kind": "tp", "config": BASE_LORA_CONFIG,
              "batch": DIST_BATCH},
             {"name": "fit", "kind": "fit", "argv": argv["fit"]},
             {"name": "fit_resume", "kind": "fit", "argv": argv["resume"],
              "pretend_no_ckpt": True}]
    jobs += dist_fit_tp_jobs(root)
    t0 = time.perf_counter()
    two = dist_spawn(root, "dist", jobs)
    out["wall_s"]["two_ranks"] = time.perf_counter() - t0
    for tag in refs:
        out["wall_s"][tag] = two[0][tag]["wall_s"]
    for name in ("dinov2_base_lora_tp2", "fit", "fit_resume",
                 *(f"fit_tp_{tag}" for tag in DIST_FIT_TP)):
        out["wall_s"][name] = two[0][name]["wall_s"]

    # (a), (b)
    for tag, path, per_step in (("dinov2_small_lora", "dist_lora_train", LORA_LAUNCHES),
                                ("fastvit_t8_lora", "dist_fastvit_t8_lora_train",
                                 T8_TRAIN_LAUNCHES)):
        config, b, img, one, ref_grads, ref_after = refs[tag]
        ranks = [r[tag] for r in two]
        launches = ranks[0]["launches"]
        log(f"dist {tag}: launches a rank a step {launches}")
        if launches != expected(per_step):
            failures.append(f"{tag} launches {launches}")
        record_launches(results, path, launches)
        out[tag] = dist_hold_step(tag, ranks, one, ref_grads, ref_after, failures)
        out[tag].update(step_ms_two_ranks=ranks[0]["step_ms"], step_ms_one_process=one["step_ms"])
        log(f"dist {tag} ({card}): step {ranks[0]['step_ms']:.2f} ms on 2 ranks x {b // 2} "
            f"sharing the card, {one['step_ms']:.2f} ms in 1 process x {b} (host clock, "
            f"{DIST_TIMED} steps)")

    # (d): bit for bit against the one-card tp = 2 route.
    tag = "dinov2_base_lora_tp2"
    ranks = [r[tag] for r in two]
    per_step = {k: v // DIST_WORLD for k, v in TP_LORA_LAUNCHES.items() if k in TP_SHARD}
    per_step["attn_fwd"] = TP_LORA_LAUNCHES["attn_fwd"] // DIST_WORLD
    per_fwd = {k: v // DIST_WORLD for k, v in SERVING_TP_LAUNCHES.items()}
    for r in ranks:
        if r["launches"] != expected(per_step) or r["fwd_launches"] != expected(per_fwd):
            failures.append(f"{tag} launches {r['launches']} / {r['fwd_launches']}")
    record_launches(results, "dist_tp2_train", ranks[0]["launches"])
    mismatch = []
    for r_i, r in enumerate(ranks):
        pairs = [("hm", r["hm"], card_tp["hm"]), ("z", r["z"], card_tp["z"])]
        pairs += [(f"stat {k}", torch.tensor(v), torch.tensor(card_tp["stats"][k]))
                  for k, v in r["stats"].items()]
        pairs += [(f"grad {n}", g, card_tp["grads"][n]) for n, g in r["grads"].items()]
        pairs += [(f"after {k}", v, card_tp["after"][k]) for k, v in r["after"].items()]
        for what, got, want in pairs:
            if not torch.equal(got, want):
                diff = float((got.double() - want.double()).abs().max())
                mismatch.append(f"rank {r_i} {what}: max abs {diff:.3g}")
    log(f"dist {tag}: forward (batch 8) and LoRA step (batch {DIST_BATCH}) across 2 ranks vs "
        f"the one-card tp=2 route: {'bit-equal' if not mismatch else mismatch[:20]}; "
        f"launches a rank: step {ranks[0]['launches']}, forward {ranks[0]['fwd_launches']}")
    if mismatch:
        failures.append(f"{tag}: {len(mismatch)} tensors differ from the one-card route")
    out[tag] = {"bit_equal": not mismatch, "mismatch": mismatch[:20],
                "step_ms_two_ranks": ranks[0]["step_ms"], "step_ms_one_card": card_tp["step_ms"]}
    log(f"dist {tag} ({card}): step {ranks[0]['step_ms']:.2f} ms with a shard a rank on 2 "
        f"ranks sharing the card, {card_tp['step_ms']:.2f} ms with both shards in 1 process "
        f"(host clock, {DIST_TIMED} steps, cuDNN deterministic)")

    # (c): fit across the ranks against phase_fit's one process.
    fit = [r["fit"] for r in two]
    one_fit = fit_history
    steps = 2 * (FIT_TRAIN // 32)
    forwards = len(fit[0]["val_loss"]) + len(fit[0]["pckh"])  # one local batch of 16 each
    want = {k: steps * LORA_LAUNCHES.get(k, 0) + forwards * SERVING_LAUNCHES.get(k, 0)
            for k in fit[0]["launches"]}
    for r in fit:
        if r["launches"] != want:
            failures.append(f"fit launches {r['launches']}, want {want}")
    record_launches(results, "dist_fit", fit[0]["launches"])
    losses = {}
    for key in ("train_loss", "val_loss"):
        got, ref = np.asarray(fit[0][key]), np.asarray(one_fit[key])
        rel = np.abs(got - ref) / np.abs(ref)
        losses[key] = (got.tolist(), ref.tolist(), rel.tolist())
        ok = got.shape == ref.shape and np.isfinite(got).all() and (rel <= DIST_FIT_RTOL).all()
        log(f"dist fit {key}: 2 ranks {got.tolist()}, 1 process {ref.tolist()}, rel "
            f"{rel.tolist()} (tol {DIST_FIT_RTOL}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"fit {key}")
    base_diff = np.abs(np.asarray(fit[0]["pckh"][0]) - np.asarray(one_fit["pckh"][0])).max()
    info_ok = all(r["eval_info"] == {"local_images": FIT_VAL // 2, "total_images": FIT_VAL}
                  for r in fit)
    pckh_ok = info_ok and base_diff <= DIST_PCKH_ATOL and fit[0]["pckh"] == fit[1]["pckh"]
    log(f"dist fit PCKh: 2 ranks {fit[0]['pckh']}, 1 process {one_fit['pckh']}; baseline diff "
        f"{base_diff:.4g} (tol {DIST_PCKH_ATOL}); images a rank {[r['eval_info'] for r in fit]} "
        f"-> {'ok' if pckh_ok else 'FAIL'}")
    if not pckh_ok:
        failures.append("fit PCKh")
    files = [sorted(os.listdir(os.path.join(root, f"checkpoints_dist_{r}")))
             for r in range(DIST_WORLD)]
    files_ok = not files[1] and "final_model.pth" in files[0] and "metrics.csv" in files[0]
    same = fit[0]["state_sha256"] == fit[1]["state_sha256"]
    log(f"dist fit files: rank 0 {files[0]}, rank 1 {files[1]}; final states equal: {same}")
    if not (files_ok and same):
        failures.append("fit files or states")
    res = [r["fit_resume"] for r in two]
    logs_ok = ("Auto-resuming from latest checkpoint" in two[0]["log"]
               and "will receive resumed state from the primary" in two[1]["log"])
    res_ok = (logs_ok and res[0]["state_sha256"] == res[1]["state_sha256"]
              and all(len(r["train_loss"]) == 1 and r["step"] == steps + steps // 2 for r in res))
    log(f"dist fit resume (rank 1 without the file): epochs {[r['train_loss'] for r in res]}, "
        f"steps {[r['step'] for r in res]}, states bit-identical "
        f"{res[0]['state_sha256'] == res[1]['state_sha256']}, logs {logs_ok} "
        f"-> {'ok' if res_ok else 'FAIL'}")
    if not res_ok:
        failures.append("fit resume")
    out["fit"] = {"losses": losses, "pckh": fit[0]["pckh"], "pckh_one": one_fit["pckh"],
                  "eval_info": [r["eval_info"] for r in fit], "files": files,
                  "epoch_seconds_two_ranks": fit[0]["epoch_seconds"],
                  "epoch_seconds_one_process": one_fit["epoch_seconds"],
                  "images_per_sec_two_ranks": fit[0]["images_per_sec"],
                  "launches": fit[0]["launches"]}
    log(f"dist fit ({card}): epoch s {fit[0]['epoch_seconds']} on 2 ranks sharing the card, "
        f"{one_fit['epoch_seconds']} in 1 process (phase_fit)")

    # (f) and (g).
    dist_hold_fit_tp(results, two, fit_tp_one, card, out, failures)
    dist_fit_mesh(results, root, card, out, failures)

    # (e): NCCL, a world of one.
    t0 = time.perf_counter()
    (nccl,) = dist_spawn(root, "nccl", [{"name": "nccl", "kind": "nccl"}], world=1,
                         backend="nccl")
    out["wall_s"]["nccl"] = time.perf_counter() - t0
    n = nccl["nccl"]
    nccl_ok = (n["backend"] == "nccl" and n["device"].startswith("cuda")
               and n["string"] == "final_model.pth" and n["steps_on_host"]
               and n["steps"] == [1.0, 1.0, 1.0, 1.0] and n["scalars"] == [3.0, 1e-4]
               and abs(n["weight"] - 0.3) < 1e-7 and n["state_kept"] and n["moments_kept"]
               and n["sum_ok"] and n["grad_ok"])
    log(f"dist nccl (a world of one): {json.dumps({k: v for k, v in n.items() if k != 'wall_s'})}"
        f" -> {'ok' if nccl_ok else 'FAIL'}")
    if not nccl_ok:
        failures.append("nccl")
    out["nccl"] = n
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    log(f"dist wall seconds ({card}): {json.dumps(out['wall_s'])}")
    if failures:
        raise AssertionError("phase_dist: " + "; ".join(failures))
    return out


def phase_cli(results: dict, serving: dict, root: str) -> dict:
    """The five other CLIs of ``dino_pose_tpu_torch.cli`` on the card, each
    through its ``main`` (or ``benchmark_model``), on dinov2-small + LoRA r=8
    at full width with ``randomise_for_serving``'s weights written to a
    ``.pth`` under ``root``: model_info's four modes (their key lines, no
    launch), export_coreml to ``.pth`` (the reload's forward bit-equal to the
    source model's) and to ``.mlpackage`` (the ``.pth`` beside it), the demo
    on a seeded 300x400 JPEG (the heatmaps it draws from bit-equal to
    serve.make_predictor's and within the serving tolerances of the plain
    path) and its chunked video prediction on CLI_FRAMES seeded frames
    (a full and a padded chunk), benchmark_model, and compare_models with
    --device-time (dinov2-small against fastvit_t8). Each call's launches are
    held exactly; plotting and the video codecs run where matplotlib and
    imageio are installed, and a line says what was not driven."""
    import importlib.util
    import io

    from PIL import Image

    from dino_pose_tpu_torch.cli import benchmark_model as bench_cli
    from dino_pose_tpu_torch.cli import compare_models, demo, export_coreml, model_info
    from dino_pose_tpu_torch.data.preprocess import create_preprocessor
    from dino_pose_tpu_torch.io.checkpoint import load_model_smart, save_checkpoint
    from dino_pose_tpu_torch.models.registry import create_model_from_config
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.serve import device_pixels, make_predictor

    t_phase = time.perf_counter()
    card = nvidia_smi()
    have = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "imageio", "cv2")}
    log(f"cli: plotting and codec packages here: {have}")
    model = create_model_from_config(dict(LORA_CONFIG), seed=SEED, device="cuda",
                                     pretrained=False)
    randomise_for_serving(model, torch.Generator().manual_seed(SEED + 30))
    ckpt = os.path.join(root, "ckpt.pth")
    save_checkpoint(ckpt, model, epoch=5, train_loss=0.3, valid_loss=0.4)
    total = dict.fromkeys(B.LAUNCHES, 0)
    cli: dict = {"card": card, "packages": have}

    def call(tag: str, per_forward: list, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` with its launches held to
        sum(n * launches) over ``per_forward``'s (launches, n); returns what
        fn returns and what it printed."""
        want = dict.fromkeys(B.LAUNCHES, 0)
        for per, n in per_forward:
            for k, v in per.items():
                want[k] += n * v
        B.reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            got = fn(*args, **kwargs)
        torch.cuda.synchronize()
        launches = dict(B.LAUNCHES)
        log(f"cli {tag}: launches {({k: v for k, v in launches.items() if v})}")
        if launches != want:
            raise AssertionError(f"cli {tag}: launches {launches}, want {want}")
        for k, v in launches.items():
            total[k] += v
        return got, out.getvalue()

    # model_info: no model, no launch.
    for argv, lines in ((["--checkpoint", ckpt], ["Dinov2PoseModelLoRA", "epoch: 5",
                                                  f"backbone: {model.model_name}"]),
                        (["--backbones"], ["facebook/dinov2-small", "FASTVIT Family:"]),
                        (["--families"], ["DINOV2 Family", "Total models:"]),
                        (["--list-checkpoints", root], ["ckpt.pth"])):
        _, text = call("model_info " + argv[0], [], model_info.main, argv)
        missing = [line for line in lines if line not in text]
        if missing:
            raise AssertionError(f"cli model_info {argv}: missing {missing} in {text!r}")

    # export_coreml: one self-check forward each; the reload bit-equal.
    out_pth = os.path.join(root, "out.pth")
    _, text = call("export_coreml .pth", [(SERVING_LAUNCHES, 1)], export_coreml.main,
                   ["-c", ckpt, "-o", out_pth])
    if "Self-check forward: heatmaps (1, 24, 48, 48), depths (1, 24)" not in text:
        raise AssertionError(f"cli export_coreml: no self-check line in {text!r}")
    with contextlib.redirect_stdout(io.StringIO()):
        reloaded = load_model_smart(out_pth, device="cuda")
    x = device_pixels(np.random.default_rng(SEED + 31).standard_normal((2, 3, 224, 224)),
                      next(model.parameters()).device)
    with torch.inference_mode():
        same = all(torch.equal(a, b) for a, b in zip(reloaded(x), model(x)))
    log(f"cli export_coreml: out.pth through load_model_smart, forward bit-equal: {same}")
    if not same:
        raise AssertionError("cli export_coreml: the exported model serves other outputs")
    del reloaded
    call("export_coreml .mlpackage", [(SERVING_LAUNCHES, 1)], export_coreml.main,
         ["-c", ckpt, "-o", os.path.join(root, "m.mlpackage")])
    if not os.path.exists(os.path.join(root, "m.pth")):
        raise AssertionError("cli export_coreml: no m.pth beside m.mlpackage")

    # The demo on one image: the heatmaps it draws from.
    jpg, png = os.path.join(root, "person.jpg"), os.path.join(root, "out.png")
    rng = np.random.default_rng(SEED + 32)
    Image.fromarray(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)).save(jpg)
    drawn = []
    draw_image = demo.draw_image

    def capture(image, heatmaps, z, args):
        drawn.append((heatmaps, z))
        if have["matplotlib"]:
            draw_image(image, heatmaps, z, args)

    demo.draw_image = capture
    try:
        call("demo image", [(SERVING_LAUNCHES, 1)], demo.main,
             ["--input", jpg, "--model", ckpt, "--output", png, "--plot_mode", "combined"])
    finally:
        demo.draw_image = draw_image
    image = Image.open(jpg).convert("RGB")
    predict = make_predictor(model)
    want = predict([image])
    same = np.array_equal(drawn[0][0], want[2][0]) and np.array_equal(drawn[0][1], want[1][0])
    log(f"cli demo: drawn heatmaps and z bit-equal to serve.make_predictor's: {same}")
    if len(drawn) != 1 or not same:
        raise AssertionError("cli demo: the drawn heatmaps are not make_predictor's")
    preprocessor = create_preprocessor(model.model_name)
    compare_paths(model, preprocessor([image])["pixel_values"], want, "cli demo image")
    if have["matplotlib"]:
        if not os.path.getsize(png) > 0:
            raise AssertionError("cli demo: empty PNG")
        log(f"cli demo: {png} written, {os.path.getsize(png)} bytes")
    else:
        log("cli demo: rendering not driven: matplotlib is not installed here (the forward "
            "ran on the card through the kernels; no PNG written)")

    # The demo's chunked video prediction: a full chunk and a padded one.
    frames = seeded_images(np.random.default_rng(SEED + 33), CLI_FRAMES)
    chunks, _ = call("demo chunks", [(SERVING_LAUNCHES, -(-CLI_FRAMES // CLI_FRAME_BATCH))],
                     lambda: list(demo.predict_chunks(frames, predict, preprocessor,
                                                      CLI_FRAME_BATCH)))
    for i, (chunk, hm, z) in enumerate(chunks):
        pixels = demo._pad_to(preprocessor(chunk)["pixel_values"], CLI_FRAME_BATCH)
        out = predict(pixels)
        n = len(chunk)
        if not (np.array_equal(hm, out[2][:n]) and np.array_equal(z, out[1][:n])):
            raise AssertionError(f"cli demo chunk {i}: outputs are not the padded batch's")
        compare_paths(model, pixels, out, f"cli demo chunk {i} ({n} frames)")
    if have["matplotlib"] and have["imageio"]:
        import imageio

        gif_in, gif_out = os.path.join(root, "in.gif"), os.path.join(root, "out.gif")
        imageio.mimsave(gif_in, [np.asarray(f.resize((160, 120))) for f in frames[:3]], fps=5)
        call("demo gif", [(SERVING_LAUNCHES, 1)], demo.main,
             ["--input", gif_in, "--model", ckpt, "--output", gif_out, "--max_frames", "2",
              "--batch_size", "2"])
        if len(imageio.mimread(gif_out)) != 2:
            raise AssertionError("cli demo gif: not two frames written")
    else:
        log("cli demo: video codecs not driven: matplotlib or imageio is not installed here "
            "(the chunked prediction above ran on the card)")

    # benchmark_model on the checkpoint, compare_models with --device-time.
    bench, _ = call("benchmark_model", [(SERVING_LAUNCHES, CLI_BENCH_WARMUP + 2 * CLI_BENCH_ITERS)],
                    bench_cli.benchmark_model, ckpt, warmup=CLI_BENCH_WARMUP,
                    iters=CLI_BENCH_ITERS)
    params = model.count_parameters(trainable_only=False)
    # benchmark_model's default warm-up (CLI_BENCH_WARMUP) and timed forwards,
    # then --device-time's.
    n_cmp = CLI_BENCH_WARMUP + 2 * CLI_COMPARE_ITERS + compare_models.DEVICE_TIME_WARMUP + \
        CLI_COMPARE_ITERS
    (a, b), text = call("compare_models", [(SMALL_LAUNCHES, n_cmp), (SERVING_T8_LAUNCHES, n_cmp)],
                        compare_models.main,
                        ["--model_a", "facebook/dinov2-small", "--model_b",
                         "timm/fastvit_t8.apple_in1k", "--iters", str(CLI_COMPARE_ITERS),
                         "--device-time"])
    times = [bench[k] for k in ("avg_ms", "p50_ms", "device_ms", "device_p50_ms")] + \
        [r[k] for r in (a, b) for k in ("avg_ms", "p50_ms", "device_ms", "device_p50_ms")]
    if not all(t > 0 for t in times) or bench["params"] != params or "on-device:" not in text:
        raise AssertionError(f"cli: times {times}, params {bench['params']} vs {params}")
    record_launches(results, "cli", total)
    cli.update(
        benchmark_model={k: bench[k] for k in ("avg_ms", "p50_ms", "device_ms", "device_p50_ms",
                                               "params")},
        compare_models={r["model"]: {k: r[k] for k in ("avg_ms", "p50_ms", "device_ms",
                                                       "device_p50_ms", "params")}
                        for r in (a, b)},
        serving_b1_latency_ms_p50=serving["b1_latency_ms_p50"],
        serving_forward_ms_b1=serving["forward_ms_b1"],
        launches={k: v for k, v in total.items() if v},
        phase_s=time.perf_counter() - t_phase)
    log(f"cli: phase {cli['phase_s']:.1f} s, launches {({k: v for k, v in total.items() if v})}")
    return cli


def profile_forward(model, image_size: int = 224) -> None:
    """Kernel time by name over five batch-1 forwards (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1, 3, image_size, image_size, generator=torch.Generator().manual_seed(SEED))
    x = x.cuda().to(torch.bfloat16)
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                model(x)
            torch.cuda.synchronize()
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))


def profile_train_step(step, state, batch) -> None:
    """Kernel time by name over two train steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from dino_pose_tpu_torch.ops import block as B

    saved = dict(B.LAUNCHES)
    state, _ = step(state, batch, LR, SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state, _ = step(state, batch, LR, SEED)
        torch.cuda.synchronize()
    B.LAUNCHES.update(saved)
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))


# One arm of the A/B of a train step on the kernel path, run in its own
# process from the root of a tree (this one or the one --ab-parent names)
# with that tree's chip_smoke.py and package: two warm-up steps, then CUDA
# events around AB_STEPS steps, each way's weights random from the same
# seed. AB_CASES names the steps of each --ab-steps choice: the config, the
# batch and the input size (chip_smoke.py names both trees have), and the
# switches set in the process's environment (the t8 arms step sets ARMS).
AB_STEPS = 10
AB_CASES = {
    "t8": {"t8": ("T8_CONFIG", "T8_TRAIN_BATCH", "FASTVIT_IMAGE", {}),
           "t8_arms": ("T8_CONFIG", "T8_TRAIN_BATCH", "FASTVIT_IMAGE", ARMS)},
    "unfreeze_504": {"dinov2_small": ("UNFREEZE_CONFIG", "LONG_BATCH", "LONG_IMAGE", {}),
                     "dinov2_large": ("LARGE_UNFREEZE_CONFIG", "LONG_BATCH", "LONG_IMAGE", {})},
}
AB_ARM = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from dino_pose_tpu_torch.models.registry import create_model_from_config
from dino_pose_tpu_torch.ops import _ext
_ext.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
model = create_model_from_config(dict(cs.{config}), seed=cs.SEED, device="cuda",
                                 pretrained=False)
cs.randomise_for_serving(model, torch.Generator().manual_seed(cs.SEED + 4))
batch = cs.synthetic_batch(cs.{batch}, cs.{image})
state, step = cs.make_step(model, cs.{config}, kernels=True, image_size=cs.{image})
for _ in range(2):
    state, _ = step(state, batch, cs.LR, cs.SEED)
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
torch.cuda.synchronize()
start.record()
for _ in range({steps}):
    state, _ = step(state, batch, cs.LR, cs.SEED)
end.record()
torch.cuda.synchronize()
print("AB_STEP_MS " + json.dumps(start.elapsed_time(end) / {steps}))
"""


# One arm of the A/B of the flash phase's wall time: the kernels built, one
# untimed phase_flash at dinov2-small's width (a fresh process's first-use
# costs, which the whole script's earlier phases pay before its flash
# phase: cuBLAS and cuDNN set-up, the first CUDA graph captures, and where
# SDPA's backward refuses capture, the profiler's), then phase_flash at
# dinov2-small's, -base's and -large's widths on a host clock, in a process
# of its own from the root of a tree (this one or the one --ab-flash names)
# with that tree's chip_smoke.py and package.
AB_FLASH_ARM = """
import json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from dino_pose_tpu_torch.ops import _ext
_ext.build()
_ext.lib()
torch.backends.cuda.matmul.allow_tf32 = False
cs.phase_flash({})
torch.cuda.synchronize()
print("warm-up done")
out = {}
for model in (None, "dinov2-base", "dinov2-large"):
    t0 = time.perf_counter()
    cs.phase_flash({}, model)
    torch.cuda.synchronize()
    out[model or "dinov2-small"] = time.perf_counter() - t0
print("AB_FLASH_S " + json.dumps(out))
"""


def ab_flash(parent: str) -> dict:
    """The flash phase's wall seconds after a warm-up (``AB_FLASH_ARM``),
    this tree against the tree at ``parent`` on this card, each arm a fresh
    process, in turns parent, change, change, parent."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs: dict = {"parent": [], "change": []}
    for arm in ("parent", "change", "change", "parent"):
        root = os.path.abspath(parent) if arm == "parent" else here
        proc = subprocess.run([sys.executable, "-c", AB_FLASH_ARM], cwd=root,
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB_FLASH_S ")]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"flash A/B arm {arm} failed ({proc.returncode}): "
                               f"{proc.stderr[-2000:]}")
        runs[arm].append(json.loads(lines[-1].split(" ", 1)[1]))
        timed = proc.stdout.split("warm-up done", 1)[-1]
        for line in timed.splitlines():
            if line.startswith("wall flash") or "refused" in line:
                log(f"  {arm}: {line}")
        log(f"ab flash phase, {arm} ({root}): wall s {json.dumps(runs[arm][-1])}, total "
            f"{sum(runs[arm][-1].values()):.1f} s")
    out = {arm: {"seconds": float(np.mean([sum(r.values()) for r in rs])), "runs": rs}
           for arm, rs in runs.items()}
    log("ab_flash " + json.dumps(out))
    return out


def ab_step(parent: str, which: str = "t8") -> dict:
    """The train steps of ``AB_CASES[which]`` on the kernel path (by
    default the fastvit_t8 + LoRA bs=128 step, default and with both opt-in
    arms on; "unfreeze_504" the dinov2-small and -large unfreeze-last-4
    steps at 504², bs=32), this tree against the tree at ``parent`` (e.g. a
    ``git archive`` of the parent commit) on this card, each arm a fresh
    process, in turns parent, change, change, parent."""
    here = os.path.dirname(os.path.abspath(__file__))
    out: dict = {}
    for step, (config, batch, image, env) in AB_CASES[which].items():
        runs: dict = {"parent": [], "change": []}
        code = AB_ARM.format(steps=AB_STEPS, config=config, batch=batch, image=image)
        for arm in ("parent", "change", "change", "parent"):
            root = os.path.abspath(parent) if arm == "parent" else here
            proc = subprocess.run([sys.executable, "-c", code],
                                  cwd=root, capture_output=True, text=True, timeout=900,
                                  env={**os.environ, **env})
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB_STEP_MS ")]
            if proc.returncode != 0 or not lines:
                raise RuntimeError(f"A/B {step} arm {arm} failed ({proc.returncode}): "
                                   f"{proc.stderr[-2000:]}")
            runs[arm].append(json.loads(lines[-1].split(" ", 1)[1]))
            log(f"ab {step} {config} bs={batch} step, {arm} ({root}): {runs[arm][-1]:.3f} ms")
        out[step] = {arm: {"step_ms": float(np.mean(ms)), "runs": ms} for arm, ms in runs.items()}
        out[step]["faster_ms"] = out[step]["parent"]["step_ms"] - out[step]["change"]["step_ms"]
    log("ab_step " + json.dumps(out))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write all measurements to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="print torch.profiler kernel tables of the batch-1 forward and "
                         "the train steps: at 224² LoRA and unfreeze (batch 128), at 504² "
                         "unfreeze (batch 32); of the fastvit_t8 + LoRA batch-1 forward "
                         "and its LoRA train step (batch 128); of the dinov2-large + "
                         "LoRA batch-1 forward and its LoRA train step (batch 128); of "
                         "the dinov2-large and dinov2-base unfreeze-last-4 train steps "
                         "(batch 128); of "
                         "the fastvit_t8 + LoRA train step with both opt-in arms (batch 128); "
                         "of the dinov2-base + LoRA tp=2 batch-1 forward and its LoRA step; "
                         "and of the dinov2-small + LoRA step with the gated LayerNorm")
    ap.add_argument("--ab-parent", metavar="DIR",
                    help="only time the fastvit_t8 + LoRA bs=128 train step on the kernel path, "
                         "default and with both opt-in arms on, against the tree at DIR "
                         "(parent, change, change, parent; each arm a fresh process), print "
                         "them and exit")
    ap.add_argument("--ab-steps", choices=sorted(AB_CASES), default="t8",
                    help="with --ab-parent: the steps to time (t8: the above; unfreeze_504: "
                         "the dinov2-small and -large unfreeze-last-4 steps at 504², bs=32)")
    ap.add_argument("--flash-only", action="store_true",
                    help="only build the kernels and run phase_flash at dinov2-small's, "
                         "-base's and -large's widths (the streamed attention pair held "
                         "and timed), then time the chains' attention step on both routes "
                         "across the resident route's S (flash_crossover), print the times "
                         "and exit")
    ap.add_argument("--ab-flash", metavar="DIR",
                    help="only time the flash phase's wall seconds (build and a warm-up "
                         "excluded) against the tree at DIR (parent, change, change, parent; "
                         "each arm a fresh process), print them and exit")
    ap.add_argument("--dist-worker", metavar="SPEC",
                    help="run as one rank of phase_dist (started by the script itself under "
                         "torchrun's launch variables): the jobs SPEC names")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.dist_worker:
        return dist_worker(args.dist_worker)
    if args.ab_parent:
        log(f"card: {nvidia_smi()}")
        ab = ab_step(args.ab_parent, args.ab_steps)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": nvidia_smi(), "ab_step": ab}, f, indent=1)
        return 0
    if args.ab_flash:
        log(f"card: {nvidia_smi()}")
        ab = ab_flash(args.ab_flash)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": nvidia_smi(), "ab_flash": ab}, f, indent=1)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dino_pose_tpu_torch.core.mesh import MeshSpec, create_mesh
    from dino_pose_tpu_torch.ops import _ext, dispatch

    card = nvidia_smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _ext.build(verbose=True)
    _ext.lib()
    log(f"build_seconds {time.perf_counter() - t0:.1f}")
    if args.flash_only:
        results: dict = {}
        flash = {}
        for model in (None, "dinov2-base", "dinov2-large"):
            t1 = time.perf_counter()
            flash[model] = phase_flash(results, model)
            log(f"wall flash {model or 'dinov2-small'}: {time.perf_counter() - t1:.1f} s")
        crossover = flash_crossover()
        log(f"flash_only_seconds {time.perf_counter() - t0:.1f}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"card": card, "flash": {str(m): t for m, t in flash.items()},
                           "crossover": crossover, "errors": results}, f, indent=1)
        return 0
    marks = [time.perf_counter()]

    def mark(what: str) -> None:
        marks.append(time.perf_counter())
        log(f"wall {what}: {marks[-1] - marks[-2]:.1f} s")

    # No phase but phase_pretrained reads a hub cache: the default
    # (pretrained) builds of fit, the CLIs and the ranks see an empty one.
    empty_cache = tempfile.mkdtemp(prefix="hub_empty_")
    os.environ["HF_HUB_CACHE"] = empty_cache

    results: dict = {}
    serving: dict = {}
    lora: dict = {}
    unfreeze: dict = {}
    serving_504: dict = {}
    unfreeze_504: dict = {}
    serving_t8: dict = {}
    serving_sa12: dict = {}
    serving_ma36: dict = {}
    serving_sa24: dict = {}
    serving_sa36: dict = {}
    train_t8: dict = {}
    train_sa12: dict = {}
    train_ma36: dict = {}
    fold_arms: dict = {"serving_t8_fold0": {}, "serving_sa12_fold0": {}, "train_t8_fold0": {},
                       "train_t8_branch": {}, "train_t8_fold_arms": {},
                       "train_sa12_ffn_fold": {}}
    serving_base: dict = {}
    train_base: dict = {}
    serving_large: dict = {}
    train_large: dict = {}
    unfreeze_large: dict = {}
    unfreeze_base: dict = {}
    serving_t8_dw: dict = {}
    train_t8_pair: dict = {}
    serving_base_tp: dict = {}
    train_base_tp: dict = {}
    fastvit_tp: dict = {"serving_t8": {}, "serving_sa12": {}, "train_t8": {}, "train_sa12": {}}
    serving_ln: dict = {}
    lora_ln: dict = {}
    serving_pre: dict = {}
    lora_pre: dict = {}
    long_wide: dict = {}
    ln_wide: dict = {}
    gemm_times = phase_gemm(results)
    mark("gemm")
    gemm_bwd_times = phase_gemm_bwd(results)
    mark("gemm_bwd")
    core_times = phase_attention_core(results)
    mark("attention_core")
    phase_kernels(results)
    phase_mlp_dx(results)
    phase_train_kernels(results)
    mark("kernels")
    flash_times = phase_flash(results)
    mark("flash")
    model = phase_serving(results, serving)
    with tempfile.TemporaryDirectory() as cli_root:
        cli = phase_cli(results, serving, cli_root)
    mark("serving, cli")
    lora_run = phase_train(results, lora, "lora", LORA_CONFIG, LORA_LAUNCHES, LORA_GRAD_NAMES,
                           ("fused_mlp_dx",))
    unfreeze_run = phase_train(results, unfreeze, "unfreeze", UNFREEZE_CONFIG, UNFREEZE_LAUNCHES,
                               UNFREEZE_GRAD_NAMES, ("fused_mlp_bwd", "fused_attn_bwd"))
    model_504 = phase_serving(results, serving_504, "serving_504", LONG_IMAGE,
                              SERVING_504_LAUNCHES, n_lat=10, n_batches=4, fwd_iters=5, pil=False)
    unfreeze_504_run = phase_train(
        results, unfreeze_504, "unfreeze_504", UNFREEZE_CONFIG, UNFREEZE_504_LAUNCHES,
        UNFREEZE_GRAD_NAMES, ("fused_mlp_bwd", "fused_attn_bwd"), batch_size=LONG_BATCH,
        image_size=LONG_IMAGE, steps=LONG_STEPS, timed=3)
    mark("dinov2-small lora, unfreeze, 504²")
    with tempfile.TemporaryDirectory() as pre_root:
        pretrained = phase_pretrained(results, serving_pre, lora_pre, pre_root)
    mark("pretrained")
    for wide, lora_config, unfreeze_config in (
            ("dinov2-base", BASE_LORA_CONFIG, BASE_UNFREEZE_CONFIG),
            ("dinov2-large", LARGE_LORA_CONFIG, LARGE_UNFREEZE_CONFIG)):
        tag, layers = wide.replace("-", "_"), LONG_WIDE_LAYERS[wide]
        phase_kernels(results, wide, batches=(1, 8), seqs=(S_LONG,), seed=SEED + 41)
        phase_train_kernels(results, wide, cases=((LONG_BATCH, S_LONG),))
        for b, t in phase_flash(results, wide).items():
            flash_times.setdefault(b, {}).update(t)
        long_wide[wide] = {"serving_504": {}, "unfreeze_504": {}}
        phase_serving(results, long_wide[wide]["serving_504"], f"serving_504_{tag}", LONG_IMAGE,
                      serving_504_launches(layers), n_lat=8, n_batches=3, fwd_iters=5,
                      config=lora_config, pil=False)
        phase_train(results, long_wide[wide]["unfreeze_504"], f"unfreeze_504_{tag}",
                    unfreeze_config, unfreeze_504_launches(layers),
                    unfreeze_grad_names(layers - 1), UNFREEZE_504_WIDE_RECORDED,
                    batch_size=LONG_BATCH, image_size=LONG_IMAGE, steps=LONG_STEPS, timed=3)
        mark(f"{wide} 504²")
    convffn_times = phase_convffn(results, backward=False)
    model_t8 = phase_serving(results, serving_t8, "serving_fastvit_t8",
                             per_forward_launches=SERVING_T8_LAUNCHES, config=T8_CONFIG)
    phase_serving(results, serving_sa12, "serving_fastvit_sa12",
                  per_forward_launches=SERVING_SA12_LAUNCHES, n_lat=10, n_batches=4,
                  fwd_iters=10, config=SA12_CONFIG)
    phase_serving(results, serving_ma36, "serving_fastvit_ma36",
                  per_forward_launches=SERVING_MA36_LAUNCHES, n_lat=10, n_batches=4,
                  fwd_iters=10, config=MA36_CONFIG)
    for serving_sa, tag, launches, config in (
            (serving_sa24, "serving_fastvit_sa24", SERVING_SA24_LAUNCHES, SA24_CONFIG),
            (serving_sa36, "serving_fastvit_sa36", SERVING_SA36_LAUNCHES, SA36_CONFIG)):
        phase_serving(results, serving_sa, tag, per_forward_launches=launches, n_lat=10,
                      n_batches=4, fwd_iters=10, config=config,
                      recorded=FASTVIT_SERVING_RECORDED)
    convffn_bwd_times = phase_convffn(results, backward=True)
    t8_run = phase_train(results, train_t8, "fastvit_t8_lora", T8_CONFIG, T8_TRAIN_LAUNCHES,
                         FASTVIT_GRAD_NAMES, ("fused_convffn", "fused_convffn_bwd"),
                         batch_size=T8_TRAIN_BATCH, image_size=FASTVIT_IMAGE)
    phase_backbone_grads(train_t8, "fastvit_t8_lora", T8_CONFIG, T8_TRAIN_BATCH)
    phase_train(results, train_sa12, "fastvit_sa12_lora", SA12_LORA_CONFIG, SA12_TRAIN_LAUNCHES,
                FASTVIT_GRAD_NAMES, ("fused_convffn", "fused_convffn_bwd", "flash_fwd",
                                     "flash_bwd"),
                batch_size=SA12_TRAIN_BATCH, image_size=FASTVIT_IMAGE, steps=2, timed=3)
    phase_backbone_grads(train_sa12, "fastvit_sa12_lora", SA12_LORA_CONFIG, SA12_TRAIN_BATCH)
    phase_train(results, train_ma36, "fastvit_ma36_lora", MA36_CONFIG, MA36_TRAIN_LAUNCHES,
                MA36_GRAD_NAMES, ("fused_convffn", "fused_convffn_bwd", "flash_fwd", "flash_bwd"),
                batch_size=MA36_TRAIN_BATCH, image_size=FASTVIT_IMAGE, steps=2, timed=3)
    phase_backbone_grads(train_ma36, "fastvit_ma36_lora", MA36_CONFIG, MA36_TRAIN_BATCH)
    mark("fastvit serving, convffn, fastvit training")
    t8_recorded = ("fused_convffn", "fused_convffn_bwd")
    sa12_recorded = (*t8_recorded, "flash_fwd", "flash_bwd")
    with gates(FOLD0):
        phase_serving(results, fold_arms["serving_t8_fold0"], "serving_fastvit_t8_fold0",
                      per_forward_launches=SERVING_T8_LAUNCHES, n_lat=10, n_batches=4,
                      fwd_iters=10, config=T8_CONFIG, recorded=("fused_convffn",))
        phase_serving(results, fold_arms["serving_sa12_fold0"], "serving_fastvit_sa12_fold0",
                      per_forward_launches=SERVING_SA12_LAUNCHES, n_lat=10, n_batches=4,
                      fwd_iters=10, config=SA12_CONFIG, recorded=FASTVIT_SERVING_RECORDED)
    for env, key, tag, config, launches, recorded, batch_size in (
            (FOLD0, "train_t8_fold0", "fastvit_t8_lora_fold0", T8_CONFIG, T8_TRAIN_LAUNCHES,
             t8_recorded, T8_TRAIN_BATCH),
            (BLOCKS_BRANCH, "train_t8_branch", "fastvit_t8_lora_branch", T8_CONFIG,
             T8_TRAIN_LAUNCHES, t8_recorded, T8_TRAIN_BATCH),
            (FFN_FOLD, "train_sa12_ffn_fold", "fastvit_sa12_lora_ffn_fold", SA12_LORA_CONFIG,
             SA12_TRAIN_LAUNCHES, sa12_recorded, SA12_TRAIN_BATCH)):
        with gates(env):
            phase_train(results, fold_arms[key], tag, config, launches, FASTVIT_GRAD_NAMES,
                        recorded, batch_size=batch_size, image_size=FASTVIT_IMAGE,
                        steps=ARM_STEPS, timed=ARM_TIMED)
            phase_backbone_grads(fold_arms[key], tag, config, batch_size)
    mark("fastvit sa24, sa36, ma36 training, fold switches")
    wide_times = []
    for wide in WIDE:
        phase_kernels(results, wide, batches=(1, 8, TRAIN_BATCH), seqs=(S,), seed=SEED + 12)
        phase_mlp_dx(results, wide, seed=SEED + 12)
        wide_times.append(phase_times(wide))
    phase_serving(results, serving_base, "serving_dinov2_base", n_lat=10, n_batches=4,
                  fwd_iters=10, config=BASE_LORA_CONFIG)
    phase_train(results, train_base, "dinov2_base_lora", BASE_LORA_CONFIG, LORA_LAUNCHES,
                lora_grad_names(11), BASE_RECORDED, steps=WIDE_STEPS, timed=WIDE_TIMED,
                grad_batches=WIDE_GRAD_BATCHES)
    phase_backbone_grads(train_base, "dinov2_base_lora", BASE_LORA_CONFIG, TRAIN_BATCH, 224)
    tp_times = phase_tp(results)
    with dispatch.scoped():
        create_mesh(MeshSpec(1, TP))
        model_tp = phase_serving(results, serving_base_tp, "serving_dinov2_base_tp2",
                                 per_forward_launches=SERVING_TP_LAUNCHES, n_lat=10, n_batches=4,
                                 fwd_iters=10, config=BASE_LORA_CONFIG)
        tp_run = phase_train(results, train_base_tp, "dinov2_base_lora_tp2", BASE_LORA_CONFIG,
                             TP_LORA_LAUNCHES, lora_grad_names(11), TP_SHARD, steps=WIDE_STEPS,
                             timed=WIDE_TIMED, grad_batches=WIDE_GRAD_BATCHES)
        phase_backbone_grads(train_base_tp, "dinov2_base_lora_tp2", BASE_LORA_CONFIG,
                             TRAIN_BATCH, 224)
    log("dinov2_base_lora step ms by route (this card, kernels / plain): one shard "
        f"{train_base['step_ms_kernels']:.3f} / {train_base['step_ms_plain']:.3f}, tp=2 on one "
        f"card {train_base_tp['step_ms_kernels']:.3f} / {train_base_tp['step_ms_plain']:.3f}; "
        f"serving b1 p50 {serving_base['b1_latency_ms_p50']:.3f} / tp=2 "
        f"{serving_base_tp['b1_latency_ms_p50']:.3f} ms, b8 images/s "
        f"{serving_base['b8_images_per_s']:.2f} / {serving_base_tp['b8_images_per_s']:.2f}")
    mark("dinov2-base 224², tp")
    phase_fastvit_tp_kernels(results)
    sa12_tp_recorded = ("fused_convffn", "fused_convffn_bwd", "flash_fwd", "flash_bwd")
    with dispatch.scoped():
        create_mesh(MeshSpec(1, TP))
        phase_serving(results, fastvit_tp["serving_t8"], "serving_fastvit_t8_tp2",
                      per_forward_launches=T8_TP_SERVING, n_lat=10, n_batches=4, fwd_iters=10,
                      config=T8_CONFIG, recorded=("fused_convffn",))
        phase_serving(results, fastvit_tp["serving_sa12"], "serving_fastvit_sa12_tp2",
                      per_forward_launches=SA12_TP_SERVING, n_lat=10, n_batches=4, fwd_iters=10,
                      config=SA12_LORA_CONFIG, recorded=FASTVIT_SERVING_RECORDED)
        phase_train(results, fastvit_tp["train_t8"], "fastvit_t8_lora_tp2", T8_CONFIG,
                    T8_TP_TRAIN, FASTVIT_GRAD_NAMES, ("fused_convffn", "fused_convffn_bwd"),
                    batch_size=T8_TRAIN_BATCH, image_size=FASTVIT_IMAGE, steps=2, timed=3)
        phase_train(results, fastvit_tp["train_sa12"], "fastvit_sa12_lora_tp2", SA12_LORA_CONFIG,
                    SA12_TP_TRAIN, FASTVIT_GRAD_NAMES, sa12_tp_recorded,
                    batch_size=SA12_TRAIN_BATCH, image_size=FASTVIT_IMAGE, steps=2, timed=3)
    for key, tag, config, bs in (("one_card_t8", "fastvit_t8_lora_tp2", T8_CONFIG,
                                  T8_TRAIN_BATCH),
                                 ("one_card_sa12", "fastvit_sa12_lora_tp2", SA12_LORA_CONFIG,
                                  SA12_TRAIN_BATCH)):
        fastvit_tp[key] = phase_fastvit_tp_one_card(tag, config, bs)
    log(f"fastvit under (1, 2) on one card: every ConvFFN {TP} fused_convffn launches a layer "
        f"(t8 {T8_TP_SERVING['fused_convffn']} a forward for 10 layers, sa12 "
        f"{SA12_TP_SERVING['fused_convffn']} for 12), each attention block {TP} flash launches")
    log("fastvit + LoRA step ms (this card, kernels / plain): t8 bs=128 one card "
        f"{train_t8['step_ms_kernels']:.3f} / {train_t8['step_ms_plain']:.3f}, tp=2 "
        f"{fastvit_tp['train_t8']['step_ms_kernels']:.3f} / "
        f"{fastvit_tp['train_t8']['step_ms_plain']:.3f}; sa12 bs=32 one card "
        f"{train_sa12['step_ms_kernels']:.3f} / {train_sa12['step_ms_plain']:.3f}, tp=2 "
        f"{fastvit_tp['train_sa12']['step_ms_kernels']:.3f} / "
        f"{fastvit_tp['train_sa12']['step_ms_plain']:.3f}; serving b1 p50 t8 "
        f"{serving_t8['b1_latency_ms_p50']:.3f} / tp=2 "
        f"{fastvit_tp['serving_t8']['b1_latency_ms_p50']:.3f} ms")
    mlp_heads = phase_mlp_heads(results)
    mark("fastvit tp, mlp heads")
    ln_times = phase_layernorm(results)
    with gates(LN_GATE):
        phase_serving(results, serving_ln, "serving_ln", per_forward_launches=SERVING_LN_LAUNCHES)
        ln_run = phase_train(results, lora_ln, "lora_ln", LORA_CONFIG, LORA_LN_LAUNCHES,
                             LORA_GRAD_NAMES, ("fused_mlp_dx", "fused_layernorm"))
        for tag, config, serve_launches, step_launches, grad_names, factor in LN_WIDE.values():
            ln_wide[tag] = {"serving": {}, "lora": {}}
            phase_serving(results, ln_wide[tag]["serving"], f"serving_{tag}",
                          per_forward_launches=serve_launches, n_lat=8, n_batches=3,
                          fwd_iters=5, config=config)
            phase_train(results, ln_wide[tag]["lora"], f"lora_{tag}", config, step_launches,
                        grad_names, ("fused_mlp_dx", "fused_layernorm"), steps=WIDE_STEPS,
                        timed=WIDE_TIMED, grad_factor=factor)
            phase_backbone_grads(ln_wide[tag]["lora"], f"lora_{tag}", config, TRAIN_BATCH, 224)
    mark("layernorm")
    log("dinov2-small + LoRA by final LayerNorm (this card, kernels / plain): plain norm "
        f"step {lora['step_ms_kernels']:.3f} / {lora['step_ms_plain']:.3f} ms, serving b1 p50 "
        f"{serving['b1_latency_ms_p50']:.3f}; DINO_POSE_TPU_LN=pallas step "
        f"{lora_ln['step_ms_kernels']:.3f} / {lora_ln['step_ms_plain']:.3f} ms, serving b1 p50 "
        f"{serving_ln['b1_latency_ms_p50']:.3f}")
    model_large = phase_serving(results, serving_large, "serving_dinov2_large",
                                per_forward_launches=SERVING_LARGE_LAUNCHES, n_lat=8, n_batches=3,
                                fwd_iters=5, config=LARGE_LORA_CONFIG)
    large_run = phase_train(results, train_large, "dinov2_large_lora", LARGE_LORA_CONFIG,
                            LARGE_LORA_LAUNCHES, lora_grad_names(23), LARGE_RECORDED,
                            steps=WIDE_STEPS, timed=WIDE_TIMED, grad_batches=WIDE_GRAD_BATCHES,
                            grad_factor=LARGE_GRAD_NOISE_FACTOR)
    phase_backbone_grads(train_large, "dinov2_large_lora", LARGE_LORA_CONFIG, TRAIN_BATCH, 224)
    stream_train_times = phase_stream_train(results)
    large_unfreeze_run = phase_train(
        results, unfreeze_large, "dinov2_large_unfreeze", LARGE_UNFREEZE_CONFIG,
        LARGE_UNFREEZE_LAUNCHES, unfreeze_grad_names(23), LARGE_UNFREEZE_RECORDED,
        steps=WIDE_STEPS, timed=WIDE_TIMED, grad_batches=WIDE_GRAD_BATCHES)
    phase_backbone_grads(unfreeze_large, "dinov2_large_unfreeze", LARGE_UNFREEZE_CONFIG,
                         TRAIN_BATCH, 224)
    base_unfreeze_run = phase_train(
        results, unfreeze_base, "dinov2_base_unfreeze", BASE_UNFREEZE_CONFIG,
        BASE_UNFREEZE_LAUNCHES, unfreeze_grad_names(11), BASE_UNFREEZE_RECORDED,
        steps=WIDE_STEPS, timed=WIDE_TIMED, grad_batches=WIDE_GRAD_BATCHES)
    phase_backbone_grads(unfreeze_base, "dinov2_base_unfreeze", BASE_UNFREEZE_CONFIG,
                         TRAIN_BATCH, 224)
    mark("dinov2-large 224², stream train, base unfreeze")
    dw_times = phase_dwconv(results)
    with gates({"DINO_POSE_TPU_DWCONV": "on"}):
        phase_serving(results, serving_t8_dw, "serving_fastvit_t8_dwconv",
                      per_forward_launches=SERVING_T8_DW_LAUNCHES, config=T8_CONFIG)
    with gates(ARMS):
        pair_run = phase_train(results, train_t8_pair, "fastvit_t8_lora_pair", T8_CONFIG,
                               T8_PAIR_LAUNCHES, FASTVIT_GRAD_NAMES, T8_PAIR_RECORDED,
                               batch_size=T8_TRAIN_BATCH, image_size=FASTVIT_IMAGE)
        phase_backbone_grads(train_t8_pair, "fastvit_t8_lora_pair", T8_CONFIG, T8_TRAIN_BATCH)
    with gates(BLOCKS_FOLD_ARMS):
        phase_train(results, fold_arms["train_t8_fold_arms"], "fastvit_t8_lora_fold_arms",
                    T8_CONFIG, T8_FOLD_ARMS_LAUNCHES, FASTVIT_GRAD_NAMES,
                    ("fused_dw_conv", *t8_recorded), batch_size=T8_TRAIN_BATCH,
                    image_size=FASTVIT_IMAGE, steps=ARM_STEPS, timed=ARM_TIMED)
        phase_backbone_grads(fold_arms["train_t8_fold_arms"], "fastvit_t8_lora_fold_arms",
                             T8_CONFIG, T8_TRAIN_BATCH)
    log("fastvit_t8_lora step ms by route (this card, kernels / plain): default "
        f"{train_t8['step_ms_kernels']:.3f} / {train_t8['step_ms_plain']:.3f}, both arms on "
        f"{train_t8_pair['step_ms_kernels']:.3f} / {train_t8_pair['step_ms_plain']:.3f}, "
        + ", ".join(f"{arm} {fold_arms[key]['step_ms_kernels']:.3f} / "
                    f"{fold_arms[key]['step_ms_plain']:.3f}"
                    for arm, key in (("FASTVIT_FOLD=0", "train_t8_fold0"),
                                     ("TRAIN_BLOCKS=branch", "train_t8_branch"),
                                     ("TRAIN_BLOCKS=fold with both arms", "train_t8_fold_arms")))
        + "; fastvit_sa12_lora default "
        f"{train_sa12['step_ms_kernels']:.3f} / {train_sa12['step_ms_plain']:.3f}, "
        f"TRAIN_FFN=fold {fold_arms['train_sa12_ffn_fold']['step_ms_kernels']:.3f} / "
        f"{fold_arms['train_sa12_ffn_fold']['step_ms_plain']:.3f}")
    mark("dwconv arms")
    with tempfile.TemporaryDirectory() as fit_root:
        fit = phase_fit(results, fit_root)
        mark("fit")
        dist = phase_dist(results, fit_root, fit["history"])
        mark("dist")
    os.rmdir(empty_cache)
    by_batch = phase_times()
    for times in (*wide_times, stream_train_times):
        for b, t in times.items():
            by_batch.setdefault(b, {}).update(t)
    for b, t in flash_times.items():
        by_batch.setdefault(b, {}).update(t)
    for name, times in (("fused_convffn", convffn_times), ("fused_convffn_bwd", convffn_bwd_times)):
        for b, t in times.items():
            if "t8" in t:
                by_batch.setdefault(b, {})[name] = t["t8"]
    for b, t in dw_times.items():
        by_batch.setdefault(b, {}).update({k: v for k, v in t.items() if k in KERNEL_ROWS})
    for times in (tp_times, {b: t for b, t in ln_times.items() if b != "cases"},
                  {b: t for b, t in core_times.items() if isinstance(b, int)}):
        for b, t in times.items():
            by_batch.setdefault(b, {}).update(t)
    if args.profile:
        profile_forward(model)
        profile_train_step(*lora_run)
        profile_train_step(*unfreeze_run)
        profile_forward(model_504, LONG_IMAGE)
        profile_train_step(*unfreeze_504_run)
        profile_forward(model_t8, model_t8.input_size)
        profile_train_step(*t8_run)
        profile_forward(model_large)
        profile_train_step(*large_run)
        profile_train_step(*large_unfreeze_run)
        profile_train_step(*base_unfreeze_run)
        with gates(ARMS):
            profile_train_step(*pair_run)
        with dispatch.scoped():
            create_mesh(MeshSpec(1, TP))
            profile_forward(model_tp)
            profile_train_step(*tp_run)
        with gates(LN_GATE):
            profile_train_step(*ln_run)

    kernels = []
    for name, (replaces, source, b, path) in KERNEL_ROWS.items():
        t = by_batch[b][name]
        row = results[name]
        runs = results[LAUNCH_KEY.get(name, name)]["launches"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "batch": b,
            # Launches on the path the kernel belongs to, and on each path.
            "launches": runs[path], "launches_by_path": runs,
            "max_abs_err": row["max_abs_err"],
            **({"max_grad_err_rel": row["max_grad_err_rel"]} if "max_grad_err_rel" in row else {}),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            # Rows 24-27: device-only ms and host us a call beside "ms".
            **{k: t[k] for k in ("device_ms", "host_us", "library_device_ms", "library_host_us")
               if k in t},
        })
    log("kernel_times_b8 " + json.dumps(by_batch[8]))
    log("kernel_times_b32 " + json.dumps(by_batch[LONG_BATCH]))
    log("kernel_times_b128 " + json.dumps(by_batch[TRAIN_BATCH]))
    log("convffn_times " + json.dumps(convffn_times))
    log("convffn_bwd_times " + json.dumps(convffn_bwd_times))
    log("dwconv_times " + json.dumps(dw_times))
    log("tp_times " + json.dumps(tp_times))
    log("layernorm_times " + json.dumps(ln_times["cases"]))
    log("gemm_times " + json.dumps(gemm_times))
    log("gemm_bwd_times " + json.dumps(gemm_bwd_times))
    log("attention_core_times " + json.dumps({k: v for k, v in core_times.items()
                                              if isinstance(k, str)}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels, "b1": by_batch[1], "b8": by_batch[8],
                       "b32": by_batch[LONG_BATCH], "b128": by_batch[TRAIN_BATCH],
                       "convffn": convffn_times, "convffn_bwd": convffn_bwd_times,
                       "serving": serving, "training": lora, "training_unfreeze": unfreeze,
                       "serving_504": serving_504, "training_unfreeze_504": unfreeze_504,
                       "serving_fastvit_t8": serving_t8, "serving_fastvit_sa12": serving_sa12,
                       "serving_fastvit_ma36": serving_ma36,
                       "serving_fastvit_sa24": serving_sa24,
                       "serving_fastvit_sa36": serving_sa36,
                       "training_fastvit_ma36_lora": train_ma36, "fastvit_fold_arms": fold_arms,
                       "training_fastvit_t8_lora": train_t8,
                       "training_fastvit_sa12_lora": train_sa12,
                       "serving_dinov2_base": serving_base, "training_dinov2_base_lora": train_base,
                       "serving_dinov2_large": serving_large,
                       "training_dinov2_large_lora": train_large,
                       "training_dinov2_large_unfreeze": unfreeze_large,
                       "training_dinov2_base_unfreeze": unfreeze_base,
                       "dwconv": dw_times, "serving_fastvit_t8_dwconv": serving_t8_dw,
                       "training_fastvit_t8_lora_pair": train_t8_pair, "tp": tp_times,
                       "serving_dinov2_base_tp2": serving_base_tp,
                       "training_dinov2_base_lora_tp2": train_base_tp,
                       "fastvit_tp2": fastvit_tp, "mlp_heads": mlp_heads,
                       "layernorm": ln_times["cases"], "serving_ln": serving_ln,
                       "training_lora_ln": lora_ln, "ln_wide": ln_wide,
                       "pretrained": pretrained, "serving_pretrained": serving_pre,
                       "training_lora_pretrained": lora_pre, "long_wide": long_wide,
                       "gemm": gemm_times,
                       "gemm_bwd": gemm_bwd_times,
                       "attention_core": {k: v for k, v in core_times.items()
                                          if isinstance(k, str)}, "fit": fit, "cli": cli,
                       "dist": dist},
                      f, indent=1)
    log(f"cli ({card}): " + json.dumps(cli))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
