"""Chip smoke test of the PyTorch/H100 port: build the CUDA kernels, hold each
against its plain PyTorch version, serve dinov2-small + LoRA pose requests
through the kernels, take dinov2-small fine-tuning steps at batch 128 through
them (LoRA, and unfreeze-last-4 with whole blocks training), all at 224²;
then the long-sequence paths at 504² (S = 1297), where every layer streams
its attention through the flash kernels: serving, and unfreeze-last-4 steps
at batch 32; then FastViT serving at 256²: fastvit_t8 + LoRA r=8 (10
ConvFFN kernel launches a forward) and fastvit_sa12 (12 ConvFFN launches and
2 flash forwards, its attention stage); then FastViT LoRA fine-tuning at
256²: fastvit_t8 + LoRA r=8 at batch 128 (10 ConvFFN forward and 10
backward launches a step) and fastvit_sa12 + LoRA r=8 at batch 32 (12 and
12, and 2 flash forwards and backwards). Times kernels, serving and every
train step.

    python3 chip_smoke.py [--out results.json] [--profile]

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
import copy
import json
import subprocess
import sys
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
LORA_GRAD_NAMES = (
    "backbone.encoder.layer.11.attention.lora_output.lora_A",
    "backbone.encoder.layer.11.attention.lora_output.lora_B",
    "pose_heads.heatmap_head.feature_refine.0.weight",
    "pose_heads.heatmap_head.prediction.3.weight",
)
UNFREEZE_GRAD_NAMES = (
    "backbone.encoder.layer.11.mlp.fc1.weight",
    "backbone.encoder.layer.11.mlp.fc2.bias",
    "backbone.encoder.layer.11.layer_scale2.lambda1",
    "backbone.encoder.layer.11.norm2.weight",
    "backbone.encoder.layer.8.attention.attention.query.weight",
    "backbone.encoder.layer.8.attention.output.dense.bias",
    "backbone.encoder.layer.8.layer_scale1.lambda1",
    "backbone.encoder.layer.8.norm1.weight",
    "pose_heads.heatmap_head.feature_refine.0.weight",
)
# Launches of each wrapper per forward or step on each path (the others 0:
# no flash launch at 224², where the chains keep K and V resident). At 504²
# every attention streams: one flash forward per layer, and per trainable
# layer a recomputed forward and a backward pair in fused_attn_bwd.
SERVING_LAUNCHES = {"fused_block": 11, "fused_attn_part": 1, "fused_mlp_part": 1}
LORA_LAUNCHES = {"fused_block": 11, "fused_attn_part": 1, "fused_mlp_part": 1, "fused_mlp_dx": 1}
UNFREEZE_LAUNCHES = {"fused_block": 8, "fused_block_train": 4, "fused_mlp_bwd": 4,
                     "fused_attn_bwd": 4}
SERVING_504_LAUNCHES = {**SERVING_LAUNCHES, "flash_fwd": 12}
UNFREEZE_504_LAUNCHES = {**UNFREEZE_LAUNCHES, "flash_fwd": 16, "flash_bwd": 4}
# FastViT serving at 256² (timm's input size): t8 + LoRA r=8, the family's
# default model, and sa12, whose last stage is attention. Launches per forward:
# one ConvFFN kernel per block (depths 2/2/4/2 and 2/2/6/2), one flash
# forward per attention block.
T8_CONFIG = {"model_name": "timm/fastvit_t8.apple_in1k", "use_lora": True}
SA12_CONFIG = {"model_name": "timm/fastvit_sa12.apple_in1k"}
SERVING_T8_LAUNCHES = {"fused_convffn": 10}
SERVING_SA12_LAUNCHES = {"fused_convffn": 12, "flash_fwd": 2}
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
# fastvit_sa12's attention at 256²: (heads, S, dh) over stage 3's 8x8 grid.
SA12_FLASH_SHAPE = (16, 64, 32)
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
}
CONVFFN_RANK = {"t8": 8, "sa12": 0}
BLOCK_SOURCE = "dino_pose_tpu_torch/ops/csrc/block_kernels.cu"
FLASH_SOURCE = "dino_pose_tpu_torch/ops/csrc/flash_kernels.cu"
CONVFFN_SOURCE = "dino_pose_tpu_torch/ops/csrc/convffn_kernels.cu"
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
}
# The LAUNCHES key each row counts.
LAUNCH_KEY = {"flash_attention": "flash_fwd", "flash_attention_bwd": "flash_bwd"}


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


def block_inputs(b: int, gen: torch.Generator, s: int = S):
    """Seeded full-width inputs of ``s`` tokens, weights scaled like trained
    ones."""
    from dino_pose_tpu_torch.ops.block import BlockParams

    def n(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=gen) * std + mean

    def u(*shape, lo, hi):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    p = BlockParams(
        g1=n(D, std=0.1, mean=1.0), b1=n(D, std=0.05),
        wqkv=n(D, 3 * D, std=D**-0.5), bqkv=n(3 * D, std=0.05),
        wo=n(D, D, std=D**-0.5), bo=n(D, std=0.05), ls1=u(D, lo=0.1, hi=1.0),
        g2=n(D, std=0.1, mean=1.0), b2=n(D, std=0.05),
        w1=n(D, HIDDEN, std=D**-0.5), bf1=n(HIDDEN, std=0.05),
        w2=n(HIDDEN, D, std=HIDDEN**-0.5), bf2=n(D, std=0.05), ls2=u(D, lo=0.1, hi=1.0),
    )
    p = BlockParams(*(
        t.to("cuda", torch.bfloat16 if t.dim() == 2 else torch.float32).contiguous() for t in p
    ))
    x = n(b, s, D).to("cuda", torch.bfloat16)
    return x, p


def kernel_cases(x, p):
    from dino_pose_tpu_torch.ops import block as B

    ap, mp = B.attn_params(p), B.mlp_params(p)
    return {
        "fused_block": (lambda: B.fused_block(x, p, H, EPS),
                        lambda: B.block_math(x, p, num_heads=H, eps=EPS)),
        "fused_attn_part": (lambda: B.fused_attn_part(x, ap, H, EPS),
                            lambda: B.attn_part_math(x, ap, num_heads=H, eps=EPS)),
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


def phase_kernels(results: dict) -> None:
    """Each forward kernel vs its plain version at full width, bf16, batch 1
    and 8, at S = 257 and at S = 1297, where the chains stream their
    attention through flash_fwd_kernel on the packed qkv. fused_attn_part's
    output (no residual) at the attention tolerance, the others at the
    kernel tolerance."""
    gen = torch.Generator().manual_seed(SEED)
    for s in (S, S_LONG):
        for b in (1, 8):
            x, p = block_inputs(b, gen, s)
            for name, (kern, plain) in kernel_cases(x, p).items():
                got, want = kern().float(), plain().float()
                torch.cuda.synchronize()
                diff = (got - want).abs()
                big = want.abs() > 0.1
                max_rel = (diff[big] / want.abs()[big]).max().item()
                if name == "fused_attn_part":
                    max_abs, fro, ok = attn_check(got, want, ATTN_FRO)
                    tol = attn_tol_text(ATTN_FRO)
                else:
                    max_abs = diff.max().item()
                    fro = (diff.norm() / want.norm()).item()
                    ok = bool(torch.isfinite(got).all()) and torch.allclose(
                        got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
                    tol = f"atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}*|ref|"
                where = "" if s == S else f" S={s}"
                log(f"kernel {name} B={b}{where}: max_abs={max_abs:.6g} max_rel(|ref|>0.1)="
                    f"{max_rel:.6g} rel_fro={fro:.4g} tol={tol} -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} at B={b}, S={s} disagrees with its plain version")
                row = results.setdefault(name, {"max_abs_err": 0.0})
                row["max_abs_err"] = max(row["max_abs_err"], max_abs)


def dx_inputs(b: int, gen: torch.Generator):
    """x2, a unit-scale seeded cotangent dy, and the MLP half's parameters."""
    from dino_pose_tpu_torch.ops.block import mlp_params

    x, p = block_inputs(b, gen)
    dy = torch.randn((b, S, D), generator=gen).to("cuda", torch.bfloat16)
    return x, dy, mlp_params(p)


def phase_mlp_dx(results: dict) -> None:
    """fused_mlp_dx vs mlp_dx_math at full width, bf16, batch 1, 8 and 128."""
    from dino_pose_tpu_torch.ops import block as B

    gen = torch.Generator().manual_seed(SEED + 3)
    for b in (1, 8, TRAIN_BATCH):
        x2, dy, mp = dx_inputs(b, gen)
        got = B.fused_mlp_dx(x2, dy, mp, EPS).float()
        want = B.mlp_dx_math(x2, dy, mp, eps=EPS).float()
        torch.cuda.synchronize()
        max_abs = (got - want).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        log(f"kernel fused_mlp_dx B={b}: max_abs={max_abs:.6g} "
            f"tol=atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}*|ref| -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused_mlp_dx at B={b} disagrees with mlp_dx_math")
        row = results.setdefault("fused_mlp_dx", {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], max_abs)


def train_cases(x, dy, p):
    """The trainable block's three wrappers and their plain versions, each
    returning a flat tuple: (y, x2), or (dx, *weight gradients)."""
    from dino_pose_tpu_torch.ops import block as B

    mp, atp = B.mlp_params(p), B.attn_train_params(p)
    return {
        "fused_block_train": (lambda: B.fused_block_train(x, p, H, EPS),
                              lambda: B.block_train_math(x, p, num_heads=H, eps=EPS)),
        "fused_mlp_bwd": (lambda: flat(B.fused_mlp_bwd(x, dy, mp, EPS)),
                          lambda: flat(B.mlp_bwd_math(x, dy, mp, eps=EPS))),
        "fused_attn_bwd": (lambda: flat(B.fused_attn_bwd(x, dy, atp, H, EPS)),
                           lambda: flat(B.attn_bwd_math(x, dy, atp, num_heads=H, eps=EPS))),
    }


def flat(out) -> tuple:
    """(dx, grads) -> (dx, *grads); a tuple of tensors stays as it is."""
    first, rest = out
    return (first, *rest) if isinstance(rest, tuple) else (first, rest)


def compare_outputs(got: tuple, want: tuple, act_scale: float = 1.0) -> tuple[float, float, bool]:
    """Activations (3-D) within atol*act_scale + rtol*|ref|, weight gradients
    elementwise within GRAD_TOL of their largest magnitude. Returns (max abs
    error of the activations, largest gradient error over its largest
    magnitude, ok)."""
    act_err, grad_rel, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        ok &= g.shape == w.shape and bool(torch.isfinite(g).all())
        err = (g - w).abs()
        if g.dim() == 3:
            act_err = max(act_err, err.max().item())
            ok &= bool((err <= KERNEL_ATOL * act_scale + KERNEL_RTOL * w.abs()).all())
        else:
            scale = w.abs().max().item()
            grad_rel = max(grad_rel, err.max().item() / scale)
            ok &= scale > 0 and err.max().item() <= GRAD_TOL * scale
    return act_err, grad_rel, ok


def phase_train_kernels(results: dict) -> None:
    """fused_block_train, fused_mlp_bwd and fused_attn_bwd vs their plain
    versions at full width, bf16, batch 1, 8 and 128 at S = 257, and at the
    504² step's batch 32 at S = 1297 (where fused_block_train streams its
    attention and fused_attn_bwd its recomputed forward and backward, on the
    packed qkv), with a unit-scale seeded cotangent, on every output."""
    gen = torch.Generator().manual_seed(SEED + 5)
    for b, s in ((1, S), (8, S), (TRAIN_BATCH, S), (LONG_BATCH, S_LONG)):
        x, p = block_inputs(b, gen, s)
        dy = torch.randn((b, s, D), generator=gen).to("cuda", torch.bfloat16)
        for name, (kern, plain) in train_cases(x, dy, p).items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            act_err, grad_rel, ok = compare_outputs(got, want)
            where = "" if s == S else f" S={s}"
            log(f"kernel {name} B={b}{where}: max_abs(activations)={act_err:.6g} "
                f"max_err/max|ref|(weight grads)={grad_rel:.6g} tol=atol {KERNEL_ATOL} + rtol "
                f"{KERNEL_RTOL}*|ref|, grads {GRAD_TOL}*max|ref| -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} at B={b}, S={s} disagrees with its plain version")
            row = results.setdefault(name, {"max_abs_err": 0.0, "max_grad_err_rel": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], act_err)
            row["max_grad_err_rel"] = max(row.get("max_grad_err_rel", 0.0), grad_rel)


def flash_inputs(b: int, gen: torch.Generator, shape: tuple = (H, S_LONG, D // H)) -> list:
    """Seeded q, k, v and a unit-scale cotangent, (b, *shape) bf16: by
    default the attention of dinov2-small at 504², (b, 6, 1297, 64)."""
    return [torch.randn((b, *shape), generator=gen).to("cuda", torch.bfloat16)
            for _ in range(4)]


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


def flash_cost(b: int) -> dict:
    """(FLOPs, bytes) of the flash forward and backward at batch b: the JAX
    CostEstimate FLOP counts (4 and 10 * B*H*S^2*dh); bytes read and written
    once: q, k, v (and the cotangent) in, o (dq, dk, dv) out, bf16, and the
    f32 row max and sum out of the forward, into the backward."""
    dh = D // H
    act, stats = b * H * S_LONG * dh * 2, b * H * S_LONG * 2 * 4
    return {"flash_attention": (4 * b * H * S_LONG**2 * dh, 4 * act + stats),
            "flash_attention_bwd": (10 * b * H * S_LONG**2 * dh, 7 * act + stats)}


def phase_flash(results: dict) -> dict:
    """flash_attention's kernels (a forward launch, a backward pair) against
    flash_math and flash_bwd_math on o, dq, dk and dv, bf16, B = 1, 8, 32:
    at (B, 6, 1297, 64), dinov2-small's at 504², and at (B, 16, 64, 32),
    fastvit_sa12's attention stage at 256² (32-wide heads; its train batch is
    32); then, at the first shape, their times beside the plain versions',
    the bound and torch's scaled_dot_product_attention (forward; backward
    alone on a kept graph, and forward+backward), the library yardstick,
    which the port never calls. Returns the times by batch."""
    import torch.nn.functional as F

    from dino_pose_tpu_torch.ops import attention as A
    from dino_pose_tpu_torch.ops import block as B

    gen, gen_sa12 = (torch.Generator().manual_seed(SEED + i) for i in (6, 10))
    scale = (D // H) ** -0.5
    times = {}
    for b in FLASH_BATCHES:
        q, k, v, g = flash_inputs(b, gen)
        check_flash(results, q, k, v, g, f"B={b}")
        heads, s, dh = SA12_FLASH_SHAPE
        check_flash(results, *flash_inputs(b, gen_sa12, SA12_FLASH_SHAPE),
                    f"B={b} (fastvit_sa12: {heads} heads, S={s}, dh={dh})")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        saved = dict(B.LAUNCHES)
        _, stats = A.flash_fwd(q, k, v, scale)
        sdpa_out = F.scaled_dot_product_attention(*leaves, scale=scale)
        t = {
            "flash_attention": (
                cuda_ms(lambda: A.flash_fwd(q, k, v, scale), iters=20),
                cuda_ms(lambda: A.flash_math(q, k, v, scale), iters=5, warmup=1),
                cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), iters=20)),
            "flash_attention_bwd": (
                cuda_ms(lambda: A.flash_bwd(q, k, v, g, stats, scale), iters=20),
                cuda_ms(lambda: A.flash_bwd_math(q, k, v, g, scale), iters=5, warmup=1),
                cuda_ms(lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True),
                        iters=20)),
        }
        sdpa_fwd_bwd = cuda_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves, scale=scale), leaves, g), iters=20)
        B.LAUNCHES.update(saved)  # timing launches are not main-path launches
        del sdpa_out, leaves, stats
        for name, (ms, plain_ms, lib_ms) in t.items():
            bound, by = B.bound_ms(*flash_cost(b)[name])
            times.setdefault(b, {})[name] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": lib_ms}
            log(f"time {name} B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound:.5f} ms ({by}), scaled_dot_product_attention {lib_ms:.4f} ms")
        times[b]["flash_attention_bwd"]["library_fwd_bwd_ms"] = sdpa_fwd_bwd
        log(f"time scaled_dot_product_attention forward+backward B={b}: {sdpa_fwd_bwd:.4f} ms")
    return times


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


def seeded_images(rng: np.random.Generator, n: int):
    from PIL import Image

    sizes = [(320, 240), (480, 640), (224, 224), (500, 333), (256, 300)]
    return [
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        for h, w in (sizes[i % len(sizes)] for i in range(n))
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
                  pil: bool = True):
    """A model (by default the repo's: dinov2-small + LoRA r=8 on layer 11)
    behind ``serve.make_predictor``: 4 batch-1 requests and 1 batch-8
    request, each checked (launches per forward, shapes, agreement with the
    plain path), then timed. With ``pil`` the requests are PIL images of
    several sizes (the model's preprocessor crops them to its input size);
    otherwise (B, 3, image_size, image_size) pixel arrays, seeded."""
    from dino_pose_tpu_torch.data.preprocess import create_preprocessor
    from dino_pose_tpu_torch.models.registry import create_model_from_config
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.serve import make_predictor

    model = create_model_from_config(dict(config), seed=SEED, device="cuda")
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


def synthetic_batch(batch_size: int, image_size: int = 224) -> dict:
    """bench.py's synthetic fine-tune batch (loader contract: f32 pixels,
    keypoints all visible, z), made on the host from seed 0 and moved to the
    card once; the heatmap targets are rendered inside the step."""
    rng = np.random.default_rng(0)
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

    if name == "fused_mlp_dx":
        x2, dy, mp, eps = args
        return (out,), (B.mlp_dx_math(x2, dy, mp, eps=eps),), dy
    if name == "fused_mlp_bwd":
        x2, dy, mp, eps = args
        return flat(out), flat(B.mlp_bwd_math(x2, dy, mp, eps=eps)), dy
    if name == "fused_attn_bwd":
        x, dy, atp, num_heads, eps = args
        return flat(out), flat(B.attn_bwd_math(x, dy, atp, num_heads=num_heads, eps=eps)), dy
    if name == "fused_convffn":
        y, p, s_lora = args
        return (out,), (CF.convffn_math(y, p, s_lora),), None
    if name == "fused_convffn_bwd":
        y, df, p, s_lora = args
        return flat(out), flat(CF.convffn_bwd_math(y, df, p, s_lora)), df
    if name == "flash_fwd":
        q, k, v, scale = args
        return out[:1], (A.flash_math(q, k, v, scale),), None
    q, k, v, do, _, scale = args  # flash_bwd
    return out, A.flash_bwd_math(q, k, v, do, scale), do


def check_step_tensors(tag: str, name: str, which: str, args: tuple, out,
                       training: dict) -> bool:
    """A wrapper's output in the first train step against its plain version
    on the same inputs (the step's own activations, cotangent and weights).
    A backward's outputs are linear in the incoming cotangent, so the
    absolute part of the tolerance is scaled by its max|.|. Activations at
    the kernel tolerance and each weight gradient within GRAD_TOL of its
    largest magnitude; the flash outputs at the attention tolerance."""
    got, want, ct = plain_pair(name, args, out)
    ct_max = 1.0 if ct is None else ct.float().abs().max().item()
    if name.startswith("flash"):
        errs, fros, oks = zip(*(attn_check(g, w, FLASH_FRO, ct_max) for g, w in zip(got, want)))
        act_err, ok = max(errs), all(oks)
        extra = {"rel_fro": max(fros)}
        tol = attn_tol_text(FLASH_FRO)
    else:
        act_err, grad_rel, ok = compare_outputs(got, want, act_scale=ct_max)
        extra = {"max_grad_err_rel": grad_rel} if len(got) > 1 else {}
        tol = f"atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}*|ref|, grads {GRAD_TOL}*max|ref|"
    ok &= ct_max > 0
    training.setdefault("step1_tensors", {})[f"{name} {which}"] = {
        "max_abs": act_err, "max_ct": ct_max, "max_abs_over_max_ct": act_err / ct_max, **extra}
    log(f"{tag} train step 0 {name} ({which} call) on the step's tensors: max_abs={act_err:.6g} "
        f"max|ct|={ct_max:.6g} (ratio {act_err / ct_max:.4g})"
        + "".join(f" {k}={v:.4g}" for k, v in extra.items())
        + f"; tol={tol}, atol scaled by max|ct| -> {'ok' if ok else 'FAIL'}")
    return ok


def wrapper_module(name: str):
    """The module whose global ``name`` a recorded wrapper is called by."""
    from dino_pose_tpu_torch.ops import attention as A
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.ops import convffn as CF

    return CF if name.startswith("fused_convffn") else A if name.startswith("flash") else B


def phase_train(results: dict, training: dict, tag: str, config: dict, per_step: dict,
                grad_names: tuple, recorded: tuple, batch_size: int = TRAIN_BATCH,
                image_size: int = 224, steps: int = TRAIN_STEPS, timed: int = 5):
    """``steps`` fine-tune steps of the model ``config`` names (dinov2-small,
    or a FastViT) at ``batch_size`` through the kernels, as many from an
    identical copy through the plain versions (the same dropout masks),
    compared step by step; the first step's first and last call of each
    ``recorded`` wrapper (a backward's first call is the top layer's, its
    last the bottom one's) held against its plain version on its own
    inputs; then step times over ``timed`` steps."""
    from dino_pose_tpu_torch.models.registry import create_model_from_config
    from dino_pose_tpu_torch.ops import block as B

    model = create_model_from_config(dict(config), seed=SEED, device="cuda")
    randomise_for_serving(model, torch.Generator().manual_seed(SEED + 4))
    plain_model = copy.deepcopy(model)
    ref_model = copy.deepcopy(model)
    batch = synthetic_batch(batch_size, image_size)
    state, step = make_step(model, config, kernels=True, image_size=image_size)
    pstate, pstep = make_step(plain_model, config, kernels=False, image_size=image_size)

    want_step = expected(per_step)
    first, last = {}, {}
    originals = {name: getattr(wrapper_module(name), name) for name in recorded}

    def recorder(name):
        fn = originals[name]

        def recording(*args):
            out = fn(*args)
            entry = (clone(args), clone(out))
            first.setdefault(name, entry)
            last[name] = entry  # the first entry itself when there is one call
            return out
        return recording

    B.reset_launches()
    kstats, grads = [], {}
    params = dict(model.named_parameters())
    for i in range(steps):
        before = dict(B.LAUNCHES)
        if i == 0:
            for name in recorded:
                setattr(wrapper_module(name), name, recorder(name))
        try:
            state, stats = step(state, batch, LR, SEED)
        finally:
            for name, fn in originals.items():
                setattr(wrapper_module(name), name, fn)
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

    calls = [(name, which, entry) for name in recorded
             for which, entry in (("first", first[name]), ("last", last[name]))
             if which == "first" or entry is not first[name]]
    bad = [f"{name} ({which} call)" for name, which, entry in calls
           if not check_step_tensors(tag, name, which, *entry, training)]
    if bad:
        raise AssertionError(f"{tag}: {bad} disagree with their plain versions on the step's tensors")
    first.clear()
    last.clear()
    del calls

    # The step-1 gradients in f32 (plain versions, TF32 off) from the same
    # weights and dropout masks: the yardstick for both bf16 paths.
    rstate, rstep = make_step(ref_model, config, kernels=False, dtype=torch.float32,
                              image_size=image_size)
    rstep(rstate, batch, LR, SEED)
    ref_grads = {n: p.grad for n, p in ref_model.named_parameters() if n in grad_names}
    del ref_model, rstate, rstep

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
            for n in grad_names:
                rel = rel_err(grads[n], pparams[n].grad)
                k_ref = rel_err(grads[n], ref_grads[n])
                p_ref = rel_err(pparams[n].grad, ref_grads[n])
                tol = GRAD_NOISE_FACTOR * p_ref + GRAD_NOISE_SLACK
                ok = bool(torch.isfinite(grads[n]).all()) and max(rel, k_ref) <= tol
                log(f"{tag} step-1 grad {n}: rel Frobenius kernels vs plain {rel:.4g}, kernels vs "
                    f"f32 {k_ref:.4g}, plain vs f32 {p_ref:.4g} (tol {GRAD_NOISE_FACTOR}*plain"
                    f"+{GRAD_NOISE_SLACK} = {tol:.4g}); |g| {ref_grads[n].norm().item():.4g} "
                    f"-> {'ok' if ok else 'FAIL'}")
                training.setdefault("grad_rel", {})[n] = {
                    "kernels_vs_plain": rel, "kernels_vs_f32": k_ref, "plain_vs_f32": p_ref}
                if not ok:
                    failures.append(f"step-1 gradient of {n}")
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


def phase_backbone_grads(training: dict, tag: str, config: dict, batch_size: int) -> None:
    """The FastViT backbone's LoRA gradients alone, in train mode, under a
    seeded unit cotangent on its feature map, from one seeded model and one
    dropout generator: kernels (bf16), plain (bf16) and plain f32 (TF32 off).
    The whole step's gradients pass the heads' train-mode BatchNorms and
    ReLUs, which amplify any rounding (JAX's own bf16 step moves them ~40%
    from its f32, tests/test_torch_fastvit_train.py), so the step compares
    them only loosely; with no head in the way bf16 moves these a few
    percent, and every adapter's gradient through the kernels must stay
    within GRAD_NOISE_FACTOR times the plain path's error against f32, plus
    GRAD_NOISE_SLACK. Every ConvFFN's forward and backward kernel (and sa12's
    flash pair) run here; their launches are not main-path launches."""
    from dino_pose_tpu_torch.models.registry import create_model_from_config
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.train.step import step_generator

    model = create_model_from_config(dict(config), seed=SEED, device="cuda")
    randomise_for_serving(model, torch.Generator().manual_seed(SEED + 4))
    gen = torch.Generator().manual_seed(SEED + 9)
    x = torch.randn((batch_size, 3, FASTVIT_IMAGE, FASTVIT_IMAGE), generator=gen).cuda()
    saved = dict(B.LAUNCHES)
    grads, ct = {}, None
    for which, kernels, dtype in (("kernels", True, torch.bfloat16),
                                  ("plain", False, torch.bfloat16),
                                  ("f32", False, torch.float32)):
        m = copy.deepcopy(model).train()
        fmap = m.backbone(x.to(dtype), kernels=kernels,
                          generator=step_generator(SEED, 0, x.device))
        if ct is None:
            ct = torch.randn(fmap.shape, generator=gen).cuda()
        fmap.float().backward(ct)
        grads[which] = {n: p.grad for n, p in m.named_parameters() if "lora_" in n}
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
            log(f"{tag} backbone LoRA grad {n}: kernels vs f32 {k_ref:.4g}, plain vs f32 "
                f"{p_ref:.4g} (tol {tol:.4g}) -> FAIL")
    worst = max(rows, key=lambda n: rows[n]["kernels_vs_f32"] / rows[n]["plain_vs_f32"])
    stat = {k: max(r[k] for r in rows.values()) for k in rows[worst]}
    training["backbone_grad_rel"] = {"max": stat, "worst": {worst: rows[worst]}, "leaves": rows}
    log(f"{tag} backbone LoRA grads ({len(rows)} leaves, batch {batch_size}, seeded cotangent on "
        f"the feature map): largest rel Frobenius kernels vs f32 {stat['kernels_vs_f32']:.4g}, "
        f"plain vs f32 {stat['plain_vs_f32']:.4g}, kernels vs plain "
        f"{stat['kernels_vs_plain']:.4g}; worst kernels/plain ratio {worst} "
        f"{rows[worst]['kernels_vs_f32']:.4g}/{rows[worst]['plain_vs_f32']:.4g} (tol "
        f"{GRAD_NOISE_FACTOR}*plain+{GRAD_NOISE_SLACK}) -> {'FAIL' if bad else 'ok'}")
    if bad:
        raise AssertionError(f"{tag}: backbone LoRA gradients out of tolerance: {bad}")


def phase_times(results: dict) -> dict:
    """Kernel, plain and bound times at the main-path shapes."""
    from dino_pose_tpu_torch.ops import block as B

    gen = torch.Generator().manual_seed(SEED + 2)
    by_batch = {}
    for b in (1, 8):
        x, p = block_inputs(b, gen)
        flops = B.block_flops(S, D, HIDDEN)
        nbytes = B.block_bytes(b, S, D, HIDDEN)
        saved = dict(B.LAUNCHES)
        for name, (kern, plain) in kernel_cases(x, p).items():
            with torch.inference_mode():
                ms = cuda_ms(kern)
                plain_ms = cuda_ms(plain)
            bound, by = B.bound_ms(b * flops[name], nbytes[name])
            by_batch.setdefault(b, {})[name] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            }
            log(f"time {name} B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound:.5f} ms ({by})")
        B.LAUNCHES.update(saved)  # timing launches are not main-path launches
    for b in (1, 8, TRAIN_BATCH):
        x2, dy, mp = dx_inputs(b, gen)
        saved = dict(B.LAUNCHES)
        with torch.inference_mode():
            ms = cuda_ms(lambda: B.fused_mlp_dx(x2, dy, mp, EPS), iters=20)
            plain_ms = cuda_ms(lambda: B.mlp_dx_math(x2, dy, mp, eps=EPS), iters=20)
        B.LAUNCHES.update(saved)
        bound, by = B.bound_ms(b * B.block_flops(S, D, HIDDEN)["fused_mlp_dx"],
                               B.block_bytes(b, S, D, HIDDEN)["fused_mlp_dx"])
        by_batch.setdefault(b, {})["fused_mlp_dx"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        }
        log(f"time fused_mlp_dx B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound:.5f} ms ({by})")
    for b in (1, 8, TRAIN_BATCH):
        x, p = block_inputs(b, gen)
        dy = torch.randn((b, S, D), generator=gen).to("cuda", torch.bfloat16)
        saved = dict(B.LAUNCHES)
        for name, (kern, plain) in train_cases(x, dy, p).items():
            with torch.inference_mode():
                ms = cuda_ms(kern, iters=20)
                plain_ms = cuda_ms(plain, iters=10, warmup=2)
            bound, by = B.bound_ms(b * B.block_flops(S, D, HIDDEN)[name],
                                   B.block_bytes(b, S, D, HIDDEN)[name])
            by_batch.setdefault(b, {})[name] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            }
            log(f"time {name} B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound:.5f} ms ({by})")
        B.LAUNCHES.update(saved)
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
    return n(b, s, c).to("cuda", torch.bfloat16), p


def phase_convffn(results: dict, backward: bool) -> dict:
    """fused_convffn (with ``backward``, fused_convffn_bwd) against
    convffn_math (convffn_bwd_math, with a unit-scale seeded cotangent) at
    every fastvit_t8 and fastvit_sa12 stage shape (256² input), bf16, at
    batch 1, 8 and the model's train batch (128, 32): the forward at batch 1
    and 8 at the serving rank (t8: 8, sa12: 0, rank-1 zero adapters with
    ones masks), everything else at rank 8 with Dropout2d-style masks.
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
        train_batch = T8_TRAIN_BATCH if model == "t8" else SA12_TRAIN_BATCH
        rank = 8 if backward else CONVFFN_RANK[model]
        for b, r, g in ((1, rank, gen), (8, rank, gen), (train_batch, 8, gen_train)):
            s_lora = 16.0 / r if r else 1.0
            total = {"ms": 0.0, "plain_ms": 0.0, "flops": 0, "bytes": 0}
            for i, (c, h, s, blocks) in enumerate(stages):
                y, p = convffn_inputs(b, s, c, h, r, g)
                if backward:
                    df = torch.randn((b, s, c), generator=g).to("cuda", torch.bfloat16)

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
                    ms = cuda_ms(kern, iters=10 if backward else 20, warmup=2 if backward else 5)
                    plain_ms = cuda_ms(plain, iters=3 if backward else 10,
                                       warmup=1 if backward else 2)
                B.LAUNCHES.update(saved)  # timing launches are not main-path launches
                bound, by = B.bound_ms(flops, nbytes)
                log(f"time {name} {where}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {bound:.5f} ms ({by}); x{blocks} blocks a "
                    f"{'step' if backward else 'forward'}")
                out.setdefault(b, {}).setdefault(f"{model}_stages", []).append({
                    "C": c, "H": h, "S": s, "R": r, "blocks": blocks, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "max_abs_err": act_err, **({"max_grad_err_rel": grad_rel} if backward else {})})
                total["ms"] += blocks * ms
                total["plain_ms"] += blocks * plain_ms
                total["flops"] += blocks * flops
                total["bytes"] += blocks * nbytes
            bound, by = B.bound_ms(total["flops"], total["bytes"])
            out[b][model] = {"ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": bound,
                             "bound_by": by, "library_ms": None}
            log(f"time {name} {model} {'step' if backward else 'forward'} "
                f"({sum(t[3] for t in stages)} launches) B={b}: kernel {total['ms']:.4f} ms, "
                f"plain {total['plain_ms']:.4f} ms, bound {bound:.5f} ms ({by})")
    return out


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
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


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
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write all measurements to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="print torch.profiler kernel tables of the batch-1 forward and "
                         "the train steps: at 224² LoRA and unfreeze (batch 128), at 504² "
                         "unfreeze (batch 32); and of the fastvit_t8 + LoRA batch-1 forward "
                         "and its LoRA train step (batch 128)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dino_pose_tpu_torch.ops import _ext

    card = nvidia_smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _ext.build(verbose=True)
    _ext.lib()
    log(f"build_seconds {time.perf_counter() - t0:.1f}")

    results: dict = {}
    serving: dict = {}
    lora: dict = {}
    unfreeze: dict = {}
    serving_504: dict = {}
    unfreeze_504: dict = {}
    serving_t8: dict = {}
    serving_sa12: dict = {}
    train_t8: dict = {}
    train_sa12: dict = {}
    phase_kernels(results)
    phase_mlp_dx(results)
    phase_train_kernels(results)
    flash_times = phase_flash(results)
    model = phase_serving(results, serving)
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
    convffn_times = phase_convffn(results, backward=False)
    model_t8 = phase_serving(results, serving_t8, "serving_fastvit_t8",
                             per_forward_launches=SERVING_T8_LAUNCHES, config=T8_CONFIG)
    phase_serving(results, serving_sa12, "serving_fastvit_sa12",
                  per_forward_launches=SERVING_SA12_LAUNCHES, n_lat=10, n_batches=4,
                  fwd_iters=10, config=SA12_CONFIG)
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
    by_batch = phase_times(results)
    for b, t in flash_times.items():
        by_batch.setdefault(b, {}).update(t)
    for name, times in (("fused_convffn", convffn_times), ("fused_convffn_bwd", convffn_bwd_times)):
        for b, t in times.items():
            if "t8" in t:
                by_batch.setdefault(b, {})[name] = t["t8"]
    if args.profile:
        profile_forward(model)
        profile_train_step(*lora_run)
        profile_train_step(*unfreeze_run)
        profile_forward(model_504, LONG_IMAGE)
        profile_train_step(*unfreeze_504_run)
        profile_forward(model_t8, model_t8.input_size)
        profile_train_step(*t8_run)

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
        })
    log("kernel_times_b8 " + json.dumps(by_batch[8]))
    log("kernel_times_b32 " + json.dumps(by_batch[LONG_BATCH]))
    log("kernel_times_b128 " + json.dumps(by_batch[TRAIN_BATCH]))
    log("convffn_times " + json.dumps(convffn_times))
    log("convffn_bwd_times " + json.dumps(convffn_bwd_times))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels, "b1": by_batch[1], "b8": by_batch[8],
                       "b32": by_batch[LONG_BATCH], "b128": by_batch[TRAIN_BATCH],
                       "convffn": convffn_times, "convffn_bwd": convffn_bwd_times,
                       "serving": serving, "training": lora, "training_unfreeze": unfreeze,
                       "serving_504": serving_504, "training_unfreeze_504": unfreeze_504,
                       "serving_fastvit_t8": serving_t8, "serving_fastvit_sa12": serving_sa12,
                       "training_fastvit_t8_lora": train_t8,
                       "training_fastvit_sa12_lora": train_sa12},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
