"""Chip smoke test of the PyTorch/H100 port: build the CUDA kernels, hold each
against its plain PyTorch version, serve dinov2-small + LoRA pose requests
through the kernels, take dinov2-small fine-tuning steps at batch 128 through
them (LoRA, and unfreeze-last-4 with whole blocks training), and time
kernels, serving and both train steps.

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
# Whole model, kernels vs plain, bf16: twelve blocks and the heads compound
# those one-ulp flips, so outputs are held to 5% of their largest magnitude.
MODEL_REL_TOL = 5e-2
# Keypoints: an argmax over near-tied peaks of a random-weight model can move
# under one flip, so at least 75% of keypoints must agree within one heatmap
# cell (224/48 px).
KP_CELL_PX, KP_AGREE = 224 / 48, 0.75
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
# Launches of each wrapper per forward or step on each path (the others 0).
SERVING_LAUNCHES = {"fused_block": 11, "fused_attn_part": 1, "fused_mlp_part": 1}
LORA_LAUNCHES = {"fused_block": 11, "fused_attn_part": 1, "fused_mlp_part": 1, "fused_mlp_dx": 1}
UNFREEZE_LAUNCHES = {"fused_block": 8, "fused_block_train": 4, "fused_mlp_bwd": 4,
                     "fused_attn_bwd": 4}
KERNEL_ROWS = {
    "fused_block": "dino_pose_tpu/ops/block.py:159",
    "fused_attn_part": "dino_pose_tpu/ops/block.py:999",
    "fused_mlp_part": "dino_pose_tpu/ops/block.py:1021",
    "fused_mlp_dx": "dino_pose_tpu/ops/block.py:1044",
    "fused_block_train": "dino_pose_tpu/ops/block.py:592",
    "fused_mlp_bwd": "dino_pose_tpu/ops/block.py:284",
    "fused_attn_bwd": "dino_pose_tpu/ops/block.py:334",
}
# The batch each kernel's numbers in the JSON line were taken at, and the
# path whose launches its "launches" reports: the forward kernels at the
# serving batch on the serving path, the backward ones at the training batch
# on their training path.
ROW_BATCH = {"fused_block": 1, "fused_attn_part": 1, "fused_mlp_part": 1,
             "fused_mlp_dx": TRAIN_BATCH, "fused_block_train": TRAIN_BATCH,
             "fused_mlp_bwd": TRAIN_BATCH, "fused_attn_bwd": TRAIN_BATCH}
ROW_PATH = {"fused_block": "serving", "fused_attn_part": "serving", "fused_mlp_part": "serving",
            "fused_mlp_dx": "lora_train", "fused_block_train": "unfreeze_train",
            "fused_mlp_bwd": "unfreeze_train", "fused_attn_bwd": "unfreeze_train"}
SOURCE = "dino_pose_tpu_torch/ops/csrc/block_kernels.cu"


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


def block_inputs(b: int, gen: torch.Generator):
    """Seeded full-width inputs, weights scaled like trained ones."""
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
    x = n(b, S, D).to("cuda", torch.bfloat16)
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


def phase_kernels(results: dict) -> None:
    """Each kernel vs its plain version at full width, bf16, batch 1 and 8."""
    gen = torch.Generator().manual_seed(SEED)
    for b in (1, 8):
        x, p = block_inputs(b, gen)
        for name, (kern, plain) in kernel_cases(x, p).items():
            got, want = kern().float(), plain().float()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            max_abs = diff.max().item()
            big = want.abs() > 0.1
            max_rel = (diff[big] / want.abs()[big]).max().item()
            ok = bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
            log(f"kernel {name} B={b}: max_abs={max_abs:.6g} max_rel(|ref|>0.1)={max_rel:.6g} "
                f"tol=atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}*|ref| -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} at B={b} disagrees with its plain version")
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
    versions at full width, bf16, batch 1, 8 and 128, with a unit-scale
    seeded cotangent, on every output."""
    gen = torch.Generator().manual_seed(SEED + 5)
    for b in (1, 8, TRAIN_BATCH):
        x, p = block_inputs(b, gen)
        dy = torch.randn((b, S, D), generator=gen).to("cuda", torch.bfloat16)
        for name, (kern, plain) in train_cases(x, dy, p).items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            act_err, grad_rel, ok = compare_outputs(got, want)
            log(f"kernel {name} B={b}: max_abs(activations)={act_err:.6g} "
                f"max_err/max|ref|(weight grads)={grad_rel:.6g} tol=atol {KERNEL_ATOL} + rtol "
                f"{KERNEL_RTOL}*|ref|, grads {GRAD_TOL}*max|ref| -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} at B={b} disagrees with its plain version")
            row = results.setdefault(name, {"max_abs_err": 0.0, "max_grad_err_rel": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], act_err)
            row["max_grad_err_rel"] = max(row.get("max_grad_err_rel", 0.0), grad_rel)


def randomise_for_serving(model, gen: torch.Generator) -> None:
    """Make no path an identity: LoRA B, BN running stats and LayerScale."""
    from torch import nn

    from dino_pose_tpu_torch.models.vit import LoRAAdapter, _LayerScale

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LoRAAdapter):
                m.lora_B.copy_(torch.randn(m.lora_B.shape, generator=gen) * 0.02)
            elif isinstance(m, nn.BatchNorm2d):
                c = m.running_mean.shape[0]
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
            elif isinstance(m, _LayerScale):
                m.lambda1.copy_(torch.rand(m.lambda1.shape, generator=gen) * 0.9 + 0.1)


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
    with torch.inference_mode():
        hm_p, z_p = model(x, kernels=False)
        kp_p = decode_heatmaps(hm_p, (224, 224)).float().cpu().numpy()
    for name, got, want in (("heatmaps", hm, hm_p.float().cpu().numpy()),
                            ("z", z, z_p.float().cpu().numpy())):
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        ok = err <= MODEL_REL_TOL * scale
        log(f"{tag} {name}: max_abs={err:.6g} vs {MODEL_REL_TOL}*max|plain|={MODEL_REL_TOL * scale:.6g}"
            f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: {name} kernels vs plain out of tolerance")
    dist = np.linalg.norm(kp - kp_p, axis=-1)
    agree = float((dist <= KP_CELL_PX).mean())
    log(f"{tag} keypoints: {agree:.3f} within {KP_CELL_PX:.3f} px (need {KP_AGREE})")
    if agree < KP_AGREE:
        raise AssertionError(f"{tag}: keypoints kernels vs plain disagree")


def phase_serving(results: dict, serving: dict):
    from dino_pose_tpu_torch.data.preprocess import create_preprocessor
    from dino_pose_tpu_torch.models.registry import create_model_from_config
    from dino_pose_tpu_torch.ops import block as B
    from dino_pose_tpu_torch.serve import make_predictor

    model = create_model_from_config(
        {"model_name": "facebook/dinov2-small", "use_lora": True}, seed=SEED, device="cuda"
    )
    randomise_for_serving(model, torch.Generator().manual_seed(SEED + 1))
    predict = make_predictor(model)
    preprocessor = create_preprocessor("facebook/dinov2-small")
    rng = np.random.default_rng(SEED)
    requests = [[im] for im in seeded_images(rng, 4)] + [seeded_images(rng, 8)]

    # Serving runs no backward: the backward wrappers stay at 0.
    per_forward = expected(SERVING_LAUNCHES)
    B.reset_launches()
    for i, images in enumerate(requests):
        before = dict(B.LAUNCHES)
        out = predict(images)
        torch.cuda.synchronize()
        delta = {k: B.LAUNCHES[k] - before[k] for k in B.LAUNCHES}
        log(f"request {i} (batch {len(images)}): launches {delta}")
        if delta != per_forward:
            raise AssertionError(f"request {i}: launches {delta}, want {per_forward}")
        kp, z, hm = out
        if kp.shape != (len(images), 24, 2) or z.shape != (len(images), 24) \
                or hm.shape != (len(images), 24, 48, 48):
            raise AssertionError(f"request {i}: shapes {kp.shape} {z.shape} {hm.shape}")
        pixels = preprocessor(images)["pixel_values"]
        compare_paths(model, pixels, out, f"request {i}")
    launches = dict(B.LAUNCHES)
    record_launches(results, "serving", launches)
    log(f"serving-path launches over {len(requests)} requests: {launches}")

    # Serving times: host clock around predict (preprocess, upload, forward,
    # decode, download), batch-1 p50 and batch-8 images/s.
    one = requests[0]
    eight = requests[-1]
    for _ in range(3):
        predict(one)
        predict(eight)
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        predict(one)
        lat.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    n_batches = 10
    for _ in range(n_batches):
        predict(eight)
    dt = time.perf_counter() - t0
    serving["b1_latency_ms_p50"] = float(np.median(lat))
    serving["b1_latency_ms_p90"] = float(np.percentile(lat, 90))
    serving["b8_images_per_s"] = 8 * n_batches / dt

    # Device forward alone (CUDA events), kernels vs plain, batch 1 and 8.
    for b, pix in ((1, preprocessor(one)["pixel_values"]),
                   (8, preprocessor(eight)["pixel_values"])):
        x = torch.from_numpy(pix).cuda().to(torch.bfloat16)
        with torch.inference_mode():
            serving[f"forward_ms_b{b}"] = cuda_ms(lambda: model(x), iters=20)
            serving[f"forward_plain_ms_b{b}"] = cuda_ms(lambda: model(x, kernels=False), iters=20)
    log("serving " + json.dumps(serving))
    return model


def synthetic_batch(batch_size: int) -> dict:
    """bench.py's synthetic fine-tune batch (loader contract: f32 pixels,
    keypoints all visible, z), made on the host from seed 0 and moved to the
    card once; the heatmap targets are rendered inside the step."""
    rng = np.random.default_rng(0)
    kps = rng.uniform(20, 200, (batch_size, 24, 3)).astype(np.float32)
    kps[..., 2] = 2.0
    batch = {
        "image": rng.standard_normal((batch_size, 3, 224, 224)).astype(np.float32),
        "2d_keypoints": kps,
        "z_coords": rng.standard_normal((batch_size, 24)).astype(np.float32),
    }
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def make_step(model, config: dict, kernels: bool, dtype=torch.bfloat16):
    from dino_pose_tpu_torch.train.state import create_train_state
    from dino_pose_tpu_torch.train.step import make_train_step, prepare_batch

    state, optimizer, partition = create_train_state(model, config)
    step = prepare_batch(make_train_step(model, optimizer, partition, kernels=kernels),
                         device_targets=(224, 48), compute_dtype=dtype)
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


def check_step_tensors(tag: str, name: str, args: tuple, out, training: dict) -> bool:
    """A backward wrapper's output in the first train step against its plain
    version on the same inputs (the step's own activations, cotangent and
    weights). The activation cotangent is linear in the incoming one, so the
    kernel tolerance's absolute part is scaled by its max|.|; each weight
    gradient is held to GRAD_TOL of its largest magnitude."""
    from dino_pose_tpu_torch.ops import block as B

    if name == "fused_mlp_dx":
        x2, dy, mp, eps = args
        got, want = (out,), (B.mlp_dx_math(x2, dy, mp, eps=eps),)
    elif name == "fused_mlp_bwd":
        x2, dy, mp, eps = args
        got, want = flat(out), flat(B.mlp_bwd_math(x2, dy, mp, eps=eps))
    else:
        x, dy, atp, num_heads, eps = args
        got, want = flat(out), flat(B.attn_bwd_math(x, dy, atp, num_heads=num_heads, eps=eps))
    dy_max = dy.float().abs().max().item()
    act_err, grad_rel, ok = compare_outputs(got, want, act_scale=dy_max)
    ok &= dy_max > 0
    training.setdefault("step1_tensors", {})[name] = {
        "max_abs": act_err, "max_dy": dy_max, "max_abs_over_max_dy": act_err / dy_max,
        "max_grad_err_rel": grad_rel}
    log(f"{tag} train step 0 {name} on the step's tensors: max_abs={act_err:.6g} "
        f"max|dy|={dy_max:.6g} (ratio {act_err / dy_max:.4g}); weight grads max_err/max|ref| "
        f"{grad_rel:.4g}; tol=(atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}*|ref|) scaled by "
        f"max|dy|, grads {GRAD_TOL}*max|ref| -> {'ok' if ok else 'FAIL'}")
    return ok


def phase_train(results: dict, training: dict, tag: str, config: dict, per_step: dict,
                grad_names: tuple, recorded: tuple):
    """Three dinov2-small fine-tune steps with ``config`` at batch 128 through
    the kernels, three from an identical copy through the plain versions (the
    same dropout masks), compared step by step; the first step's call of each
    ``recorded`` backward wrapper (the top layer's) held against its plain
    version on its own inputs; then step times."""
    from dino_pose_tpu_torch.models.registry import create_model_from_config
    from dino_pose_tpu_torch.ops import block as B

    model = create_model_from_config(dict(config), seed=SEED, device="cuda")
    randomise_for_serving(model, torch.Generator().manual_seed(SEED + 4))
    plain_model = copy.deepcopy(model)
    ref_model = copy.deepcopy(model)
    batch = synthetic_batch(TRAIN_BATCH)
    state, step = make_step(model, config, kernels=True)
    pstate, pstep = make_step(plain_model, config, kernels=False)

    want_step = expected(per_step)
    seen = {}
    originals = {name: getattr(B, name) for name in recorded}

    def recorder(name):
        fn = originals[name]

        def recording(*args):
            out = fn(*args)
            if name not in seen:
                seen[name] = (clone(args), clone(out))
            return out
        return recording

    B.reset_launches()
    kstats, grads = [], {}
    params = dict(model.named_parameters())
    for i in range(TRAIN_STEPS):
        before = dict(B.LAUNCHES)
        if i == 0:
            for name in recorded:
                setattr(B, name, recorder(name))
        try:
            state, stats = step(state, batch, LR, SEED)
        finally:
            for name, fn in originals.items():
                setattr(B, name, fn)
        torch.cuda.synchronize()
        delta = {k: B.LAUNCHES[k] - before[k] for k in B.LAUNCHES}
        log(f"{tag} train step {i} (batch {TRAIN_BATCH}): launches {delta}")
        if delta != want_step:
            raise AssertionError(f"{tag} train step {i}: launches {delta}, want {want_step}")
        kstats.append({k: v.item() for k, v in stats.items()})
        if i == 0:
            grads = {n: params[n].grad.detach().clone() for n in grad_names}
    launches = dict(B.LAUNCHES)
    record_launches(results, f"{tag}_train", launches)
    log(f"{tag} training-path launches over {TRAIN_STEPS} steps: {launches}")

    bad = [name for name in recorded if not check_step_tensors(tag, name, *seen[name], training)]
    if bad:
        raise AssertionError(f"{tag}: {bad} disagree with their plain versions on the step's tensors")
    seen.clear()

    # The step-1 gradients in f32 (plain versions, TF32 off) from the same
    # weights and dropout masks: the yardstick for both bf16 paths.
    rstate, rstep = make_step(ref_model, config, kernels=False, dtype=torch.float32)
    rstep(rstate, batch, LR, SEED)
    ref_grads = {n: p.grad for n, p in ref_model.named_parameters() if n in grad_names}
    del ref_model, rstate, rstep

    failures = []
    pparams = dict(plain_model.named_parameters())
    for i in range(TRAIN_STEPS):
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

    # Step time (CUDA events around 5 steps after 2 warm-up steps), in turns
    # kernels, plain, plain, kernels; the timing launches are not counted.
    def step_ms(fn, st, n=5):
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
        training[f"images_per_s_{which}"] = TRAIN_BATCH * 1e3 / mean
    training["peak_mem_gib_kernels"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag} training " + json.dumps(training))
    return step, state, batch


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


def profile_forward(model) -> None:
    """Kernel time by name over five batch-1 forwards (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(SEED))
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
    """Kernel time by name over two batch-128 train steps (torch.profiler)."""
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
                    help="print torch.profiler kernel tables of the batch-1 forward "
                         "and of the batch-128 LoRA and unfreeze train steps")
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
    phase_kernels(results)
    phase_mlp_dx(results)
    phase_train_kernels(results)
    model = phase_serving(results, serving)
    lora_run = phase_train(results, lora, "lora", LORA_CONFIG, LORA_LAUNCHES, LORA_GRAD_NAMES,
                           ("fused_mlp_dx",))
    unfreeze_run = phase_train(results, unfreeze, "unfreeze", UNFREEZE_CONFIG, UNFREEZE_LAUNCHES,
                               UNFREEZE_GRAD_NAMES, ("fused_mlp_bwd", "fused_attn_bwd"))
    by_batch = phase_times(results)
    if args.profile:
        profile_forward(model)
        profile_train_step(*lora_run)
        profile_train_step(*unfreeze_run)

    kernels = []
    for name, replaces in KERNEL_ROWS.items():
        b = ROW_BATCH[name]
        t = by_batch[b][name]
        row = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "batch": b,
            # Launches on the path the kernel belongs to (ROW_PATH), and on each path.
            "launches": row["launches"][ROW_PATH[name]],
            "launches_by_path": row["launches"],
            "max_abs_err": row["max_abs_err"],
            **({"max_grad_err_rel": row["max_grad_err_rel"]} if "max_grad_err_rel" in row else {}),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    log("kernel_times_b8 " + json.dumps(by_batch[8]))
    log("kernel_times_b128 " + json.dumps(by_batch[TRAIN_BATCH]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels, "b1": by_batch[1], "b8": by_batch[8],
                       "b128": by_batch[TRAIN_BATCH], "serving": serving,
                       "training": lora, "training_unfreeze": unfreeze}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
