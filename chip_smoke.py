"""Chip smoke test of the PyTorch/H100 port: build the CUDA kernels, hold each
against its plain PyTorch version, serve dinov2-small + LoRA pose requests
through the kernels, and time kernels and serving.

    python3 chip_smoke.py [--out results.json] [--profile]

Needs one CUDA card and ``nvcc``; exits non-zero without a card, when a
kernel does not build, launch or agree, or when any phase fails. The last
line of standard output is ``{"ok": true, "device": {...}}``; the line before
it is the card's ``nvidia-smi`` name and power limit, and before that the
per-kernel JSON line. Weights are random (from a seed), so only agreement
between paths is checked, not pose accuracy.
"""

from __future__ import annotations

import argparse
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
KERNEL_ROWS = {
    "fused_block": "dino_pose_tpu/ops/block.py:159",
    "fused_attn_part": "dino_pose_tpu/ops/block.py:999",
    "fused_mlp_part": "dino_pose_tpu/ops/block.py:1021",
}
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

    per_forward = {"fused_block": 11, "fused_attn_part": 1, "fused_mlp_part": 1}
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
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main path")
        results[name]["launches"] = n
    log(f"main-path launches over {len(requests)} requests: {launches}")

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write all measurements to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler kernel table of the batch-1 forward")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
    phase_kernels(results)
    model = phase_serving(results, serving)
    by_batch = phase_times(results)
    if args.profile:
        profile_forward(model)

    kernels = []
    for name, replaces in KERNEL_ROWS.items():
        t = by_batch[1][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": results[name]["launches"],
            "max_abs_err": results[name]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    log("kernel_times_b8 " + json.dumps(by_batch[8]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels, "b8": by_batch[8],
                       "serving": serving}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
