"""Compare the inference speed of two models (counterpart of
dino_pose_tpu/cli/compare_models.py).

    python -m dino_pose_tpu_torch.cli.compare_models [--model_a A] [--model_b B] [--iters N]
                                                     [--device-time]

Each model through ``benchmark_model`` (10 timed iterations by default),
then the end-to-end speed ratio. ``--device-time`` replaces each model's
``device_ms`` with the time of forward + decode on pixels already on the
device: CUDA events around back-to-back calls on the card, the host clock on
the CPU. (JAX's flag takes that number from its root ``bench.py``; the port
measures it here.)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from dino_pose_tpu_torch.cli.benchmark_model import benchmark_model

DEVICE_TIME_WARMUP = 3


def forward_decode_ms(model_name: str, iters: int, *, device=None) -> float:
    """Mean ms of one forward + decode of a seeded batch-1 image at the
    model's input size, its pixels already on the device: CUDA events around
    ``iters`` back-to-back calls on the card, the host clock on the CPU."""
    from PIL import Image

    from dino_pose_tpu_torch.core.device import resolve_device
    from dino_pose_tpu_torch.data.preprocess import create_preprocessor
    from dino_pose_tpu_torch.io.checkpoint import load_model_smart
    from dino_pose_tpu_torch.ops.decode import decode_heatmaps
    from dino_pose_tpu_torch.serve import device_pixels

    dev = resolve_device(device)
    model = load_model_smart(model_name, device=dev)
    size = model.input_size
    rng = np.random.default_rng(0)
    image = Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    x = device_pixels(create_preprocessor(model.model_name)(image)["pixel_values"], dev)

    def call():
        with torch.inference_mode():
            heatmaps, _ = model(x)
            decode_heatmaps(heatmaps, (size, size))

    for _ in range(DEVICE_TIME_WARMUP):
        call()
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return (time.perf_counter() - t0) * 1e3 / iters


def main(argv=None, *, device=None) -> tuple[dict, dict]:
    """Parse ``argv``, benchmark both models and print the comparison;
    returns both results."""
    from dino_pose_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    parser = argparse.ArgumentParser(description="Compare two pose models")
    parser.add_argument("--model_a", type=str, default="facebook/dinov2-small")
    parser.add_argument("--model_b", type=str, default="timm/fastvit_t8.apple_in1k")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument(
        "--device-time", action="store_true",
        help="also report ON-DEVICE forward+decode latency on pixels already on the "
        "device (CUDA events on the card, the host clock on the CPU); the end-to-end "
        "column includes preprocessing and the copy to the device",
    )
    args = parser.parse_args(argv)

    a = benchmark_model(args.model_a, iters=args.iters, device=device)
    b = benchmark_model(args.model_b, iters=args.iters, device=device)
    if args.device_time:
        for r, name in ((a, args.model_a), (b, args.model_b)):
            r["device_ms"] = forward_decode_ms(name, args.iters, device=device)

    print("\nComparison (end-to-end):")
    for r in (a, b):
        dev = f", {r['device_ms']:.2f} ms on-device" if "device_ms" in r else ""
        print(
            f"  {r['model']}: {r['avg_ms']:.2f} ms ({r['fps']:.1f} FPS), "
            f"{r['params']:,} params{dev}"
        )
    ratio = a["avg_ms"] / b["avg_ms"]
    faster, slower = (b, a) if ratio > 1 else (a, b)
    print(f"  {faster['model']} is {max(ratio, 1 / ratio):.2f}x faster than {slower['model']}")
    if args.device_time:
        rd = a["device_ms"] / b["device_ms"]
        fd, sd = (b, a) if rd > 1 else (a, b)
        print(
            f"  on-device: {fd['model']} is {max(rd, 1 / rd):.2f}x faster "
            f"than {sd['model']}"
        )
    return a, b


if __name__ == "__main__":
    main()
