"""Single-model inference benchmark (counterpart of
dino_pose_tpu/cli/benchmark_model.py).

    python -m dino_pose_tpu_torch.cli.benchmark_model [--model NAME_OR_PTH] [--iters N] [--warmup N]

3 warm-up + 20 timed single-image inferences by default, on the host clock:
end to end (PIL preprocessing, the copy to the device in its compute dtype,
the forward, closed by ``torch.cuda.synchronize()``) and device-only (the
forward on pixels already on the device, closed the same way: the
counterpart of JAX's ``block_until_ready``). Runs on the card; tests pass
``device="cpu"``.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch


def benchmark_model(
    model_name: str = "facebook/dinov2-small",
    warmup: int = 3,
    iters: int = 20,
    image_size: int | None = None,
    *,
    device: str | torch.device | None = None,
) -> dict:
    from PIL import Image

    from dino_pose_tpu_torch.core.device import resolve_device
    from dino_pose_tpu_torch.data.preprocess import create_preprocessor
    from dino_pose_tpu_torch.io.checkpoint import load_model_smart
    from dino_pose_tpu_torch.models.registry import resolve_model_name
    from dino_pose_tpu_torch.serve import device_pixels

    dev = resolve_device(device)
    model = load_model_smart(model_name, device=dev)
    proc = create_preprocessor(resolve_model_name(model.model_name))
    size = image_size or model.input_size

    rng = np.random.default_rng(0)
    image = Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def end_to_end():
        with torch.inference_mode():
            model(device_pixels(proc(image)["pixel_values"], dev))
        sync()

    pixels_const = device_pixels(proc(image)["pixel_values"], dev)

    def device_only():
        with torch.inference_mode():
            model(pixels_const)
        sync()

    for _ in range(warmup):
        end_to_end()
    e2e = []
    for _ in range(iters):
        t0 = time.perf_counter()
        end_to_end()
        e2e.append((time.perf_counter() - t0) * 1e3)
    dev_times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        device_only()
        dev_times.append((time.perf_counter() - t0) * 1e3)

    params = model.count_parameters(trainable_only=False)
    avg_ms = statistics.mean(e2e)
    dev_ms = statistics.mean(dev_times)
    result = {
        "model": model.model_name,
        "avg_ms": avg_ms,
        "p50_ms": statistics.median(e2e),
        "fps": 1e3 / avg_ms,
        "device_ms": dev_ms,
        "device_p50_ms": statistics.median(dev_times),
        "device_fps": 1e3 / dev_ms,
        "params": params,
    }
    print(f"\nBenchmark: {result['model']}")
    print(f"  Parameters:            {params:,}")
    print(f"  End-to-end average:    {avg_ms:.2f} ms  ({result['fps']:.1f} FPS)")
    print(f"  Device-only average:   {dev_ms:.2f} ms  ({result['device_fps']:.1f} FPS)")
    print(f"  Real-time 30 FPS: {'YES' if result['fps'] >= 30 else 'NO'}   "
          f"60 FPS: {'YES' if result['fps'] >= 60 else 'NO'}")
    return result


def main(argv=None, *, device=None) -> None:
    from dino_pose_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    parser = argparse.ArgumentParser(description="Benchmark pose model inference")
    parser.add_argument("--model", type=str, default="facebook/dinov2-small",
                        help="Checkpoint path, backbone name, or family name")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=3)
    args = parser.parse_args(argv)
    benchmark_model(args.model, warmup=args.warmup, iters=args.iters, device=device)


if __name__ == "__main__":
    main()
