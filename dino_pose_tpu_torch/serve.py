"""Serving entry point: preprocess -> forward -> decode on the device
(counterpart of the JAX package's ``cli/demo.make_predictor`` and
``bench.bench_infer``'s ``infer``).

    model = registry.create_model_from_config({"model_name": ..., "use_lora": True})
    predict = make_predictor(model)          # cuda; device="cpu" on request
    keypoints, z, heatmaps = predict(images)  # list of PIL images or (B,3,H,W)
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dino_pose_tpu_torch.core.device import resolve_device
from dino_pose_tpu_torch.core.precision import policy_for_device
from dino_pose_tpu_torch.data.preprocess import create_preprocessor
from dino_pose_tpu_torch.ops.decode import decode_heatmaps


def device_pixels(pixels: np.ndarray, device: torch.device) -> torch.Tensor:
    """(B, 3, H, W) host pixels on ``device`` in its compute dtype: bf16 on
    the card, where every kernel wrapper refuses f32 activations, f32 on the
    CPU. The one cast that every entry point applies."""
    dtype = policy_for_device(device).compute_dtype
    return torch.from_numpy(np.ascontiguousarray(pixels, np.float32)).to(device).to(dtype)


def make_predictor(
    model: torch.nn.Module, device: str | torch.device | None = None
) -> Callable[..., tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Move ``model`` to ``device`` (default ``cuda``) in eval mode and return
    ``predict(images) -> (keypoints[B,K,2], z[B,K], heatmaps[B,K,h,w])`` as
    host float32 numpy arrays. Pixels run in the device's compute dtype
    (bf16 on the card, f32 on the CPU). Keypoints are decoded into the width and
    height of the pixels the model was given (for PIL images the crop of the
    model's preprocessor: 224² for dinov2, 256² for FastViT), as the JAX
    bench decodes into its image size."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    preprocessor = create_preprocessor(getattr(model, "model_name", "facebook/dinov2-small"))

    def predict(images) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if isinstance(images, np.ndarray):
            if images.ndim != 4 or images.shape[1] != 3:
                raise ValueError(f"expected a (B, 3, H, W) array, got {images.shape}")
            pixels = images
        else:
            pixels = preprocessor(list(images))["pixel_values"]
        x = device_pixels(pixels, dev)
        with torch.inference_mode():
            heatmaps, z = model(x)
            keypoints = decode_heatmaps(heatmaps, (x.shape[-1], x.shape[-2]))
        return (
            keypoints.float().cpu().numpy(),
            z.float().cpu().numpy(),
            heatmaps.float().cpu().numpy(),
        )

    return predict
