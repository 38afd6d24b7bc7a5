"""Model-input image preprocessing (the port's own copy of
dino_pose_tpu/data/preprocess.py).

Shortest-edge bicubic resize (PIL), centre crop, 1/255 rescale, ImageNet
normalise, CHW float32 — the HF ``BitImageProcessor`` pipeline for DINOv2
(shortest_edge 256, crop 224) and timm's eval transform for FastViT
(resize round(256/0.9) = 284, crop 256), with the published constants baked
in so that no hub access is needed.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class ShortestEdgePreprocessor:
    """shortest-edge resize -> centre crop -> rescale -> normalise -> CHW."""

    def __init__(self, shortest_edge: int, crop: int,
                 mean: np.ndarray = IMAGENET_MEAN, std: np.ndarray = IMAGENET_STD):
        self.shortest_edge = int(shortest_edge)
        self.crop = int(crop)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def resize_size(self, width: int, height: int) -> tuple[int, int]:
        short, long = (width, height) if width <= height else (height, width)
        new_short = self.shortest_edge
        new_long = int(new_short * long / short)
        return (new_short, new_long) if width <= height else (new_long, new_short)

    def _to_array(self, image) -> np.ndarray:
        from PIL import Image

        if not isinstance(image, Image.Image):
            image = Image.fromarray(np.asarray(image))
        if image.mode != "RGB":
            image = image.convert("RGB")
        new_w, new_h = self.resize_size(*image.size)
        arr = np.asarray(image.resize((new_w, new_h), Image.BICUBIC), np.float32)

        # Centre crop (zero padding where smaller, like HF center_crop).
        c, h, w = self.crop, arr.shape[0], arr.shape[1]
        top, left = (h - c) // 2, (w - c) // 2
        if top >= 0 and left >= 0:
            arr = arr[top : top + c, left : left + c]
        else:
            out = np.zeros((c, c, 3), np.float32)
            src_t, src_l = max(0, top), max(0, left)
            dst_t, dst_l = max(0, -top), max(0, -left)
            hh, ww = min(h, c), min(w, c)
            out[dst_t : dst_t + hh, dst_l : dst_l + ww] = arr[
                src_t : src_t + hh, src_l : src_l + ww
            ]
            arr = out

        arr = arr / np.float32(255.0)
        arr = (arr - self.mean) / self.std
        return np.transpose(arr, (2, 0, 1))

    def __call__(self, images) -> dict:
        if not isinstance(images, (list, tuple)):
            images = [images]
        return {"pixel_values": np.stack([self._to_array(im) for im in images])}


def create_preprocessor(model_name: str) -> ShortestEdgePreprocessor:
    """Processor for a resolved backbone name."""
    if model_name == "test/fastvit-tiny":  # test backbone runs at 128 input
        return ShortestEdgePreprocessor(round(128 / 0.9), 128)
    if model_name.startswith("timm/"):
        return ShortestEdgePreprocessor(round(256 / 0.9), 256)
    return ShortestEdgePreprocessor(256, 224)
