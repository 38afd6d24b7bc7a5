"""Keypoint decoding from heatmaps, on the device (counterpart of
dino_pose_tpu/ops/decode.py).

Argmax, then an intensity-weighted centroid over the 5x5 window around it
(half-pixel centres), scaled to the target image size — the reference's
``weighted_max_loc`` vectorised over (B, K) with masks instead of crops.
"""

from __future__ import annotations

import os

import torch

_WINDOW = 2  # 5x5 window

# DINO_POSE_TPU_DECODE_GUARD=1 replaces the NaN of an all-zero window with
# the argmax cell centre (the JAX package's flag, read at import the same way).
GUARD_ZERO_WINDOW = os.environ.get("DINO_POSE_TPU_DECODE_GUARD", "0") == "1"


def decode_heatmaps(
    heatmaps: torch.Tensor,
    target_size: tuple[int, int] = (224, 224),
    *,
    guard_zero_window: bool | None = None,
) -> torch.Tensor:
    """(B, K, H, W) heatmaps -> (B, K, 2) keypoints in target (x, y) pixels.

    A window that sums to exactly 0 gives NaN coordinates (0/0, as the
    reference's numpy division does) unless ``guard_zero_window`` (default:
    the ``DINO_POSE_TPU_DECODE_GUARD`` flag) is set."""
    guard = GUARD_ZERO_WINDOW if guard_zero_window is None else guard_zero_window
    b, k, h, w = heatmaps.shape
    hm = heatmaps.float()
    flat_idx = hm.reshape(b, k, h * w).argmax(dim=-1)
    cy = (flat_idx // w)[..., None, None]
    cx = (flat_idx % w)[..., None, None]
    rows = torch.arange(h, device=hm.device).view(1, 1, h, 1)
    cols = torch.arange(w, device=hm.device).view(1, 1, 1, w)
    mask = ((rows - cy).abs() <= _WINDOW) & ((cols - cx).abs() <= _WINDOW)
    win = torch.where(mask, hm, torch.zeros((), device=hm.device))
    total = win.sum(dim=(-2, -1))
    sx = ((cols.float() + 0.5) * win).sum(dim=(-2, -1))
    sy = ((rows.float() + 0.5) * win).sum(dim=(-2, -1))
    if guard:
        safe = total > 0.0
        denom = torch.where(safe, total, torch.ones_like(total))
        loc_x = torch.where(safe, sx / denom, cx[..., 0, 0].float() + 0.5)
        loc_y = torch.where(safe, sy / denom, cy[..., 0, 0].float() + 0.5)
    else:
        loc_x = sx / total
        loc_y = sy / total
    tw, th = target_size
    return torch.stack([loc_x / w * tw, loc_y / h * th], dim=-1)


def heatmap_confidences(heatmaps: torch.Tensor) -> torch.Tensor:
    """Peak value per keypoint channel: (B, K, H, W) -> (B, K)."""
    return heatmaps.amax(dim=(-2, -1))
