"""Gaussian heatmap targets (counterpart of dino_pose_tpu/data/heatmaps.py).

Reference semantics: for each visible keypoint, splat ``exp(-d^2 / 2 sigma^2)``
(sigma = 15) onto a full-resolution canvas inside a square window of
half-width ``delta * sigma`` (delta = sqrt(2 * 1.6052)), window corners
truncated, then an OpenCV INTER_CUBIC resize to the heatmap size. Keypoints
with x < 0, y < 0 or v == 0 give an all-zero channel.

Both the windowed Gaussian and the bicubic resize are separable, so one
channel is ``(R_y @ g_y) (R_x @ g_x)^T`` with constant (heatmap, image)
resize matrices that reproduce OpenCV's taps; no canvas is materialised.
``render_heatmaps`` does that for a batch on the keypoints' device in f32;
``render_heatmaps_host`` is its float64 numpy twin.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

SIGMA = 15.0
TH = 1.6052
DELTA = math.sqrt(TH * 2)
_LOG2E = math.log2(math.e)


def _cubic_weights(frac: np.ndarray, a: float = -0.75) -> np.ndarray:
    """OpenCV bicubic tap weights for fractional offsets (taps at -1..2),
    evaluated in float32 like cv2's interpolateCubic."""
    frac = frac.astype(np.float32)
    a = np.float32(a)
    one, two, three, five, eight = (np.float32(c) for c in (1, 2, 3, 5, 8))
    t0 = one + frac  # distance to tap at floor(x) - 1
    t1 = frac        # tap at floor(x)
    t2 = one - frac  # tap at floor(x) + 1
    t3 = two - frac  # tap at floor(x) + 2

    def near(t):  # |t| <= 1
        return ((a + two) * t - (a + three)) * t * t + one

    def far(t):  # 1 < |t| < 2
        return ((a * t - five * a) * t + eight * a) * t - np.float32(4) * a

    return np.stack([far(t0), near(t1), near(t2), far(t3)], axis=-1)


def resize_matrix(src: int, dst: int, dtype=np.float64) -> np.ndarray:
    """(dst, src) matrix M with (M @ v) == cv2.resize(v, INTER_CUBIC) in 1-D:
    half-pixel centres, border-replicate clamping, source coordinate and tap
    weights truncated to float32 as OpenCV does."""
    scale = src / dst
    i = np.arange(dst, dtype=np.float64)
    sx = ((i + 0.5) * scale - 0.5).astype(np.float32)
    x0 = np.floor(sx)
    frac = (sx - x0).astype(np.float32)
    w = _cubic_weights(frac).astype(np.float32).astype(np.float64)  # (dst, 4)
    m = np.zeros((dst, src), np.float64)
    for tap in range(4):
        cols = np.clip(x0.astype(np.int64) + tap - 1, 0, src - 1)
        np.add.at(m, (np.arange(dst), cols), w[:, tap])
    return m.astype(dtype)


def _windowed_gaussians(centers: np.ndarray, size: int):
    """numpy: ``(gaussians (K, size), lo (K,), hi (K,))`` with
    exp(-(x-c)^2/2s^2) masked to the [lo, hi) window."""
    r = DELTA * SIGMA
    lo = np.floor(np.maximum(0.0, centers - r))
    hi = np.floor(np.minimum(float(size), centers + r))
    xs = np.arange(size, dtype=centers.dtype)
    mask = (xs[None, :] >= lo[:, None]) & (xs[None, :] < hi[:, None])
    g = np.exp(-((xs[None, :] - centers[:, None]) ** 2) / (2.0 * SIGMA**2))
    return g * mask, lo, hi


def _windowed_gaussians_torch(centers: torch.Tensor, size: int):
    """torch twin of :func:`_windowed_gaussians` over a (..., K) batch."""
    r = DELTA * SIGMA
    lo = torch.floor(torch.clamp(centers - r, min=0.0))
    hi = torch.floor(torch.clamp(centers + r, max=float(size)))
    xs = torch.arange(size, dtype=centers.dtype, device=centers.device)
    mask = (xs >= lo[..., None]) & (xs < hi[..., None])
    # exp2 of the exponent times log2(e), not torch.exp: on the CPU torch.exp
    # goes through MKL's vector math, whose first call in a process has
    # returned a run of values up to 2e-5 off (relative) on a loaded host,
    # while the same call repeated was right; exp2 does not take that path.
    g = torch.exp2(-((xs - centers[..., None]) ** 2) * (_LOG2E / (2.0 * SIGMA**2)))
    return g * mask, lo, hi


def render_heatmaps_host(
    keypoints: np.ndarray, image_size: tuple[int, int], heatmap_size: int = 48
) -> np.ndarray:
    """Reference-exact host render. keypoints (K, 3); image_size (W, H).
    Returns (K, heatmap_size, heatmap_size) float32."""
    kps = np.asarray(keypoints, np.float64)
    width, height = int(image_size[0]), int(image_size[1])
    cx, cy, v = kps[:, 0], kps[:, 1], kps[:, 2]
    gx, x_lo, x_hi = _windowed_gaussians(cx, width)
    gy, y_lo, y_hi = _windowed_gaussians(cy, height)
    valid = (cx >= 0) & (cy >= 0) & (v != 0) & (x_lo < x_hi) & (y_lo < y_hi)
    gxr = gx @ resize_matrix(width, heatmap_size).T  # (K, hs)
    gyr = gy @ resize_matrix(height, heatmap_size).T
    hm = np.einsum("kh,kw->khw", gyr, gxr) * valid[:, None, None]
    return hm.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_resize_matrix(src: int, dst: int, device: torch.device) -> torch.Tensor:
    """:func:`resize_matrix` in f32 on ``device``, built once per shape."""
    return torch.as_tensor(resize_matrix(src, dst, np.float32), device=device)


def render_heatmaps(
    keypoints: torch.Tensor, *, height: int = 224, width: int = 224, heatmap_size: int = 48
) -> torch.Tensor:
    """Batched render on the keypoints' device, f32: (B, K, 3) keypoints ->
    (B, K, hs, hs) targets."""
    kps = keypoints.float()
    rx = _device_resize_matrix(width, heatmap_size, kps.device)
    ry = _device_resize_matrix(height, heatmap_size, kps.device)
    cx, cy, v = kps[..., 0], kps[..., 1], kps[..., 2]
    gx, x_lo, x_hi = _windowed_gaussians_torch(cx, width)
    gy, y_lo, y_hi = _windowed_gaussians_torch(cy, height)
    valid = (cx >= 0) & (cy >= 0) & (v != 0) & (x_lo < x_hi) & (y_lo < y_hi)
    gxr = gx @ rx.t()  # (B, K, hs)
    gyr = gy @ ry.t()
    return gyr[..., :, None] * gxr[..., None, :] * valid[..., None, None]
