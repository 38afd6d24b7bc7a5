"""Matplotlib pose visualisations (counterpart of dino_pose_tpu/viz/plots.py).

2-D skeleton overlay, 3-D scatter with skeleton links (predicted z lifted to
a pixel-comparable scale from the 2-D keypoint spread), the side-by-side
combined view and the annotated-keypoint overlay. Each plot takes decoded
(K, 2) keypoints, or (K, H, W) / (H, W, K) heatmaps, which it decodes with
the port's ``ops/decode`` on CPU tensors into the image's (width, height).
matplotlib is imported inside the functions.
"""

from __future__ import annotations

import numpy as np

import torch

from dino_pose_tpu_torch.constants import SKELETON_LINKS, KeyPoints
from dino_pose_tpu_torch.ops.decode import decode_heatmaps, heatmap_confidences


def _ensure_hwc(image) -> np.ndarray:
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[0] == 3 and arr.shape[-1] != 3:  # CHW
        arr = np.transpose(arr, (1, 2, 0))
    if arr.dtype != np.uint8:
        if arr.max() <= 1.0:
            arr = arr * 255
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr


def _maybe_decode(keypoints_or_heatmaps, image_size):
    """Accept (K, 2) keypoints or (K, H, W)/(H, W, K) heatmaps."""
    arr = np.asarray(keypoints_or_heatmaps)
    if arr.ndim == 2 and arr.shape[-1] in (2, 3):
        return arr[:, :2], None
    if arr.ndim == 3 and arr.shape[-1] not in (2, 3):
        # Heatmaps are square: (K, H, W) has equal TRAILING dims,
        # (H, W, K) equal LEADING dims. (A size>K comparison mis-transposed
        # any heatmap smaller than K=24.) The all-equal case (K == H == W)
        # is genuinely ambiguous — treat as the model-native (K, H, W).
        if arr.shape[1] != arr.shape[2] and arr.shape[0] == arr.shape[1]:
            arr = np.transpose(arr, (2, 0, 1))  # HWK -> KHW
        hm = torch.from_numpy(np.ascontiguousarray(arr[None], np.float32))
        kps = decode_heatmaps(hm, image_size)[0].numpy()
        conf = heatmap_confidences(hm)[0].numpy()
        return kps, conf
    raise ValueError(f"Cannot interpret keypoints/heatmaps of shape {arr.shape}")


def _draw_skeleton_2d(ax, kps, width, height):
    for a, b, color in SKELETON_LINKS:
        pa, pb = kps[a], kps[b]
        if (
            0 <= pa[0] <= width and 0 <= pa[1] <= height
            and 0 <= pb[0] <= width and 0 <= pb[1] <= height
        ):
            ax.plot([pa[0], pb[0]], [pa[1], pb[1]], color=color, linewidth=2, alpha=0.7)


def plot_keypoints(image, keypoints_or_heatmaps, keypoint_label=True, figsize=(12, 8)):
    """2-D overlay: keypoint dots + skeleton links on the image."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle

    img = _ensure_hwc(image)
    height, width = img.shape[:2]
    kps, _ = _maybe_decode(keypoints_or_heatmaps, (width, height))

    fig, ax = plt.subplots(figsize=figsize)
    ax.imshow(img)
    for i, (x, y) in enumerate(kps):
        ax.add_patch(Circle((x, y), 4, color="red", alpha=0.7))
        if keypoint_label:
            ax.text(
                x + 5, y + 5, KeyPoints(i).name, fontsize=8, color="white",
                bbox=dict(facecolor="black", alpha=0.5),
            )
    _draw_skeleton_2d(ax, kps, width, height)
    ax.set_title("Predicted Keypoints")
    ax.axis("off")
    return fig


def _lift_z(kps: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Scale normalised z to pixel-comparable units from the 2-D spread
    (the reference's demo-mode approximation, src/model_utils.py:235-341)."""
    scale = (np.std(kps[:, 0]) + np.std(kps[:, 1])) / 2.0
    return z * (scale if scale > 0 else 1.0)


def plot_3d_keypoints(image, keypoints_or_heatmaps, z_coords, keypoint_label=True, figsize=(10, 8)):
    """3-D scatter of (x, y, z) with skeleton links."""
    import matplotlib.pyplot as plt

    img = _ensure_hwc(image)
    height, width = img.shape[:2]
    kps, _ = _maybe_decode(keypoints_or_heatmaps, (width, height))
    z = _lift_z(kps, np.asarray(z_coords).reshape(-1))

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(kps[:, 0], z, -kps[:, 1], c="red", s=30)
    for a, b, color in SKELETON_LINKS:
        ax.plot(
            [kps[a, 0], kps[b, 0]], [z[a], z[b]], [-kps[a, 1], -kps[b, 1]],
            color=color, linewidth=2, alpha=0.7,
        )
    if keypoint_label:
        for i in range(len(kps)):
            ax.text(kps[i, 0], z[i], -kps[i, 1], KeyPoints(i).name, fontsize=7)
    ax.set_xlabel("x")
    ax.set_ylabel("z (depth)")
    ax.set_zlabel("-y")
    ax.set_title("Predicted 3D Keypoints")
    return fig


def plot_keypoints_combined(image, keypoints_or_heatmaps, z_coords, keypoint_label=False, figsize=(20, 8)):
    """Side-by-side 2-D overlay and 3-D scatter (reference combined mode)."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle

    img = _ensure_hwc(image)
    height, width = img.shape[:2]
    kps, _ = _maybe_decode(keypoints_or_heatmaps, (width, height))
    z = _lift_z(kps, np.asarray(z_coords).reshape(-1))

    fig = plt.figure(figsize=figsize)
    ax1 = fig.add_subplot(121)
    ax1.imshow(img)
    for x, y in kps:
        ax1.add_patch(Circle((x, y), 4, color="red", alpha=0.7))
    _draw_skeleton_2d(ax1, kps, width, height)
    ax1.set_title("2D Keypoints")
    ax1.axis("off")

    ax2 = fig.add_subplot(122, projection="3d")
    ax2.scatter(kps[:, 0], z, -kps[:, 1], c="red", s=30)
    for a, b, color in SKELETON_LINKS:
        ax2.plot(
            [kps[a, 0], kps[b, 0]], [z[a], z[b]], [-kps[a, 1], -kps[b, 1]],
            color=color, linewidth=2, alpha=0.7,
        )
    ax2.set_title("3D Keypoints")
    return fig


def visualize_pose(image, keypoints, figsize=(12, 8)):
    """Ground-truth-style overlay from (K, 3) annotated keypoints
    (only v != 0 points drawn; reference src/utils.py:114-184)."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle

    img = _ensure_hwc(image)
    height, width = img.shape[:2]
    kps = np.asarray(keypoints, np.float32)

    fig, ax = plt.subplots(figsize=figsize)
    ax.imshow(img)
    vis = kps[:, 2] != 0
    for i, (x, y, v) in enumerate(kps):
        if v != 0:
            ax.add_patch(Circle((x, y), 4, color="lime", alpha=0.8))
    for a, b, color in SKELETON_LINKS:
        if vis[a] and vis[b]:
            ax.plot([kps[a, 0], kps[b, 0]], [kps[a, 1], kps[b, 1]],
                    color=color, linewidth=2, alpha=0.7)
    ax.set_title("Annotated Keypoints")
    ax.axis("off")
    return fig


def fig_to_array(fig) -> np.ndarray:
    """Render a figure to an RGB uint8 array (for video frames)."""
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()
