"""PCKh evaluation metrics, batched on the device (counterpart of
dino_pose_tpu/train/metrics.py).

The reference protocol:

- 2-D PCKh@r: threshold = ||TOP - NECK||_2 * r, falling back to the
  RIGHT_HIP/LEFT_HIP pair when the head isn't visible; an image with neither
  pair visible scores 0. Only visible keypoints (v != 0) are counted.
- z-PCKh@r: predictions are un-normalised back to annotation space; the
  threshold is r times the 3-D TOP-NECK distance (fallback: population std of
  the non-zero target z values); all K keypoints are counted (the reference
  does not mask visibility here — reproduced).

PCK@r (threshold = r * bbox diagonal of the visible keypoints) is the
PCK@0.2 protocol. Every function maps a batch to a (B,) f32 tensor on the
inputs' device; ``train/evaluate.py`` calls them per eval batch.
"""

from __future__ import annotations

import torch

from dino_pose_tpu_torch.constants import KeyPoints
from dino_pose_tpu_torch.data.keypoints import denormalize_z


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(v), dim=-1))


def _ratio(correct: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """correct / total where total > 0, else 0 (counts as (B,) ints)."""
    score = correct.float() / torch.clamp(total, min=1).float()
    return torch.where(total > 0, score, torch.zeros_like(score))


def pckh_2d(pred: torch.Tensor, target: torch.Tensor, threshold_ratio: float = 0.5) -> torch.Tensor:
    """Batched 2-D PCKh. pred (B, K, 2), target (B, K, 3) -> (B,)."""
    pred = pred.float()
    target = target.float()
    top, neck = target[:, KeyPoints.TOP], target[:, KeyPoints.NECK]
    rhip, lhip = target[:, KeyPoints.RIGHT_HIP], target[:, KeyPoints.LEFT_HIP]
    head_ok = (top[:, 2] != 0) & (neck[:, 2] != 0)
    hip_ok = (rhip[:, 2] != 0) & (lhip[:, 2] != 0)
    a = torch.where(head_ok[:, None], top[:, :2], rhip[:, :2])
    b = torch.where(head_ok[:, None], neck[:, :2], lhip[:, :2])
    thresh = _norm(a - b) * threshold_ratio

    vis = target[..., 2] != 0
    dist = _norm(pred - target[..., :2])
    correct = torch.sum((dist < thresh[:, None]) & vis, dim=-1)
    score = _ratio(correct, torch.sum(vis, dim=-1))
    return torch.where(head_ok | hip_ok, score, torch.zeros_like(score))


def _masked_population_std(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Population std of x over mask, per row: (B, K) -> (B,)."""
    n = torch.clamp(torch.sum(mask, dim=-1), min=1)
    mean = torch.sum(x * mask, dim=-1) / n
    var = torch.sum(torch.square(x - mean[:, None]) * mask, dim=-1) / n
    return torch.sqrt(var)


def pckh_z(pred_z: torch.Tensor, target_z: torch.Tensor, target_kps: torch.Tensor,
           threshold: float = 0.5) -> torch.Tensor:
    """Batched z-PCKh. pred_z/target_z (B, K) (target in annotation space),
    target_kps (B, K, 3) -> (B,)."""
    pred_z = pred_z.float()
    target_z = target_z.float()
    target_kps = target_kps.float()
    pred_ann = denormalize_z(pred_z, target_z, target_kps)
    top, neck = target_kps[:, KeyPoints.TOP], target_kps[:, KeyPoints.NECK]
    head_ok = (top[:, 2] > 0) & (neck[:, 2] > 0)
    d3 = torch.sqrt(
        torch.square(top[:, 0] - neck[:, 0])
        + torch.square(top[:, 1] - neck[:, 1])
        + torch.square(target_z[:, KeyPoints.TOP] - target_z[:, KeyPoints.NECK])
    )
    fallback = _masked_population_std(target_z, (target_z != 0).float())
    ref_dist = torch.where(head_ok, d3, fallback)
    correct = torch.abs(pred_ann - target_z) < threshold * ref_dist[:, None]
    return torch.mean(correct.float(), dim=-1)


def pck_bbox(pred: torch.Tensor, target: torch.Tensor,
             threshold_ratio: float = 0.2) -> torch.Tensor:
    """PCK@r with a bbox-diagonal threshold over visible keypoints: (B,)."""
    pred = pred.float()
    target = target.float()
    vis = (target[..., 2] != 0)[..., None]
    xy = target[..., :2]
    inf = torch.full_like(xy, float("inf"))
    extent = (torch.amax(torch.where(vis, xy, -inf), dim=1)
              - torch.amin(torch.where(vis, xy, inf), dim=1))
    diag = _norm(extent)
    dist = _norm(pred - xy)
    correct = torch.sum((dist < threshold_ratio * diag[:, None]) & vis[..., 0], dim=-1)
    return _ratio(correct, torch.sum(vis[..., 0], dim=-1))
