"""Training losses (counterpart of dino_pose_tpu/train/losses.py).

- Heatmap loss: MSE masked to visible keypoints (visibility == 2), weighted
  by ``exp(-diff)`` of the *detached* squared error, then a mean over all
  elements (masked ones count in the denominator).
- Z loss: L1 between visibility-masked predictions and targets, mean over
  all (B, K) entries.

``sample_valid`` is an optional (B,) 0/1 mask of real (vs padded) samples:
padded samples add zero and leave the denominator. Both compute in f32.

Under a data axis across ranks (``core/distributed.data_axis``) each rank
returns its part of the global batch's loss, and the parts sum to it: the
masked losses divide this rank's numerator by the all-reduced global valid
count (ranks may hold different numbers of valid rows), the unmasked means
are ``local_mean * B_local / B_global``. With no data axis, the loss of
the batch at hand, as before.
"""

from __future__ import annotations

import math

import torch

from dino_pose_tpu_torch.core import distributed


def _mean_part(t: torch.Tensor) -> torch.Tensor:
    """``t``'s mean as this rank's part of the global batch's mean (equal
    local batches: ``local_mean * B_local / B_global``)."""
    axis = distributed.data_axis()
    return torch.mean(t) if axis is None else torch.mean(t) / axis.size


def keypoint_loss(
    pred_heatmaps: torch.Tensor,
    target_heatmaps: torch.Tensor,
    confidence: torch.Tensor,
    sample_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """pred/target: (B, K, H, W); confidence: (B, K) visibility flags."""
    mask = (confidence > 1).float()[..., None, None]
    diff = torch.square(pred_heatmaps.float() - target_heatmaps.float())
    weight = torch.exp(-diff.detach())
    if sample_valid is None:
        return _mean_part(weight * diff * mask)
    sv = sample_valid.float()
    per_elem = weight * diff * mask * sv[:, None, None, None]
    denom = torch.clamp(distributed.data_sum(sv.sum()), min=1.0) * math.prod(pred_heatmaps.shape[1:])
    return per_elem.sum() / denom


def z_loss(
    pred_z: torch.Tensor,
    target_z: torch.Tensor,
    confidence: torch.Tensor,
    sample_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """pred/target: (B, K); confidence: (B, K) visibility flags."""
    mask = (confidence > 1).float()
    abs_err = torch.abs(pred_z.float() * mask - target_z.float() * mask)
    if sample_valid is None:
        return _mean_part(abs_err)
    sv = sample_valid.float()
    denom = torch.clamp(distributed.data_sum(sv.sum()), min=1.0) * pred_z.shape[-1]
    return (abs_err * sv[:, None]).sum() / denom
