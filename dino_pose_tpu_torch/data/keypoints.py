"""Keypoint/z-coordinate normalisation math (counterpart of
dino_pose_tpu/data/keypoints.py).

The reference's formulas: z relative to a fixed-anthropometric centre of
mass, scaled by the mean of the x/y standard deviations of the
(visibility-masked) 2-D keypoints; the inverse maps predictions back with the
target's geometry. The std runs over *all* K values with invisible entries
zeroed (not over the visible subset), as the reference computes it.

The tensor functions run on the keypoints' device; :func:`normalize_z_np` is
the numpy twin the host input pipeline uses.
"""

from __future__ import annotations

import numpy as np
import torch

from dino_pose_tpu_torch.constants import COM_WEIGHTS

_EPS32 = float(np.finfo(np.float32).eps)


def z_scale(keypoints: torch.Tensor) -> torch.Tensor:
    """Scale used for z normalisation. keypoints: (..., K, 3)."""
    vis = (keypoints[..., 2] != 0).float()
    x = keypoints[..., 0] * vis
    y = keypoints[..., 1] * vis
    scale = (torch.std(x, dim=-1, correction=0) + torch.std(y, dim=-1, correction=0)) / 2
    return torch.where(scale == 0, torch.full_like(scale, _EPS32), scale)


def _com_weights(like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(COM_WEIGHTS, dtype=torch.float32, device=like.device)


def normalize_z(keypoints: torch.Tensor, z3d: torch.Tensor) -> torch.Tensor:
    """Annotation-space z -> normalised z. keypoints (..., K, 3), z3d (..., K)."""
    z = z3d - torch.sum(z3d * _com_weights(z3d), dim=-1, keepdim=True)
    return z / z_scale(keypoints)[..., None]


def denormalize_z(pred_z: torch.Tensor, target_z3d: torch.Tensor,
                  target_keypoints: torch.Tensor) -> torch.Tensor:
    """Predicted normalised z -> annotation space (uses target geometry)."""
    com = torch.sum(target_z3d * _com_weights(target_z3d), dim=-1, keepdim=True)
    return pred_z * z_scale(target_keypoints)[..., None] + com


def normalize_z_np(keypoints: np.ndarray, z3d: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`normalize_z` for the host input pipeline,
    formula-identical, including the zeroed-entry std."""
    kp = np.asarray(keypoints, np.float32)
    z3 = np.asarray(z3d, np.float32)
    vis = (kp[..., 2] != 0).astype(np.float32)
    x = kp[..., 0] * vis
    y = kp[..., 1] * vis
    scale = (x.std(axis=-1) + y.std(axis=-1)) / 2.0
    scale = np.where(scale == 0, _EPS32, scale).astype(np.float32)
    com_w = np.asarray(COM_WEIGHTS, np.float32)
    z = z3 - np.sum(z3 * com_w, axis=-1, keepdims=True)
    return (z / scale[..., None]).astype(np.float32)
