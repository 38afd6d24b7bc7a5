"""End-to-end pose model (counterpart of dino_pose_tpu/models/pose.py).

Public forward contract (reference ``base_pose.py``):
``forward(pixels[B,3,H,W]) -> (heatmaps[B,K,heatmap,heatmap], z[B,K])``.
"""

from __future__ import annotations

import torch
from torch import nn

from dino_pose_tpu_torch.models.heads import SpatialAwarePoseHeads
from dino_pose_tpu_torch.models.vit import Dinov2Backbone, ViTConfig


class DinoPoseModule(nn.Module):
    """DINOv2 backbone + spatial-aware pose heads (torch keys ``backbone.*``
    and ``pose_heads.*``)."""

    def __init__(self, vit: ViTConfig, num_keypoints: int = 24, heatmap_size: int = 48,
                 input_size: int = 224):
        super().__init__()
        self.vit = vit
        self.num_keypoints = num_keypoints
        self.heatmap_size = heatmap_size
        self.input_size = input_size
        self.backbone = Dinov2Backbone(vit)
        self.pose_heads = SpatialAwarePoseHeads(
            vit.hidden_size, num_keypoints, heatmap_size,
            spatial_input_size=input_size // vit.patch_size,
        )

    def forward(self, pixels: torch.Tensor, *, kernels: bool = True):
        """``kernels=False`` runs every block through its plain PyTorch
        version (the comparison path on the card); on the CPU both are plain."""
        if self.training:
            raise NotImplementedError(
                "training is not yet ported; call .eval() for inference"
            )
        tokens, (hp, wp) = self.backbone(pixels, kernels=kernels)
        b, _, d = tokens.shape
        fmap = tokens[:, 1:, :].transpose(1, 2).reshape(b, d, hp, wp)
        return self.pose_heads(fmap)
