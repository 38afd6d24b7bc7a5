"""End-to-end pose model (counterpart of dino_pose_tpu/models/pose.py).

Public forward contract (reference ``base_pose.py``):
``forward(pixels[B,3,H,W]) -> (heatmaps[B,K,heatmap,heatmap], z[B,K])``.
"""

from __future__ import annotations

import torch
from torch import nn

from dino_pose_tpu_torch.models.heads import SpatialAwarePoseHeads
from dino_pose_tpu_torch.models.vit import Dinov2Backbone, ViTConfig


# The input size the JAX registry initialises a dinov2 model at: the heads'
# upsampling stages (and so the parameter tree) are built for its patch grid.
INIT_INPUT_SIZE = 224


class DinoPoseModule(nn.Module):
    """DINOv2 backbone + spatial-aware pose heads (torch keys ``backbone.*``
    and ``pose_heads.*``). Any input whose patch grid is divisible by 4 runs;
    the heads take their upsampling plan from the grid of each call."""

    def __init__(self, vit: ViTConfig, num_keypoints: int = 24, heatmap_size: int = 48):
        super().__init__()
        self.vit = vit
        self.num_keypoints = num_keypoints
        self.heatmap_size = heatmap_size
        self.backbone = Dinov2Backbone(vit)
        self.pose_heads = SpatialAwarePoseHeads(
            vit.hidden_size, num_keypoints, heatmap_size,
            spatial_input_size=INIT_INPUT_SIZE // vit.patch_size,
        )

    def forward(self, pixels: torch.Tensor, *, kernels: bool = True,
                generator: torch.Generator | None = None):
        """``kernels=False`` runs every block through its plain PyTorch
        version (the comparison path on the card); on the CPU both are plain.
        In train mode (``.train()``) BatchNorm uses batch statistics and the
        LoRA and z-head dropouts draw from ``generator``."""
        tokens, (hp, wp) = self.backbone(pixels, kernels=kernels, generator=generator)
        b, _, d = tokens.shape
        fmap = tokens[:, 1:, :].transpose(1, 2).reshape(b, d, hp, wp)
        return self.pose_heads(fmap, generator, spatial_input_size=hp)
