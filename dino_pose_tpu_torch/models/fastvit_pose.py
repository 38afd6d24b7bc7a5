"""FastViT pose model: FastViT backbone -> spatial-aware pose heads
(counterpart of dino_pose_tpu/models/fastvit_pose.py).

The heads sit at ``backbone.head`` (torch keys ``backbone.head.*``): the
reference replaces timm's classification head attribute with them. As the
reference does, the heads are built and run with ``spatial_input_size=14``
whatever the real stride-32 grid (8x8 at 256²): their upsampling plan is
that of 14 (stages at strides 3 and 1), and the trailing bilinear resize
brings the heatmaps to ``heatmap_size``.
"""

from __future__ import annotations

import torch
from torch import nn

from dino_pose_tpu_torch.models.fastvit import FastViTBackbone, FastViTConfig
from dino_pose_tpu_torch.models.heads import SpatialAwarePoseHeads

# The constant the reference passes to the heads for FastViT
# (fastvit_pose.py:34), not the 8x8 grid of a 256² input.
REFERENCE_SPATIAL_INPUT_SIZE = 14


class FastVitPoseModule(nn.Module):
    """``forward(pixels[B,3,H,W]) -> (heatmaps[B,K,h,h], z[B,K])``; eval
    only (the backbone refuses train mode)."""

    def __init__(self, cfg: FastViTConfig, num_keypoints: int = 24, heatmap_size: int = 48):
        super().__init__()
        self.cfg = cfg
        self.num_keypoints = num_keypoints
        self.heatmap_size = heatmap_size
        self.backbone = FastViTBackbone(cfg)
        self.backbone.head = SpatialAwarePoseHeads(
            cfg.out_channels, num_keypoints, heatmap_size,
            spatial_input_size=REFERENCE_SPATIAL_INPUT_SIZE,
            z_hidden_dims=(1024, 512, 256), z_dropout_rate=0.1,
        )

    def forward(self, pixels: torch.Tensor, *, kernels: bool = True,
                generator: torch.Generator | None = None):
        """``kernels=False`` runs the plain version of every ConvFFN and of
        the attention (the comparison path on the card)."""
        fmap = self.backbone(pixels, kernels=kernels)
        return self.backbone.head(fmap, generator,
                                  spatial_input_size=REFERENCE_SPATIAL_INPUT_SIZE)
