"""Spatial-aware pose heads: per-keypoint 48x48 heatmaps + scalar z
(counterpart of dino_pose_tpu/models/heads.py, ``SpatialAwarePoseHeads``).

Module trees follow the reference torch Sequential index naming
(``heatmap_head.feature_refine.0`` ... ``z_head.mlp.9``), so reference-schema
state dicts load with ``strict=True``. Layers are applied with the JAX
package's rounding points (``nn/layers.py``); BatchNorm uses its running
statistics (inference only in this slice). Activations are NCHW.

The MLP-variant heads (``HeatmapHead``/``PoseHeads``), which no model of the
repo uses, are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from dino_pose_tpu_torch.nn import layers as L


def _conv_bn_relu(cin: int, cout: int, k: int = 3, stride: int = 1, pad: int = 1,
                  groups: int = 1) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(cin, cout, k, stride=stride, padding=pad, groups=groups),
        nn.BatchNorm2d(cout),
        nn.ReLU(),
    )


def _deconv_bn_relu(cin: int, cout: int, k: int, stride: int, pad: int = 0) -> nn.Sequential:
    return nn.Sequential(
        nn.ConvTranspose2d(cin, cout, k, stride=stride, padding=pad),
        nn.BatchNorm2d(cout),
        nn.ReLU(),
    )


def run(seq: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a Sequential with the JAX rounding points of each layer kind."""
    for m in seq:
        if isinstance(m, nn.Conv2d):
            x = L.conv2d(x, m)
        elif isinstance(m, nn.ConvTranspose2d):
            x = L.conv_transpose2d(x, m)
        elif isinstance(m, nn.BatchNorm2d):
            x = L.batch_norm_eval(x, m)
        elif isinstance(m, nn.Linear):
            x = L.dense(x, m)
        elif isinstance(m, nn.ReLU):
            x = torch.relu(x)
        elif isinstance(m, nn.Dropout):
            x = nn.functional.dropout(x, m.p, m.training)
        else:
            x = m(x)
    return x


class HourglassModule(nn.Module):
    """Three-path hourglass: depthwise-separable + down/up pyramid + 1x1 skip."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        c = out_channels
        self.depthwise_conv = nn.Sequential(
            *_conv_bn_relu(in_channels, in_channels, groups=in_channels),
            *_conv_bn_relu(in_channels, c, k=1, pad=0),
        )
        self.down1 = _conv_bn_relu(in_channels, c // 2, stride=2)
        self.down2 = _conv_bn_relu(c // 2, c // 4, stride=2)
        self.bottleneck = nn.Sequential(
            *_conv_bn_relu(c // 4, c // 4),
            nn.Conv2d(c // 4, c // 4, 3, padding=1),
            nn.BatchNorm2d(c // 4),
        )
        self.up1 = _deconv_bn_relu(c // 4, c // 2, 2, 2)
        self.up2 = _deconv_bn_relu(c // 2, c, 2, 2)
        self.skip = _conv_bn_relu(in_channels, c, k=1, pad=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] % 4 or x.shape[3] % 4:
            raise ValueError(
                f"HourglassModule needs a spatial grid divisible by 4, got "
                f"{x.shape[2]}x{x.shape[3]} (input_size/patch_size must be "
                f"divisible by 4; the reference heads have the same limit)"
            )
        skip = run(self.skip, x)
        dw = run(self.depthwise_conv, x)
        d2 = run(self.down2, run(self.down1, x))
        b = torch.relu(run(self.bottleneck, d2) + d2)
        u2 = run(self.up2, run(self.up1, b))
        return u2 + skip + dw


def upsampling_plan(spatial_input_size: int, heatmap_size: int) -> list[tuple[int, int]]:
    """The reference's stage loop: list of (out_channels, stride). The
    tracker doubles per stage regardless of the real output size."""
    plan = []
    current, in_ch = spatial_input_size, 256
    while current < heatmap_size:
        out_ch = max(128, in_ch // 2)
        plan.append((out_ch, heatmap_size // current))
        current *= 2
        in_ch = out_ch
    return plan


class SpatialAwareHeatmapHead(nn.Module):
    def __init__(self, in_channels: int, num_keypoints: int = 24,
                 heatmap_size: int = 48, spatial_input_size: int = 16):
        super().__init__()
        self.heatmap_size = heatmap_size
        self.spatial_input_size = spatial_input_size
        self.feature_refine = nn.Sequential(
            *_conv_bn_relu(in_channels, 512),
            HourglassModule(512, 512),
            *_conv_bn_relu(512, 256),
        )
        stages, in_ch = [], 256
        for out_ch, stride in upsampling_plan(spatial_input_size, heatmap_size):
            stages.append(_deconv_bn_relu(in_ch, out_ch, 4, stride, pad=1))
            in_ch = out_ch
        self.upsampling = nn.ModuleList(stages)
        self.prediction = nn.Sequential(
            *_conv_bn_relu(in_ch, 64),
            nn.Conv2d(64, num_keypoints, 1),
        )

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        x = run(self.feature_refine, fmap)
        tracker = self.spatial_input_size
        for stage in self.upsampling:
            x = run(stage, x)
            tracker *= 2
        x = run(self.prediction, x)
        # Bug-for-bug: the reference gates the resize on its doubling
        # tracker, not on the real tensor size.
        if tracker != self.heatmap_size:
            x = L.bilinear_resize(x, (self.heatmap_size, self.heatmap_size))
        return x  # (B, K, heatmap, heatmap)


class ZCoordinateHead(nn.Module):
    def __init__(self, in_features: int, num_keypoints: int = 24,
                 hidden_dims: Sequence[int] = (1024, 512, 256), dropout_rate: float = 0.1):
        super().__init__()
        layers: list[nn.Module] = []
        prev = in_features
        for h in hidden_dims:
            layers += [nn.Linear(prev, h), nn.ReLU(), nn.Dropout(dropout_rate)]
            prev = h
        layers.append(nn.Linear(prev, num_keypoints))
        self.mlp = nn.Sequential(*layers)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return run(self.mlp, feats)


class SpatialAwarePoseHeads(nn.Module):
    """Heatmaps from the spatial map + z from its global average pool."""

    def __init__(self, in_channels: int, num_keypoints: int = 24, heatmap_size: int = 48,
                 spatial_input_size: int = 16,
                 z_hidden_dims: Sequence[int] = (1024, 512, 256), z_dropout_rate: float = 0.1):
        super().__init__()
        self.heatmap_head = SpatialAwareHeatmapHead(
            in_channels, num_keypoints, heatmap_size, spatial_input_size
        )
        self.z_head = ZCoordinateHead(in_channels, num_keypoints, z_hidden_dims, z_dropout_rate)

    def forward(self, fmap: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        heatmaps = self.heatmap_head(fmap)
        z = self.z_head(fmap.mean(dim=(2, 3)))
        return heatmaps, z
