"""Pose heads: per-keypoint 48x48 heatmaps + scalar z (counterpart of
dino_pose_tpu/models/heads.py): ``SpatialAwarePoseHeads``, which both pose
models use, and the MLP variant ``HeatmapHead``/``PoseHeads``, which no
model uses (JAX keeps it for API completeness, and so does the port).

Module trees follow the reference torch Sequential index naming
(``heatmap_head.feature_refine.0`` ... ``z_head.mlp.9``), so reference-schema
state dicts load with ``strict=True``. Layers are applied with the JAX
package's rounding points (``nn/layers.py``). In train mode (``.train()``)
BatchNorm uses batch statistics and updates its running ones, and the z
head's dropout draws from the generator passed to ``forward``. Activations
are NCHW.

The MLP variant's torch key names are not in the repo (no model carries
it); its modules are named after JAX's (``proj0``..``proj2``, ``up{j}``,
``adjust``, ``pred``; ``io/convert.pose_heads_rules``), with the z head's
Sequential as the spatial variant's.
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


def run(seq: nn.Module, x: torch.Tensor,
        generator: torch.Generator | None = None) -> torch.Tensor:
    """Apply a Sequential with the JAX rounding points of each layer kind.
    In train mode BatchNorm normalises with batch statistics and updates its
    running ones, and Dropout draws its mask from ``generator``."""
    for m in seq:
        if isinstance(m, nn.Conv2d):
            x = L.conv2d(x, m)
        elif isinstance(m, nn.ConvTranspose2d):
            x = L.conv_transpose2d(x, m)
        elif isinstance(m, nn.BatchNorm2d):
            x = L.batch_norm_train(x, m) if m.training else L.batch_norm_eval(x, m)
        elif isinstance(m, nn.Linear):
            x = L.dense(x, m)
        elif isinstance(m, nn.ReLU):
            x = torch.relu(x)
        elif isinstance(m, nn.Dropout):
            x = L.dropout(x, m.p, generator) if m.training else x
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


def adaptive_avg_pool(x: torch.Tensor, target: int) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d(target)`` on NCHW as JAX computes it
    (heads.py:129-141): two averaging matrices in x.dtype over windows
    [floor(i*s/t), ceil((i+1)*s/t)), H then W."""
    s = x.shape[-1]
    m = torch.zeros((target, s), dtype=torch.float32)
    for i in range(target):
        lo, hi = (i * s) // target, -(-((i + 1) * s) // target)
        m[i, lo:hi] = 1.0 / (hi - lo)
    m = m.to(x.device, x.dtype)
    x = torch.einsum("ts,bcsw->bctw", m, x)
    return torch.einsum("ts,bchs->bcht", m, x)


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
    """Refine -> hourglass -> transposed-conv upsampling -> prediction ->
    bilinear resize to ``heatmap_size``.

    The upsampling stages are built for ``spatial_input_size`` (the grid the
    JAX registry initialises the model at: 224 // 14 = 16 for dinov2, the
    reference's fixed 14 for FastViT), so the parameter tree and the
    reference key set are those of that size. The plan that runs is taken
    from the ``spatial_input_size`` of each call, as the JAX heads take it
    at call time (dinov2 passes its token grid, FastViT 14 whatever its
    8x8 grid; left out, the feature map's grid): the first ``len(plan)``
    stages run with the plan's strides (a 36x36 grid at 504² runs
    ``upsampling.0`` at stride 1 alone). A plan with more stages than were
    built raises, as the JAX apply would for want of their parameters."""

    def __init__(self, in_channels: int, num_keypoints: int = 24,
                 heatmap_size: int = 48, spatial_input_size: int = 16):
        super().__init__()
        self.heatmap_size = heatmap_size
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

    def forward(self, fmap: torch.Tensor, spatial_input_size: int | None = None) -> torch.Tensor:
        x = run(self.feature_refine, fmap)
        tracker = fmap.shape[2] if spatial_input_size is None else spatial_input_size
        plan = upsampling_plan(tracker, self.heatmap_size)
        if len(plan) > len(self.upsampling):
            raise ValueError(
                f"a {tracker}x{tracker} spatial input size needs {len(plan)} upsampling "
                f"stages to reach {self.heatmap_size}, and the head was built with "
                f"{len(self.upsampling)}"
            )
        for stage, (_, stride) in zip(self.upsampling, plan):
            x = run(stage[1:], L.conv_transpose2d(x, stage[0], stride))
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

    def forward(self, feats: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return run(self.mlp, feats, generator)


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

    def forward(self, fmap: torch.Tensor, generator: torch.Generator | None = None,
                spatial_input_size: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        heatmaps = self.heatmap_head(fmap, spatial_input_size)
        z = self.z_head(fmap.mean(dim=(2, 3)), generator)
        return heatmaps, z


class HeatmapHead(nn.Module):
    """The MLP variant's heatmap head (heads.py:233-276): a vector in, three
    ``Dense`` projections (2048, 1024, s*s*c; ReLU, dropout 0.1 after the
    first two) reshaped as torch does to an NCHW (B, c, s, s) map, a chain
    of stride-2 3x3 transposed convs (BatchNorm, ReLU) that doubles it past
    ``heatmap_size`` (the reference's channel loop), then where it
    overshoots (or ends off 64 channels) the ``adjust`` conv to 64 with,
    on an overshoot, the adaptive average pool to ``heatmap_size``, and the
    1x1 ``pred``. Returns NCHW (B, K, heatmap, heatmap)."""

    def __init__(self, in_features: int, num_keypoints: int = 24, heatmap_size: int = 48,
                 intermediate_features: int = 512, spatial_size: int = 6):
        super().__init__()
        s, c = spatial_size, intermediate_features
        self.heatmap_size, self.spatial_size, self.channels_in = heatmap_size, s, c
        self.proj0 = nn.Linear(in_features, 2048)
        self.proj1 = nn.Linear(2048, 1024)
        self.proj2 = nn.Linear(1024, s * s * c)
        self.dropout = nn.Dropout(0.1)
        channels, current, out_ch = [256], s * 2, 128
        while current < heatmap_size:
            channels.append(out_ch)
            current *= 2
            out_ch = max(64, out_ch // 2)
        self.overshoot = current > heatmap_size
        stages, prev = [], c
        for ch in channels:
            stages.append(nn.Sequential(
                nn.ConvTranspose2d(prev, ch, 3, stride=2, padding=1, output_padding=1),
                nn.BatchNorm2d(ch), nn.ReLU()))
            prev = ch
        self.up = nn.ModuleList(stages)
        self.adjust = (_conv_bn_relu(prev, 64) if self.overshoot or prev != 64 else None)
        self.pred = nn.Conv2d(64, num_keypoints, 1)

    def forward(self, feats: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = feats
        for proj in (self.proj0, self.proj1):
            x = run((proj, nn.ReLU(), self.dropout), x, generator)
        x = torch.relu(L.dense(x, self.proj2))
        s = self.spatial_size
        x = x.reshape(x.shape[0], self.channels_in, s, s)
        for stage in self.up:
            x = run(stage, x)
        if self.adjust is not None:
            x = run(self.adjust, x)
            if self.overshoot:
                x = adaptive_avg_pool(x, self.heatmap_size)
        return L.conv2d(x, self.pred)


class PoseHeads(nn.Module):
    """The MLP variant's combined heads (heads.py:279-296): vector features
    in, ``HeatmapHead`` heatmaps and a ``ZCoordinateHead`` (1024, 512;
    dropout 0.2) z out. No model uses them."""

    def __init__(self, in_features: int, num_keypoints: int = 24, heatmap_size: int = 48):
        super().__init__()
        self.heatmap_head = HeatmapHead(in_features, num_keypoints, heatmap_size)
        self.z_head = ZCoordinateHead(in_features, num_keypoints, (1024, 512), 0.2)

    def forward(self, feats: torch.Tensor, generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        return self.heatmap_head(feats, generator), self.z_head(feats, generator)
