"""Layer functions with the JAX package's rounding points, and the static
resize operators (counterpart of dino_pose_tpu/nn/layers.py).

Modules of the port hold their parameters in the reference's torch layout
(``nn.Linear`` (out, in), ``nn.Conv2d`` (out, in/g, kh, kw),
``nn.ConvTranspose2d`` (in, out, kh, kw)) so that reference-schema state
dicts load with ``strict=True``. The functions below apply those parameters
the way ``dino_pose_tpu.nn.layers`` does: weights cast to the activation
dtype, the product rounded to that dtype, then the bias added in that dtype.
Activations are NCHW, torch's habit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Rounding-faithful layer applications
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``Dense``: (x @ W) in x.dtype, then + bias in x.dtype."""
    y = x @ layer.weight.t().to(x.dtype)
    if layer.bias is not None:
        y = y + layer.bias.to(x.dtype)
    return y


def conv2d(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """``Conv``: conv in x.dtype, then + bias in x.dtype."""
    y = F.conv2d(
        x, layer.weight.to(x.dtype), None, layer.stride, layer.padding,
        layer.dilation, layer.groups,
    )
    if layer.bias is not None:
        y = y + layer.bias.to(x.dtype).view(1, -1, 1, 1)
    return y


def conv_transpose2d(x: torch.Tensor, layer: nn.ConvTranspose2d,
                     stride: int | None = None) -> torch.Tensor:
    """``ConvTranspose`` with torch geometry: out = (in-1)*s - 2p + k (+op).
    ``stride`` overrides the layer's own (the heads choose it per call)."""
    y = F.conv_transpose2d(
        x, layer.weight.to(x.dtype), None, layer.stride if stride is None else stride,
        layer.padding, layer.output_padding,
    )
    if layer.bias is not None:
        y = y + layer.bias.to(x.dtype).view(1, -1, 1, 1)
    return y


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Eval ``BatchNorm`` from the running stats, f32 math, x.dtype output."""
    view = (1, -1, 1, 1)
    inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    y = (x.float() - bn.running_mean.view(view)) * inv.view(view) + bn.bias.view(view)
    return y.to(x.dtype)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train ``BatchNorm`` (torch semantics, as the JAX package's): f32
    two-pass batch statistics, the biased variance for normalising, the
    unbiased variance into ``running_var``, momentum ``bn.momentum``. The
    running statistics and ``num_batches_tracked`` update in place; output
    in x.dtype."""
    view = (1, -1, 1, 1)
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = (xf - mean.view(view)).square().mean(dim=(0, 2, 3))
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(m * mean.detach())
        bn.running_var.mul_(1 - m).add_(m * (var.detach() * (n / max(1, n - 1))))
        bn.num_batches_tracked.add_(1)
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean.view(view)) * inv.view(view) + bn.bias.view(view)
    return y.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout drawing its mask from ``generator`` (``None``: the
    device's default generator): keep with probability 1 - rate, scale the
    kept values by 1 / (1 - rate) in x.dtype (flax ``Dropout``)."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """LayerNorm with float32 statistics and output in x.dtype
    (dino_pose_tpu/ops/block.py ``_layernorm``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Static resize operators (torch F.interpolate parity, as matrices)
# ---------------------------------------------------------------------------

def _torch_src_coord(i: np.ndarray, scale: float) -> np.ndarray:
    # align_corners=False source coordinate.
    return (i + 0.5) * scale - 0.5


def cubic_resize_matrix(in_size: int, out_size: int, a: float = -0.75) -> np.ndarray:
    """(out, in) matrix applying torch's bicubic (align_corners=False)
    resample: cubic convolution with A=-0.75, border taps clamped."""
    scale = in_size / out_size
    x = _torch_src_coord(np.arange(out_size, dtype=np.float64), scale)
    x0 = np.floor(x).astype(np.int64)
    t = x - x0
    m = np.zeros((out_size, in_size), dtype=np.float64)

    def cubic(d):
        d = abs(d)
        if d <= 1:
            return (a + 2) * d**3 - (a + 3) * d**2 + 1
        if d < 2:
            return a * d**3 - 5 * a * d**2 + 8 * a * d - 4 * a
        return 0.0

    for i in range(out_size):
        for tap in range(-1, 3):
            idx = int(np.clip(x0[i] + tap, 0, in_size - 1))
            m[i, idx] += cubic(tap - t[i])
    return m.astype(np.float32)


def linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix applying torch's bilinear (align_corners=False) resample."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    x = np.clip(_torch_src_coord(np.arange(out_size, dtype=np.float64), scale), 0, in_size - 1)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, in_size - 1)
    x1 = np.clip(x0 + 1, 0, in_size - 1)
    t = x - x0
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        m[i, x0[i]] += 1 - t[i]
        m[i, x1[i]] += t[i]
    return m.astype(np.float32)


def nearest_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix applying torch's 'nearest' resample (floor indexing)."""
    scale = in_size / out_size
    idx = np.minimum((np.arange(out_size) * scale).astype(np.int64), in_size - 1)
    m = np.zeros((out_size, in_size), dtype=np.float32)
    m[np.arange(out_size), idx] = 1.0
    return m


def bilinear_resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """torch ``F.interpolate(mode='bilinear', align_corners=False)`` on NCHW,
    as two matrix products in x.dtype."""
    h, w = x.shape[-2], x.shape[-1]
    mh = torch.as_tensor(linear_resize_matrix(h, out_hw[0]), dtype=x.dtype, device=x.device)
    mw = torch.as_tensor(linear_resize_matrix(w, out_hw[1]), dtype=x.dtype, device=x.device)
    y = torch.einsum("oh,...hw->...ow", mh, x)
    return torch.einsum("pw,...ow->...op", mw, y)
