"""Eval-time reparameterisation folds of the FastViT blocks (counterpart of
the eval parts of dino_pose_tpu/models/fastvit_fold.py).

With running statistics a BatchNorm is an affine map, ``BN(y) = y * inv +
shift``, so each (conv, BN) branch of a multi-branch block folds into its
conv kernel scaled per output channel plus a bias, the 1x1 scale branch
zero-pads to the centre of the kxk kernel, and the identity BN branch is a
centred dirac. A block then runs as one conv: ``apply_folded``. Kernels are
in torch layout, (out, in/groups, kh, kw), and folded in f32.

``cached_fold`` keeps each module's folded tensors, cast to the compute
dtype, keyed on the dtype, the device and the data pointers and versions of
every parameter and buffer involved: a loaded state dict or any in-place
update folds them anew, so no forward sees stale weights (as
``models/vit.py`` caches its packed block weights).

The train-time forms (batch statistics, the reuse arrangement,
``_dw_s2_conv_frozen``) belong to the FastViT training slice.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn


def bn_affine(bn: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """``BNAffine`` in eval (fastvit_fold.py:197-243): f32 (inv, shift) from
    the running statistics, inv = rsqrt(var + eps) * scale."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    return inv, bn.bias.float() - bn.running_mean.float() * inv


def fold_branch(weight: torch.Tensor, bn: nn.BatchNorm2d, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``fold_stats_branch`` in eval (fastvit_fold.py:287-325): a (conv, BN)
    branch as an f32 (kernel term zero-padded to k x k at the centre, bias
    term)."""
    inv, shift = bn_affine(bn)
    term = weight.float() * inv.view(-1, 1, 1, 1)
    lo = (k - weight.shape[-1]) // 2
    hi = k - weight.shape[-1] - lo
    return F.pad(term, (lo, hi, lo, hi)), shift


def center_identity(k: int, in_g: int, features: int,
                    device: torch.device | None = None) -> torch.Tensor:
    """``_center_identity`` (fastvit_fold.py:278-284) in torch layout: the
    identity as a k x k grouped kernel, (features, in_g, k, k)."""
    ident = torch.zeros((features, in_g, k, k), device=device)
    ident[torch.arange(features), torch.arange(features) % in_g, k // 2, k // 2] = 1.0
    return ident


def apply_folded(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, *,
                 stride: int, padding: int, groups: int = 1) -> torch.Tensor:
    """``apply_folded`` (fastvit_fold.py:470-489): one conv in x's dtype, then
    the bias cast to that dtype."""
    y = F.conv2d(x, kernel.to(x.dtype), None, stride, padding, 1, groups)
    return y + bias.to(x.dtype).view(1, -1, 1, 1)


def cached_fold(owner: nn.Module, dtype: torch.dtype, build: Callable[[torch.dtype], Any],
                *others: nn.Module) -> Any:
    """``build(dtype)``, cached on ``owner`` and built anew when the dtype,
    the device or any parameter or buffer of ``owner`` and ``others``
    changes. Built as normal tensors without autograd even when first asked
    for under ``inference_mode``, so that later calls outside it can use
    them."""
    tensors = [t for m in (owner, *others) for t in (*m.parameters(), *m.buffers())]
    key = (dtype, tensors[0].device, tuple((t.data_ptr(), t._version) for t in tensors))
    hit = getattr(owner, "_fold_cache", None)
    if hit is None or hit[0] != key:
        with torch.inference_mode(False), torch.no_grad():
            hit = (key, build(dtype))
        owner._fold_cache = hit
    return hit[1]
