"""Reparameterisation algebra of the FastViT blocks (counterpart of
dino_pose_tpu/models/fastvit_fold.py): eval folds and train-time statistics.

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
``models/vit.py`` caches its packed block weights). They are built without
autograd, so it refuses a module whose parameter requires grad while grad
mode is on: a cached copy would cut that gradient silently.

In train mode a BatchNorm is still an affine map once its batch statistics
are known: ``bn_train_affine`` gives the differentiable (inv, shift) of
``BNAffine`` (fastvit_fold.py:197-243) and updates the running statistics,
from ``branch_stats`` of a materialised branch output (two-pass) or from
``channel_moments`` of the input (one-pass, on the strided grid) for the
branches whose statistics are functions of x. The blocks combine them as
JAX's switches say, read at each call (``fold_enabled``,
``train_block_mode``, ``block_fold_active``, ``block_reuse_active``,
``ffn_fold_active``; fastvit_fold.py:66-130): in the reuse arrangement
(JAX's default, ``stats_branch_reuse``), as the train-time fold (one conv
whose kernel depends on x through the batch statistics,
``fold_stats_branch``), or as the reference's branch math; in training
never through the cache, which would cut the kernel's gradient.

JAX's ``DINO_POSE_TPU_DS_BWD`` chooses between two backwards of one
function: ``_dw_s2_conv_frozen`` only works around an XLA layout of the
stride-2 depthwise conv's dx, and returns a zero kernel cotangent. The port
reads nothing: its function is ``dw_branch_conv``'s conv, whose autograd
gives the same dx (the kernel is frozen in every FastViT training mode). A
stride-1 multiplier-1 depthwise conv takes JAX's opt-in depthwise-conv arm
when ``ops/dwconv.dwconv_enabled`` passes (``DINO_POSE_TPU_DWCONV``;
``dw_route``): ``dw_conv_frozen``, f32 taps.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn

from dino_pose_tpu_torch.core import distributed
from dino_pose_tpu_torch.nn.layers import update_running_stats
from dino_pose_tpu_torch.ops.dwconv import dw_conv_frozen, dwconv_enabled


def fold_enabled() -> bool:
    """JAX's master gate (fastvit_fold.py:66-69):
    ``DINO_POSE_TPU_FASTVIT_FOLD=0`` forces the reference's literal branch
    math everywhere, in train and in eval."""
    return os.environ.get("DINO_POSE_TPU_FASTVIT_FOLD", "1") != "0"


def train_block_mode() -> str:
    """The train-mode math of the MobileOne family (MobileOneBlock,
    ReparamLargeKernelConv, RepMixer), ``DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS``
    (fastvit_fold.py:72-100): ``reuse`` (the default), ``fold`` or
    ``branch``; any other value raises JAX's ``ValueError``."""
    mode = os.environ.get("DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS", "reuse").lower()
    if mode not in ("branch", "fold", "reuse"):
        raise ValueError(
            f"DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS={mode!r}: expected branch|fold|reuse"
        )
    return mode


def block_fold_active(train: bool) -> bool:
    """Whether the MobileOne family takes its folded or reuse form
    (fastvit_fold.py:103-107): in eval while the fold is on, in training
    unless the mode is ``branch``."""
    if not fold_enabled():
        return False
    return (not train) or train_block_mode() != "branch"


def block_reuse_active(train: bool) -> bool:
    """Within the folded forms, whether training reuses the branch outputs
    (fastvit_fold.py:110-112)."""
    return train and train_block_mode() == "reuse"


def ffn_fold_active(train: bool) -> bool:
    """JAX's fold gate of the BatchNorm-into-matmul sites (fastvit_fold.py:
    115-130: SpatialAttention's qkv, the ConvFFN's fc1): on in eval while
    the fold is on; in training only under
    ``DINO_POSE_TPU_FASTVIT_TRAIN_FFN=fold``."""
    if not fold_enabled():
        return False
    if not train:
        return True
    return os.environ.get("DINO_POSE_TPU_FASTVIT_TRAIN_FFN", "branch").lower() == "fold"


def bn_affine(bn: nn.BatchNorm2d) -> tuple[torch.Tensor, torch.Tensor]:
    """``BNAffine`` in eval (fastvit_fold.py:197-243): f32 (inv, shift) from
    the running statistics, inv = rsqrt(var + eps) * scale."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    return inv, bn.bias.float() - bn.running_mean.float() * inv


def bn_train_affine(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor,
                    n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``BNAffine`` in train mode: f32 (inv, shift) from the batch's (mean,
    biased var) over ``n`` positions, differentiable through both, and the
    running update in place (``nn/layers.update_running_stats``)."""
    update_running_stats(bn, mean, var, n)
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    return inv, bn.bias - mean * inv


def channel_moments(x: torch.Tensor, stride: int = 1) -> tuple[torch.Tensor, torch.Tensor, int]:
    """f32 per-channel (mean, mean of squares, count) of NCHW ``x`` over the
    stride-sampled positions (fastvit_fold.py:246-262): one pass, var =
    m2 - mean^2. Under a data axis across ranks both means and the count
    are the global batch's (``core/distributed.data_mean``)."""
    if stride != 1:
        x = x[:, :, ::stride, ::stride]
    xf = x.float()
    return (distributed.data_mean(xf, (0, 2, 3)), distributed.data_mean(xf.square(), (0, 2, 3)),
            distributed.data_count(x.numel() // x.shape[1]))


def branch_stats(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """f32 (mean, biased var, count) of a materialised branch output,
    two-pass (fastvit_fold.py:265-275); under a data axis across ranks the
    global batch's, the global mean taken before the second pass."""
    yf = y.float()
    mean = distributed.data_mean(yf, (0, 2, 3))
    var = distributed.data_mean((yf - mean.view(1, -1, 1, 1)).square(), (0, 2, 3))
    return mean, var, distributed.data_count(y.numel() // y.shape[1])


def dw_route(x: torch.Tensor, kernel: torch.Tensor, stride: int, groups: int) -> bool:
    """JAX's routing test for the depthwise-conv arm (fastvit_fold.py:424-432):
    a stride-1, multiplier-1 depthwise conv of NCHW ``x`` with a torch-layout
    (C, 1, k, k) ``kernel``, where ``dwconv_enabled`` passes."""
    b, c, h, w = x.shape
    return (stride == 1 and kernel.shape[1] == 1 and groups == c == kernel.shape[0]
            and dwconv_enabled(c, h, w, kernel.shape[-1], x.element_size(), batch=b))


def dw_arm_conv(x: torch.Tensor, kernel: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """The depthwise-conv arm on NCHW ``x`` (channels_last: NHWC in memory)
    with the torch-layout kernel as JAX's HWIO taps, in f32:
    ``ops/dwconv.dw_conv_frozen``, the result NCHW in channels_last memory."""
    out = dw_conv_frozen(x.permute(0, 2, 3, 1), kernel.permute(2, 3, 1, 0), kernels=kernels)
    return out.permute(0, 3, 1, 2)


def dw_branch_conv(x: torch.Tensor, kernel: torch.Tensor, stride: int, groups: int,
                   kernels: bool = True) -> torch.Tensor:
    """One branch conv in x's dtype, padded to half its kernel, no bias
    (fastvit_fold.py:411-447); ``dw_arm_conv`` where ``dw_route`` passes
    (f32 taps, ``kernels`` choosing the kernel or its plain version). The
    JAX package routes the stride-2 depthwise(-multiplier) case through
    ``_dw_s2_conv_frozen`` (XLA forward, a parity-decomposed dx, zero kernel
    cotangent); its function is this conv, and autograd gives the same dx
    for a frozen kernel."""
    if dw_route(x, kernel, stride, groups):
        return dw_arm_conv(x, kernel, kernels)
    k = kernel.shape[-1]
    return F.conv2d(x, kernel.to(x.dtype), None, stride, k // 2, 1, groups)


def stats_branch_reuse(x: torch.Tensor, kernel: torch.Tensor, bn: nn.BatchNorm2d, *,
                       stride: int, groups: int,
                       kernels: bool = True) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A train-mode (conv, BN) branch with its output reused
    (fastvit_fold.py:450-467): (y, inv, shift), the caller adding
    ``y * inv + shift`` elementwise."""
    y = dw_branch_conv(x, kernel, stride, groups, kernels)
    mean, var, n = branch_stats(y)
    inv, shift = bn_train_affine(bn, mean, var, n)
    return y, inv, shift


def fold_term(weight: torch.Tensor, inv: torch.Tensor, k: int) -> torch.Tensor:
    """A branch's torch-layout kernel scaled by its BatchNorm's per-output
    ``inv`` in f32, zero-padded to k x k at the centre (both convs pad to
    half their kernel, so the offsets align)."""
    term = weight.float() * inv.view(-1, 1, 1, 1)
    lo = (k - weight.shape[-1]) // 2
    hi = k - weight.shape[-1] - lo
    return F.pad(term, (lo, hi, lo, hi))


def fold_branch(weight: torch.Tensor, bn: nn.BatchNorm2d, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``fold_stats_branch`` in eval (fastvit_fold.py:287-325): a (conv, BN)
    branch as an f32 (kernel term zero-padded to k x k at the centre, bias
    term)."""
    inv, shift = bn_affine(bn)
    return fold_term(weight, inv, k), shift


def fold_stats_branch(x: torch.Tensor, weight: torch.Tensor, bn: nn.BatchNorm2d, k: int, *,
                      stride: int, groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``fold_stats_branch`` in training (fastvit_fold.py:287-325): the
    branch conv runs in x's dtype only for its batch statistics
    (``branch_stats``, two-pass; ``F.conv2d``, as JAX's ``lax.conv`` there
    takes no depthwise-conv arm), and the branch comes back as the f32
    (``fold_term`` on the batch-statistics inv, shift), differentiable in x
    through those statistics; the running statistics update."""
    y = F.conv2d(x, weight.to(x.dtype), None, stride, weight.shape[-1] // 2, 1, groups)
    mean, var, n = branch_stats(y)
    inv, shift = bn_train_affine(bn, mean, var, n)
    return fold_term(weight, inv, k), shift


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


def frozen_tensors(owner: nn.Module, *others: nn.Module) -> list[torch.Tensor]:
    """Every parameter and buffer of ``owner`` and ``others``; raises while
    grad mode is on if a parameter requires grad, since the eval forms run
    their kernels without autograd and would cut its gradient."""
    tensors = [t for m in (owner, *others) for t in (*m.parameters(), *m.buffers())]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{type(owner).__name__}: a parameter requires grad, but the folded copies are "
            "built without autograd and would cut its gradient; freeze it (train/partition.py)")
    return tensors


def cached_fold(owner: nn.Module, dtype: torch.dtype, build: Callable[[torch.dtype], Any],
                *others: nn.Module) -> Any:
    """``build(dtype)``, cached on ``owner`` and built anew when the dtype,
    the device or any parameter or buffer of ``owner`` and ``others``
    changes. Built as normal tensors without autograd even when first asked
    for under ``inference_mode``, so that later calls outside it can use
    them."""
    tensors = frozen_tensors(owner, *others)
    key = (dtype, tensors[0].device, tuple((t.data_ptr(), t._version) for t in tensors))
    hit = getattr(owner, "_fold_cache", None)
    if hit is None or hit[0] != key:
        with torch.inference_mode(False), torch.no_grad():
            hit = (key, build(dtype))
        owner._fold_cache = hit
    return hit[1]
