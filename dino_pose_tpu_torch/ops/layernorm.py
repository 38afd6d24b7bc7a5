"""LayerNorm with a hand-written forward kernel (counterpart of
dino_pose_tpu/ops/layernorm.py).

===================  =========================  =================================
wrapper              plain version              TPU kernel it replaces
===================  =========================  =================================
``fused_layernorm``  ``layernorm_reference``    ``_ln_kernel`` (layernorm.py:36)
===================  =========================  =================================

The JAX package reaches it behind ``DINO_POSE_TPU_LN=pallas``
(``nn/layers.py:253``), and only in one module: the ViT's final norm (the
blocks' LayerNorms live inside the block kernels). ``models/vit.py`` reads
the same switch at call time. The forward is ``ln_fwd_kernel`` of
``ops/csrc/layernorm_kernels.cu``; the backward is autograd of the plain
formula recomputed from the saved input, JAX's contract (its ``_bwd`` is
``jax.vjp`` of ``layernorm_reference``), so no kernel runs there.

On a CPU tensor the forward is the plain version; on a CUDA tensor it
launches the kernel or raises, and each launch adds one to
``LAUNCHES["fused_layernorm"]``.
"""

from __future__ import annotations

import torch

from dino_pose_tpu_torch.nn.layers import layer_norm
from dino_pose_tpu_torch.ops import _ext

LAUNCHES = _ext.LAUNCHES
# The widest row ln_fwd_kernel takes: 128 threads x 4 chunks of 8 values
# (THREADS * MAX_CHUNKS * VEC in layernorm_kernels.cu, which refuses wider).
MAX_WIDTH = 4096


def layernorm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """The plain version: f32 mean and variance, the affine in f32, one
    rounding to x's dtype (``nn/layers.layer_norm``)."""
    return layer_norm(x, scale, bias, eps)


# The checked f32 (scale, bias) of the last few parameter pairs, by the pair's
# identity: (scale, bias, their _version counters, D, device, f32 scale,
# f32 bias). An in-place update moves a tensor's _version, and the pair is
# checked and converted again.
_PARAMS: dict = {}


def _checked_params(scale: torch.Tensor, bias: torch.Tensor, d: int,
                    device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 contiguous views of ``scale`` and ``bias`` after checking that
    they are (d,) tensors on ``device``, 16-byte aligned; checked and
    converted once per (tensor, version) and then reused."""
    key = (id(scale), id(bias))
    hit = _PARAMS.get(key)
    if (hit is not None and hit[0] is scale and hit[1] is bias and hit[2] == scale._version
            and hit[3] == bias._version and hit[4] == d and hit[5] == device):
        return hit[6], hit[7]
    s32, b32 = (t.detach().to(torch.float32).contiguous() for t in (scale, bias))
    for t in (s32, b32):
        if t.shape != (d,) or t.device != device or t.data_ptr() % 16:
            raise ValueError(f"fused_layernorm: scale and bias must be ({d},) tensors on "
                             f"{device}")
    if len(_PARAMS) >= 8:
        _PARAMS.clear()
    _PARAMS[key] = (scale, bias, scale._version, bias._version, d, device, s32, b32)
    return s32, b32


def check_operands(x: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> tuple[int, torch.Tensor, torch.Tensor]:
    """(D, f32 scale, f32 bias) after checking what ``ln_fwd_kernel`` takes
    (bf16 or f32 rows of a multiple of 8 up to ``MAX_WIDTH``, contiguous
    and 16-byte aligned; scale and bias (D,) on x's device); raises on
    anything else. Runs on any device: the wrapper calls it for CUDA
    tensors only."""
    name = "fused_layernorm"
    if x.dtype is not torch.bfloat16 and x.dtype is not torch.float32:
        raise TypeError(f"{name}: the kernel takes bf16 or f32 rows, got {x.dtype}")
    d = x.shape[-1]
    if d % 8 or d > MAX_WIDTH:
        raise ValueError(f"{name}: width {d} is not a multiple of 8 up to {MAX_WIDTH}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")
    return (d, *_checked_params(scale, bias, d, x.device))


def _ln_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """The forward of ``fused_layernorm``: the plain version on the CPU, the
    kernel on a CUDA tensor.

    Design: one warp a row up to D = 1024 (a block a row up to 4096), the
    row held in registers as 16-byte chunks, so that it is read once and
    both passes (mean, then squared deviations) run in registers; f32
    statistics, the affine in f32, one rounding. A block takes four rows,
    or two or one where the grid would otherwise leave SMs idle (small row
    counts: 257 rows, two a block, 129 blocks). The TPU kernel's 512-row
    programs and zero-row padding have no counterpart: rows are independent
    and any count is taken. Host side: scale and bias are checked and
    converted once per version (``check_operands``), one ctypes call.
    Bound on an H100: the bytes, rows*D*2*itemsize + 2*D*4 at 3.35 TB/s
    (15.1 us at dinov2-small's 128 x 257 rows in bf16)."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return layernorm_reference(x, scale, bias, eps)
        raise ValueError(f"fused_layernorm: unsupported device {x.device}")
    d, s32, b32 = check_operands(x, scale, bias)
    y = torch.empty_like(x)
    err = _ext.lib().dp_layernorm(
        x.data_ptr(), s32.data_ptr(), b32.data_ptr(), y.data_ptr(), x.numel() // d, d,
        x.dtype is torch.float32, eps, _ext.stream(x.get_device()))
    _ext.check(err, "fused_layernorm")
    LAUNCHES["fused_layernorm"] += 1
    return y


class _FusedLayerNorm(torch.autograd.Function):
    """Forward ``_ln_forward``; backward autograd of ``layernorm_reference``
    recomputed from the saved (x, scale, bias), as JAX's ``_bwd``."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps
        return _ln_forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((x, scale, bias), ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        if not wanted:
            return None, None, None, None
        with torch.enable_grad():
            y = layernorm_reference(*inputs, ctx.eps)
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None)


def fused_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics and output in x's
    dtype; replaces ``_ln_kernel`` (dino_pose_tpu/ops/layernorm.py:36,
    through ``fused_layernorm`` :72): the forward a kernel on the card, the
    backward autograd of the plain formula. Where no gradient is wanted the
    forward runs without the autograd function around it."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _FusedLayerNorm.apply(x, scale, bias, eps)
    return _ln_forward(x, scale, bias, eps)


def layernorm_cost(rows: int, d: int, itemsize: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one ``fused_layernorm`` forward: about eight f32
    operations a value (two sums, the square, the normalisation and the
    affine), each row read and written once, f32 scale and bias read once."""
    return 8 * rows * d, rows * d * 2 * itemsize + 2 * d * 4
