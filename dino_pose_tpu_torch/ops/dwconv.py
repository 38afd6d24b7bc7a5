"""FastViT's stride-1 depthwise convs and the RepMixer-combine + depthwise-conv
segment: the plain PyTorch versions, the CUDA kernel wrappers and their
autograd functions (counterpart of dino_pose_tpu/ops/dwconv.py).

========================  ==========================  =====================================
wrapper                   plain version               TPU kernel it replaces
========================  ==========================  =====================================
``fused_dw_conv``         ``dw_conv_math``            ``_dw_kernel`` (dwconv.py:54)
``fused_combine_dw``      ``combine_dw_math``         ``_combine_dw_fwd_kernel`` (dwconv.py:287)
``fused_combine_dw_bwd``  ``combine_dw_bwd_math``     ``_combine_dw_bwd_kernel`` (dwconv.py:310)
========================  ==========================  =====================================

Layouts are the JAX package's: activations (B, H, W, C) (NHWC, what a
channels_last NCHW tensor is in memory), conv kernels HWIO (k, k, 1, C),
per-channel vectors (C,) f32. The conv is a stride-1 SAME depthwise
(multiplier-1) cross-correlation with **f32 taps** and f32 sums, rounded once
to the activation dtype (``_tap_conv``): not the conv route's taps cast to
the compute dtype first (``models/fastvit_fold.dw_branch_conv``).

The segment (``combine_dw``) is the reuse-form RepMixer as a per-channel
affine followed by the ConvFFN's 7x7 depthwise conv::

    x2 = a*x + b*y0 + bias            (f32, rounded to x's dtype)
    y7 = dwconv(x2 as rounded)

and its backward, given the cotangents dx2bar of x2 and dy7bar of y7::

    dx2 = dx2bar + corr(dy7bar)       (f32; corr: the conv with flipped taps)
    dx = dx2*a, dy0 = dx2*b           (rounded)
    da, db, dbias = sums over B, H, W of dx2*x, dx2*y0, dx2   (f32)

The transpose of a stride-1 SAME conv is the same conv with its kernel
flipped in H and W (both frameworks cross-correlate), so ``dw_conv_frozen``'s
backward is ``fused_dw_conv`` on the flipped taps. The conv kernel gets a
zero gradient (JAX's frozen-backbone contract: no FastViT training mode
trains a backbone conv).

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel (``ops/csrc/dwconv_kernels.cu``) and adds one to
``LAUNCHES[<wrapper>]``, or raises; it never falls back.

The gates ``dwconv_enabled`` and ``pair_enabled`` are JAX's own switches
(``DINO_POSE_TPU_DWCONV``, ``DINO_POSE_TPU_STAGE_PAIR``), read at call time
as JAX reads them at trace time; unset they are off. ``force`` takes the arm
at any shape, as in JAX. **Departure:** JAX takes ``on`` only on a TPU;
here ``on`` applies JAX's TPU shape-and-fit window (C < 128, H % 8 == 0,
W*C % 128 == 0, and the VMEM byte models ``_dw_rows`` / ``_pair_rows``,
copied) to tensors on any device, so the CPU runs the plain versions on the
route the card takes.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from dino_pose_tpu_torch.ops import _ext

LAUNCHES = _ext.LAUNCHES

_SMEM_LIMIT = 232448   # bytes of shared memory one Hopper block may use
_TILE_TARGET = 100 * 1024  # tile bytes that leave room for two blocks an SM
_CHANNELS = 64         # channels a block takes at most (one thread each)
_ROWS = 8              # output rows of a block's strip, at most
KERNEL_SIZES = (3, 7)  # the kernel's template instances (FastViT's mixer and ConvFFN)

# ---------------------------------------------------------------------------
# The JAX package's VMEM byte models and gates (dwconv.py:130-146, 229-263,
# 360-373, 501-530), copied.

_DW_BUDGET = 9 * 1024 * 1024


def _dw_bytes(g: int, kk: int, h: int, wc: int, itemsize: int) -> int:
    hp = h + 2 * (kk // 2)
    streams = 2 * (2 * g * h * wc * itemsize)            # x in + out, 2x-buffered
    scratch = 2 * hp * wc * 4 + h * wc * 4               # xp + rm + acc refs
    temps = 4 * min(h, 16) * wc * 4                      # chunked chain live set
    consts = kk * kk * wc * 4
    return streams + scratch + temps + consts


def _dw_rows(kk: int, h: int, wc: int, itemsize: int, batch: int) -> int:
    for cand in (8, 4, 2, 1):
        if batch % cand == 0 and _dw_bytes(cand, kk, h, wc, itemsize) <= _DW_BUDGET:
            return cand
    return 0


def _pair_bytes(g: int, kk: int, h: int, wc: int, itemsize: int) -> int:
    hp = h + 2 * (kk // 2)
    streams = 4 * (2 * g * h * wc * itemsize)        # x, y0 in; x2, y7 out
    scratch = 2 * hp * wc * 4 + h * wc * 4
    temps = 2 * h * wc * 4 + 4 * min(h, 16) * wc * 4  # combine + chain chunks
    consts = (kk * kk + 3) * wc * 4
    return streams + scratch + temps + consts


def _pair_rows(kk: int, h: int, wc: int, itemsize: int, batch: int) -> int:
    for cand in (8, 4, 2, 1):
        if batch % cand == 0 and _pair_bytes(cand, kk, h, wc, itemsize) <= _DW_BUDGET:
            return cand
    return 0


def _window(env: str, c: int, h: int, w: int) -> bool | None:
    """None when ``env`` is off; else whether the shape is in the arm's
    window (always under ``force``)."""
    override = os.environ.get(env, "").lower()
    if override not in ("on", "force"):
        return None
    return override == "force" or (c < 128 and h % 8 == 0 and w * c % 128 == 0)


def dwconv_enabled(c: int, h: int, w: int, kk: int, itemsize: int,
                   batch: int | None = None) -> bool:
    """JAX's ``dwconv_enabled`` (dwconv.py:229): the depthwise-conv arm for a
    stride-1, multiplier-1 conv on a (batch, h, w, c) activation of
    ``itemsize`` bytes. ``DINO_POSE_TPU_DWCONV=on`` within the window and
    the byte model's fit, ``force`` at any shape the byte model fits."""
    if not _window("DINO_POSE_TPU_DWCONV", c, h, w):
        return False
    return _dw_rows(kk, h, w * c, itemsize, batch or 1) > 0


def pair_enabled(c: int, h: int, w: int, kk: int, itemsize: int,
                 batch: int | None = None) -> bool:
    """JAX's ``pair_enabled`` (dwconv.py:501): the fused combine + depthwise
    conv segment of a RepMixer + ConvFFN training block.
    ``DINO_POSE_TPU_STAGE_PAIR=on`` within the window and the fit."""
    if not _window("DINO_POSE_TPU_STAGE_PAIR", c, h, w):
        return False
    return _pair_rows(kk, h, w * c, itemsize, batch or 1) > 0


# ---------------------------------------------------------------------------
# Plain versions


def _conv_f32(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) f32: the stride-1 SAME depthwise conv of x (read as f32)
    with the f32 taps of the HWIO ``kernel``, unrounded."""
    kk, c = kernel.shape[0], x.shape[-1]
    w = kernel.float().permute(3, 2, 0, 1)  # (C, 1, k, k)
    return F.conv2d(x.float().permute(0, 3, 1, 2), w, None, 1, kk // 2, 1, c).permute(0, 2, 3, 1)


def dw_conv_math(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain version of ``_dw_kernel``: the conv in f32 on f32 taps, rounded
    to x's dtype."""
    return _conv_f32(x, kernel).to(x.dtype).contiguous()


def _combine(x, y0, a, b, bias) -> torch.Tensor:
    """x2 = a*x + b*y0 + bias in f32 (products rounded, left to right),
    rounded to x's dtype."""
    return (x.float() * a + y0.float() * b + bias).to(x.dtype)


def combine_dw_math(x, y0, a, b, bias, kernel) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``_combine_dw_fwd_kernel`` (dwconv.py:291-307): (x2,
    y7), the conv reading x2 as rounded."""
    x2 = _combine(x, y0, a, b, bias).contiguous()
    return x2, dw_conv_math(x2, kernel)


def combine_dw_bwd_math(x, y0, dx2bar, dy7bar, a, b, kernel):
    """Plain version of ``_combine_dw_bwd_kernel`` (dwconv.py:315-341):
    (dx, dy0, da, db, dbias); ``kernel`` is the forward's, flipped here.
    dx2 stays f32; dx and dy0 are rounded to x's dtype; the three (C,) sums
    are f32."""
    dx2 = dx2bar.float() + _conv_f32(dy7bar, kernel.flip(0, 1))
    dims = (0, 1, 2)
    return ((dx2 * a).to(x.dtype).contiguous(), (dx2 * b).to(x.dtype).contiguous(),
            (dx2 * x.float()).sum(dims), (dx2 * y0.float()).sum(dims), dx2.sum(dims))


def dwconv_cost(b: int, h: int, w: int, c: int, kk: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one conv: 2*k*k FLOPs an output (JAX's
    CostEstimate, dwconv.py:163); x read and the output written once in
    bf16, the f32 taps once. The FLOPs are f32 on the CUDA cores
    (``block.F32_FLOPS``)."""
    n = b * h * w * c
    return 2 * n * kk * kk, 2 * n * 2 + kk * kk * c * 4


def combine_dw_cost(b: int, h: int, w: int, c: int, kk: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one combine + conv: 2*(k*k + 2) FLOPs an output
    (JAX's CostEstimate, dwconv.py:393); x and y0 read, x2 and y7 written in
    bf16, the taps and a, b, bias once in f32."""
    n = b * h * w * c
    return 2 * n * (kk * kk + 2), 4 * n * 2 + (kk * kk + 3) * c * 4


def combine_dw_bwd_cost(b: int, h: int, w: int, c: int, kk: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward: the flipped conv (2*k*k an element),
    dx2's add, dx and dy0's products and the three sums (8); x, y0, dx2bar,
    dy7bar read and dx, dy0 written in bf16, the taps, a, b and the three
    f32 sums once."""
    n = b * h * w * c
    return n * (2 * kk * kk + 8), 6 * n * 2 + (kk * kk + 2) * c * 4 + 3 * c * 4


# ---------------------------------------------------------------------------
# Wrappers


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(name: str, kernel: torch.Tensor, *acts: torch.Tensor, vecs=()) -> tuple:
    """(B, H, W, C, k) after checking what the kernel takes."""
    x = acts[0]
    if any(t.dtype != torch.bfloat16 for t in acts):
        raise TypeError(f"{name}: the CUDA kernel takes bf16 activations, got "
                        f"{[str(t.dtype) for t in acts]}")
    if x.dim() != 4:
        raise ValueError(f"{name}: activations must be (B, H, W, C), got {tuple(x.shape)}")
    for t in acts:
        if (t.shape != x.shape or t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: activations must be contiguous, 16-byte aligned "
                             f"(B, H, W, C) tensors of one shape {tuple(x.shape)} on one device")
    b, h, w, c = x.shape
    kk = kernel.shape[0]
    if tuple(kernel.shape) != (kk, kk, 1, c) or kk not in KERNEL_SIZES:
        raise ValueError(f"{name}: kernel must be HWIO (k, k, 1, {c}) with k in {KERNEL_SIZES}, "
                         f"got {tuple(kernel.shape)}")
    for v in vecs:
        if tuple(v.shape) != (c,) or v.dtype != torch.float32 or v.device != x.device:
            raise ValueError(f"{name}: per-channel vectors must be f32 ({c},) on {x.device}")
    if kernel.device != x.device:
        raise ValueError(f"{name}: kernel on {kernel.device}, activations on {x.device}")
    return b, h, w, c, kk


def _taps(kernel: torch.Tensor) -> torch.Tensor:
    """The f32 tap table (k*k, C), row dh*k + dw."""
    kk, c = kernel.shape[0], kernel.shape[-1]
    return kernel.detach().float().reshape(kk * kk, c).contiguous()


def _plan(name: str, b: int, h: int, w: int, c: int, kk: int, dev: torch.device) -> tuple:
    """(rows a strip, channels a group, groups): groups of at most 64
    channels (one thread each; a multiple of 8 where C is, so that the tile
    is staged in 16-byte vectors); strips of 8 rows, halved while the grid
    would leave SMs idle or the zero-padded bf16 halo tile outgrows
    ``_TILE_TARGET`` (two blocks an SM)."""
    lib = _ext.lib()
    groups = -(-c // _CHANNELS)
    cg = -(-c // groups)
    if c % 8 == 0:  # groups of whole 16-byte vectors: the kernel's vector staging
        cg = -(-cg // 8) * 8
        groups = -(-c // cg)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    th = _ROWS
    while th > 1 and (b * -(-h // th) * groups < 2 * sms
                      or lib.dp_dw_smem_bytes(w, kk, th, cg) > _TILE_TARGET):
        th //= 2
    if lib.dp_dw_smem_bytes(w, kk, th, cg) > _SMEM_LIMIT:
        raise ValueError(f"{name}: rows of width W={w} do not fit shared memory at k={kk}")
    return th, cg, groups


def _launch_checks(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} has no backward of its own, and an operand requires grad: "
                         "dw_conv_frozen and combine_dw_frozen are the differentiable ones")


def fused_dw_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The stride-1 SAME depthwise conv of (B, H, W, C) x with the HWIO
    kernel's f32 taps; replaces ``_dw_kernel`` (dino_pose_tpu/ops/dwconv.py:54,
    body ``_tap_conv`` :75, via ``dw_conv_frozen`` :174).

    Design (``dw_kernel<K, DW>``): one block per (sample, strip of up to 8
    rows, group of up to 64 channels); the strip and its k-1 halo rows and
    columns, zero-padded, are staged once in shared memory in bf16 (exact:
    x is bf16); one thread per channel walks 8 outputs along W at a time,
    keeping its channel's k*k f32 taps and a row of the window in
    registers, f32 sums, one rounding. The TPU kernel's lane-packed (H, W*C)
    view and its lane rolls exist for the 128-wide vector unit; here
    neighbouring threads take neighbouring channels, which is NHWC's
    contiguous axis. Any H and W (the TPU kernel's 16-row chunks fail at
    H > 16, H % 16 != 0).

    Bound on an H100: 2*k*k FLOPs an output in f32 at 67 TFLOP/s, or x and
    the output (bf16) at 3.35 TB/s; ``dwconv_cost`` counts both."""
    name = "fused_dw_conv"
    if x.device.type == "cpu":
        return dw_conv_math(x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _launch_checks(name, x, kernel)
    b, h, w, c, kk = _check(name, kernel, x)
    th, cg, groups = _plan(name, b, h, w, c, kk, x.device)
    taps, out = _taps(kernel), torch.empty_like(x)
    err = _ext.lib().dp_dw_conv(x.data_ptr(), taps.data_ptr(), out.data_ptr(),
                                b, h, w, c, kk, th, cg, groups, _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return out


def fused_combine_dw(x, y0, a, b, bias, kernel) -> tuple[torch.Tensor, torch.Tensor]:
    """(x2, y7) = (bf16(a*x + b*y0 + bias), dwconv(x2)) over (B, H, W, C);
    replaces ``_combine_dw_fwd_kernel`` (dino_pose_tpu/ops/dwconv.py:287, via
    ``combine_dw_frozen`` :407).

    Design (``dw_kernel<K, COMBINE>``): ``fused_dw_conv``'s block with a
    prologue: while staging the tile it forms x2 in f32 from x, y0 and the
    per-channel a, b, bias, rounds it to bf16, writes the strip's own rows
    of x2 once and keeps the rounded values (halo rows recomputed by each
    neighbouring strip the same way) for the conv, so the conv reads x2 as
    rounded (dwconv.py:299-303) and x2 makes no extra round trip through
    device memory. The zero padding is x2's, not x's.

    Bound on an H100: 2*(k*k + 2) FLOPs an output in f32 at 67 TFLOP/s, or
    x, y0, x2, y7 (bf16) at 3.35 TB/s; ``combine_dw_cost`` counts both."""
    name = "fused_combine_dw"
    if x.device.type == "cpu":
        return combine_dw_math(x, y0, a, b, bias, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _launch_checks(name, x, y0, a, b, bias, kernel)
    bsz, h, w, c, kk = _check(name, kernel, x, y0, vecs=(a, b, bias))
    th, cg, groups = _plan(name, bsz, h, w, c, kk, x.device)
    taps, x2, y7 = _taps(kernel), torch.empty_like(x), torch.empty_like(x)
    err = _ext.lib().dp_combine_dw(*(t.data_ptr() for t in (x, y0, a, b, bias, taps, x2, y7)),
                                   bsz, h, w, c, kk, th, cg, groups, _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return x2, y7


def fused_combine_dw_bwd(x, y0, dx2bar, dy7bar, a, b, kernel):
    """(dx, dy0, da, db, dbias) of the combine + conv segment; replaces
    ``_combine_dw_bwd_kernel`` (dino_pose_tpu/ops/dwconv.py:310, via
    ``_combine_dw_vjp_bwd`` :419). ``kernel`` is the forward's (flipped
    here, as JAX's ``_prep_taps(jnp.flip(kernel, (0, 1)))``).

    Design (``dw_kernel<K, COMBINE_BWD>``): ``fused_dw_conv``'s block on
    dy7bar with the flipped taps; per output dx2 = dx2bar + the conv (f32),
    dx and dy0 written once, and the thread's f32 sums of dx2*x, dx2*y0 and
    dx2; the block sums its threads' sums in a fixed order into its own
    slot, and ``dw_sums_reduce_kernel`` (same C entry) adds the slots in
    block order. No atomics: the TPU grid's sequential VMEM accumulation
    becomes a second pass, and the same inputs give the same bits.

    Bound on an H100: (2*k*k + 8) FLOPs an element in f32 at 67 TFLOP/s, or
    x, y0, dx2bar, dy7bar, dx, dy0 (bf16) at 3.35 TB/s;
    ``combine_dw_bwd_cost`` counts both."""
    name = "fused_combine_dw_bwd"
    if x.device.type == "cpu":
        return combine_dw_bwd_math(x, y0, dx2bar, dy7bar, a, b, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    bsz, h, w, c, kk = _check(name, kernel, x, y0, dx2bar, dy7bar, vecs=(a, b))
    th, cg, groups = _plan(name, bsz, h, w, c, kk, x.device)
    slots = bsz * -(-h // th)
    taps = _taps(kernel.flip(0, 1))
    dx, dy0 = torch.empty_like(x), torch.empty_like(x)
    partials = torch.empty((slots, 3, c), dtype=torch.float32, device=x.device)
    sums = torch.empty((3, c), dtype=torch.float32, device=x.device)
    err = _ext.lib().dp_combine_dw_bwd(
        *(t.data_ptr() for t in (x, y0, dx2bar, dy7bar, a, b, taps, dx, dy0, partials, sums)),
        bsz, h, w, c, kk, th, cg, groups, _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return dx, dy0, sums[0], sums[1], sums[2]


# ---------------------------------------------------------------------------
# Autograd functions


class _DWConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, kernels):
        ctx.save_for_backward(kernel)
        ctx.kernels = kernels
        return (fused_dw_conv if kernels else dw_conv_math)(x, kernel.detach())

    @staticmethod
    def backward(ctx, dy):
        (kernel,) = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            conv = fused_dw_conv if ctx.kernels else dw_conv_math
            dx = conv(dy.contiguous(), kernel.detach().flip(0, 1))
        return dx, torch.zeros_like(kernel) if ctx.needs_input_grad[1] else None, None


def dw_conv_frozen(x: torch.Tensor, kernel: torch.Tensor, *, kernels: bool = True) -> torch.Tensor:
    """JAX's ``dw_conv_frozen`` (dwconv.py:174) under autograd: the conv of
    (B, H, W, C) x with the HWIO kernel (f32 taps), dx the conv of the
    cotangent with the flipped kernel, the kernel's gradient zero. Forward
    and dx through ``fused_dw_conv`` (``kernels=False``: ``dw_conv_math``,
    on any device)."""
    return _DWConv.apply(x.contiguous(), kernel, kernels)


class _CombineDW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y0, a, b, bias, kernel, kernels):
        ctx.save_for_backward(x, y0, a, b, kernel)
        ctx.kernels = kernels
        fwd = fused_combine_dw if kernels else combine_dw_math
        return fwd(x, y0, a.detach(), b.detach(), bias.detach(), kernel.detach())

    @staticmethod
    def backward(ctx, dx2bar, dy7bar):
        x, y0, a, b, kernel = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = [None] * 5
        if any(need[:5]):
            bwd = fused_combine_dw_bwd if ctx.kernels else combine_dw_bwd_math
            grads = bwd(x, y0, dx2bar.to(x.dtype).contiguous(), dy7bar.to(x.dtype).contiguous(),
                        a.detach(), b.detach(), kernel.detach())
            grads = [g if n else None for g, n in zip(grads, need[:5])]
        return (*grads, torch.zeros_like(kernel) if need[5] else None, None)


def combine_dw_frozen(x, y0, a, b, bias, kernel, *, kernels: bool = True):
    """JAX's ``combine_dw_frozen`` (dwconv.py:407) under autograd: (x2, y7)
    from (B, H, W, C) x and y0, (C,) f32 a, b, bias and the HWIO kernel,
    differentiable in x, y0, a, b and bias, the kernel's gradient zero.
    Forward ``fused_combine_dw``, backward ``fused_combine_dw_bwd``
    (``kernels=False``: the plain versions, on any device)."""
    return _CombineDW.apply(x.contiguous(), y0.contiguous(), a, b, bias, kernel, kernels)
