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
backward is ``fused_dw_conv(..., flip=True)``, whose kernel reads the taps
mirrored (no flipped copy is made). The conv kernel gets a
zero gradient (JAX's frozen-backbone contract: no FastViT training mode
trains a backbone conv).

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel (``ops/csrc/dwconv_kernels.cu``: ``dw_kernel<K, RB>``
for the conv, ``pair_kernel<K, BWD>`` for the segment) and adds one to
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

import ctypes
import functools
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dino_pose_tpu_torch.ops import _ext

LAUNCHES = _ext.LAUNCHES

_SMEM_LIMIT = 232448   # bytes of shared memory one Hopper block may use
_SMEM_BUDGET = 233472 // 2 - 1024  # two blocks in an SM's 228 KB (1 KB reserved each)
_CHANNELS = 64         # channels of a group, at most
_ROWS, _COLS = 16, 64  # output rows of a strip and columns of a tile, at most
_TW = 8                # output columns of a thread's slot (TW in the kernel)
_THREADS = 192         # threads of a block, at most (MAX_THREADS)
KERNEL_SIZES = (3, 7)  # the kernel's template instances (FastViT's mixer and ConvFFN)
# pair_kernel (the segment): rows of a ring stage and of an output step
# (RB), threads a block aims at, ring depths tried (MAX_STAGES first), and
# by direction the output columns of a thread's slot (TWT) and the channels
# of a group at most: the forward 8 and 64 (two blocks an SM), the backward
# 16 and 96 (one block an SM at up to 255 registers a thread).
PAIR_RB = 2
_PAIR_THREADS = 192
_PAIR_STAGES = (4, 3, 2)
PAIR_TW = {False: 8, True: 16}
_PAIR_CG = {False: 64, True: 96}

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


def dw_conv_math(x: torch.Tensor, kernel: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """Plain version of ``_dw_kernel``: the conv in f32 on f32 taps (mirrored
    in H and W where ``flip``: the conv's transpose), rounded to x's
    dtype."""
    return _conv_f32(x, kernel.flip(0, 1) if flip else kernel).to(x.dtype).contiguous()


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

# The launches a plan is made for: dw_kernel (the conv) and pair_kernel's
# forward and backward (the segment).
DW, COMBINE, COMBINE_BWD = 0, 1, 2


def _check(name: str, kernel: torch.Tensor, *acts: torch.Tensor, vecs=()) -> tuple:
    """(B, H, W, C, k) after checking what the kernel takes; runs on any
    device (the wrappers call it for CUDA tensors only)."""
    x = acts[0]
    shape, dev = x.shape, x.get_device()
    for t in acts:
        if t.dtype is not torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bf16 activations, got "
                            f"{[str(t.dtype) for t in acts]}")
        if (t.shape != shape or t.get_device() != dev or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: activations must be contiguous, 16-byte aligned "
                             f"(B, H, W, C) tensors of one shape {tuple(shape)} on one device")
    if len(shape) != 4:
        raise ValueError(f"{name}: activations must be (B, H, W, C), got {tuple(shape)}")
    b, h, w, c = shape
    kk = kernel.shape[0]
    if kernel.shape != (kk, kk, 1, c) or kk not in KERNEL_SIZES:
        raise ValueError(f"{name}: kernel must be HWIO (k, k, 1, {c}) with k in {KERNEL_SIZES}, "
                         f"got {tuple(kernel.shape)}")
    for v in vecs:
        if v.shape != (c,) or v.dtype is not torch.float32 or v.get_device() != dev:
            raise ValueError(f"{name}: per-channel vectors must be f32 ({c},) on {x.device}")
    if kernel.get_device() != dev:
        raise ValueError(f"{name}: kernel on {kernel.device}, activations on {x.device}")
    return b, h, w, c, kk


def _taps(kernel: torch.Tensor) -> torch.Tensor:
    """The f32 tap table (k*k, C), row dh*k + dw: the HWIO kernel itself
    where it is f32 and contiguous (its memory is that table), else a
    copy."""
    if kernel.dtype == torch.float32 and kernel.is_contiguous():
        return kernel
    return kernel.detach().float().contiguous()


class Plan(NamedTuple):
    """A launch of dw_kernel (DW) or pair_kernel (COMBINE, COMBINE_BWD):
    strips (pair: bands) of ``th`` output rows, column tiles of ``twc``
    columns, groups of ``cg`` channels, ``nt`` threads a block, ``grid`` persistent blocks
    over ``items`` tiles; ``smem`` bytes a block; ``rb`` output rows a
    thread's slot (pair: rows a step); ``stages`` tile buffers (pair: the
    TMA ring's depth); ``tw`` output columns a thread's slot. ``packed``
    holds the C entries' first argument, at address ``addr``: (B, H, W, C,
    k, th, twc, cg, nt, grid, rb) for DW, (B, H, W, C, k, cg, twc, th, nt,
    stages, grid, tw) for the pair."""
    th: int
    twc: int
    cg: int
    nt: int
    grid: int
    items: int
    smem: int
    rb: int
    stages: int
    tw: int
    packed: ctypes.Array
    addr: int


def _layout_elems(th: int, twc: int, kk: int, cg: int) -> int:
    """bf16 elements of one tile (``Layout`` in dwconv_kernels.cu): pixels
    of the group's channels rounded up to even, 8-pixel chunks padded by
    (-7*np) mod 32 four-byte words (np channel pairs), rows of whole
    chunks."""
    ps = cg + (cg & 1)
    cs = 8 * ps + 2 * ((-7 * (ps // 2)) % 32)
    return (th + kk - 1) * -(-(twc + kk - 1) // _TW) * cs


def _cdiv(n: int, d: int) -> int:
    return -(-n // d)


def _a128(n: int) -> int:
    return _cdiv(n, 128) * 128


def _smem_bytes(th: int, twc: int, kk: int, cg: int) -> int:
    """Shared-memory bytes of a dw_kernel block (``smem_bytes`` in
    dwconv_kernels.cu): two tile buffers."""
    return 2 * _a128(2 * _layout_elems(th, twc, kk, cg))


def _pair_smem(kk: int, bwd: bool, cg: int, twc: int, stages: int, c: int) -> int:
    """Shared-memory bytes of a pair_kernel block (``PairLayout`` in
    dwconv_kernels.cu): barriers, the group's a, b, bias, backward the
    block's (3, C) sums; ``stages`` TMA stages (forward x and y0 boxes of PAIR_RB rows with the
    k - 1 column halo; backward dy7bar's with it and dx2bar's, x's, y0's
    without); the f32 conv ring of PAIR_RB + k - 1 rows of 8-pixel chunks,
    each CG words modulo the 32 banks (the last chunk unpadded)."""
    cols = twc + kk - 1
    chunk = 8 * cg + (-7 * cg) % 32
    halo, own = _a128(PAIR_RB * cols * cg * 2), _a128(PAIR_RB * twc * cg * 2)
    stage = halo + 3 * own if bwd else 2 * halo
    head = 128 + _a128(3 * cg * 4) + (_a128(3 * c * 4) if bwd else 0)
    row = (cols - 1) // 8 * chunk + ((cols - 1) % 8 + 1) * cg
    return head + stages * stage + (PAIR_RB + kk - 1) * row * 4


def _groups(c: int) -> tuple[int, int]:
    """(channels a group, groups): groups of at most 64 channels, whole
    16-byte vectors (multiples of 8) where C is a multiple of 8, even
    where C is even (the kernel's bf16x2 pairs)."""
    groups = -(-c // _CHANNELS)
    cg = -(-c // groups)
    step = 8 if c % 8 == 0 else 2 if c % 2 == 0 else 1
    cg = -(-cg // step) * step
    return cg, -(-c // cg)


def _threads(cg: int, th: int, twc: int, rb: int) -> int:
    """Threads of a block: a multiple of the group's channel pairs (a
    thread keeps one pair), as many (rb-row, 8-column) slots at once as
    divide the item's slots evenly, at most 192."""
    np_ = (cg + 1) // 2
    slots = th // rb * (twc // _TW)
    return np_ * max(m for m in range(1, slots + 1) if slots % m == 0 and np_ * m <= _THREADS)


def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _occupancy(kk: int, mode: int, depth: int, plan: tuple) -> int:
    """Blocks of the plan an SM holds at once (``dp_dw_occupancy``,
    ``dp_pair_occupancy``), after checking the plan's shared-memory bytes
    against the kernel's own formula. DW: ``depth`` rows a slot, ``plan``
    (th, twc, cg, nt, smem); the pair: ``depth`` ring stages, ``plan`` (cg,
    twc, C, threads, smem)."""
    lib = _ext.lib()
    if mode == DW:
        th, twc, cg, nt, smem = plan
        if lib.dp_dw_smem_bytes(th, twc, kk, cg) != smem:
            raise RuntimeError("dwconv: _smem_bytes disagrees with dp_dw_smem_bytes")
        return lib.dp_dw_occupancy(kk, depth, nt, smem)
    cg, twc, c, nc, smem = plan
    bwd = mode == COMBINE_BWD
    if lib.dp_pair_smem(kk, int(bwd), cg, twc, depth, c) != smem:
        raise RuntimeError("dwconv: _pair_smem disagrees with dp_pair_smem")
    return lib.dp_pair_occupancy(kk, int(bwd), PAIR_TW[bwd], nc, smem)


@functools.lru_cache(maxsize=256)
def _plan(b: int, h: int, w: int, c: int, kk: int, mode: int, device: int) -> Plan:
    """The launch plan of a shape and mode, cached (the pair's:
    ``_pair_plan``). dw_kernel's items of (sample, strip, column tile,
    channel group) start at 16 rows x 64 columns; while the grid
    would leave an SM without an item, the column tile halves (to 8) while
    it is wider than twice the strip, else the strip halves (to 2): at
    batch 1 the card fills with tiles of several rows rather than with
    one-row strips. Then, until a block's shared memory fits
    ``_SMEM_BUDGET`` (two blocks an SM), the column tile halves to 16, then
    the strip to 2, then the tile to 8. A thread's slot takes two output
    rows where whole strips alone fill the card (each window row feeds
    both), else one (a shorter chain a thread where the grid is small).
    The grid is as many persistent blocks as the card holds at once, at
    most one an item."""
    if mode != DW:
        return _pair_plan(b, h, w, c, kk, mode, device)
    sms = _sms(device)
    cg, groups = _groups(c)
    th, twc = _ROWS, min(_COLS, -(-w // _TW) * _TW)

    def items(th, twc):
        return b * -(-h // th) * -(-w // twc) * groups

    rb = 2 if items(th, twc) >= sms else 1

    def half(twc):
        return -(-twc // (2 * _TW)) * _TW

    while items(th, twc) < sms and (twc > _TW or th > 2):
        th, twc = (th, half(twc)) if twc > _TW and (twc > 2 * th or th == 2) else (th // 2, twc)
    while _smem_bytes(th, twc, kk, cg) > _SMEM_BUDGET:
        if twc == _TW and th == 2:
            raise ValueError(f"dwconv: rows of {c} channels do not fit shared memory at k={kk}")
        th, twc = (th, half(twc)) if twc > 2 * _TW or (th == 2) else (th // 2, twc)
    nt = _threads(cg, th, twc, rb)
    smem = _smem_bytes(th, twc, kk, cg)
    occ = _occupancy(kk, mode, rb, (th, twc, cg, nt, smem))
    if occ < 1:
        raise RuntimeError(f"dwconv: a block of {nt} threads and {smem} bytes does not launch")
    n = items(th, twc)
    grid = min(n, sms * occ)
    packed = (ctypes.c_int * 11)(b, h, w, c, kk, th, twc, cg, nt, grid, rb)
    return Plan(th, twc, cg, nt, grid, n, smem, rb, 2, _TW, packed, ctypes.addressof(packed))


def _pair_groups(c: int, most: int) -> tuple[int, int]:
    """(channels a group, groups) of the pair: at most ``most`` channels,
    whole 16-byte vectors (C is a multiple of 8 here)."""
    groups = _cdiv(c, most)
    cg = _cdiv(_cdiv(c, groups), 8) * 8
    return cg, _cdiv(c, cg)


def _pair_plan(b: int, h: int, w: int, c: int, kk: int, mode: int, device: int) -> Plan:
    """pair_kernel's plan (through ``_plan``'s cache). A thread takes one
    channel and a slot of ``tw`` columns (PAIR_TW: the forward 8, the
    backward 16), so the column tile is as wide as W or as 192 threads allow
    for the group (forward 32 columns at C = 48; backward 64 at C = 48, 32
    at 96 in one group), split evenly. The TMA ring is as deep as shared
    memory allows (4, 3 or 2 stages): the forward's within half an SM, two
    blocks an SM running out of step, else a whole SM; the backward's within
    a whole SM (one block, 255 registers a thread); the column tile halves
    while nothing fits. Items are (sample, band of ``th`` rows, column tile,
    group); the band height (even) takes the fewest steps for the busiest
    block of a grid of ``sms`` x occupancy persistent blocks, where an item
    of ``th`` rows streams th + k - 1 input rows: whole images where the
    batch fills the card (B = 128), short bands where it does not (B = 1,
    8). The choice of tw and the budgets follows measurements on an H100 at
    t8's stage shapes (PERF.md)."""
    sms = _sms(device)
    bwd = mode == COMBINE_BWD
    tw = PAIR_TW[bwd]
    cg, groups = _pair_groups(c, _PAIR_CG[bwd])

    def fit(twc):  # the deepest ring within the first budget that holds one
        for budget in ((_SMEM_LIMIT,) if bwd else (_SMEM_BUDGET, _SMEM_LIMIT)):
            fits = [n for n in _PAIR_STAGES if _pair_smem(kk, bwd, cg, twc, n, c) <= budget]
            if fits:
                return fits[0]
        return 0

    twc = min(_cdiv(w, tw) * tw, max(1, _PAIR_THREADS // cg) * tw)
    twc = _cdiv(_cdiv(w, _cdiv(w, twc)), tw) * tw  # the same width for every column tile
    while not (stages := fit(twc)):
        if twc == tw:
            raise ValueError(f"dwconv: rows of {cg} channels do not fit shared memory at k={kk}")
        twc = _cdiv(twc, 2 * tw) * tw
    ctiles = _cdiv(w, twc)
    nc = _cdiv(cg * twc // tw, 32) * 32
    smem = _pair_smem(kk, bwd, cg, twc, stages, c)
    occ = _occupancy(kk, mode, stages, (cg, twc, c, nc, smem))
    if occ < 1:
        raise RuntimeError(f"dwconv: a block of {nc} threads and {smem} bytes does not launch")
    slots, per_band = sms * occ, b * groups * ctiles

    def cost(th):
        return _cdiv(per_band * _cdiv(h, th), slots) * (th + kk - 1)

    th = min((_cdiv(_cdiv(h, n), PAIR_RB) * PAIR_RB for n in range(1, _cdiv(h, PAIR_RB) + 1)),
             key=lambda t: (cost(t), -t))
    n = per_band * _cdiv(h, th)
    grid = min(n, slots)
    packed = (ctypes.c_int * 12)(b, h, w, c, kk, cg, twc, th, nc, stages, grid, tw)
    return Plan(th, twc, cg, nc, grid, n, smem, PAIR_RB, stages, tw, packed,
                ctypes.addressof(packed))


def _launch_checks(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any([t.requires_grad for t in tensors]):
        raise ValueError(f"{name} has no backward of its own, and an operand requires grad: "
                         "dw_conv_frozen and combine_dw_frozen are the differentiable ones")


def fused_dw_conv(x: torch.Tensor, kernel: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """The stride-1 SAME depthwise conv of (B, H, W, C) x with the HWIO
    kernel's f32 taps, mirrored in H and W where ``flip`` (the conv's
    transpose, ``dw_conv_frozen``'s dx); replaces ``_dw_kernel``
    (dino_pose_tpu/ops/dwconv.py:54, body ``_tap_conv`` :75, via
    ``dw_conv_frozen`` :174).

    Design (``dw_kernel<K, DW>``, dwconv_kernels.cu): persistent blocks walk
    items of (sample, strip, column tile, channel group), sized by ``_plan``
    so that the grid covers the card at every batch; each item's tile with
    its k-1 halo is staged by cp.async while the block computes the one
    before; a thread keeps a channel pair's f32 taps in registers and sums
    2 rows x 8 columns of outputs at once from bf16x2 reads of the tile,
    f32 sums rounded once, bf16x2 stores. The TPU kernel's lane-packed (H,
    W*C) view and its lane rolls exist for the 128-wide vector unit; here
    neighbouring threads take neighbouring channel pairs, NHWC's contiguous
    axis. Any H and W (the TPU kernel's 16-row chunks fail at H > 16,
    H % 16 != 0).

    Host side: the plan is cached per shape, the kernel's shared-memory
    limit is raised once per device, and the taps are read in place (no
    flipped copy).

    Bound on an H100: 2*k*k FLOPs an output in f32 at 67 TFLOP/s, or x and
    the output (bf16) at 3.35 TB/s; ``dwconv_cost`` counts both."""
    name = "fused_dw_conv"
    if not x.is_cuda:
        if x.device.type == "cpu":
            return dw_conv_math(x, kernel, flip)
        raise ValueError(f"{name}: unsupported device {x.device}")
    _launch_checks(name, x, kernel)
    b, h, w, c, kk = _check(name, kernel, x)
    index = x.get_device()
    plan = _plan(b, h, w, c, kk, DW, index)
    taps, out = _taps(kernel), torch.empty_like(x)
    err = _ext.lib().dp_dw_conv(plan.addr, x.data_ptr(), taps.data_ptr(), out.data_ptr(),
                                flip, _ext.stream(index))
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return out


def _pad_channels(t: torch.Tensor, c: int) -> torch.Tensor:
    """``t`` zero-padded along its last (channel) axis to ``c``."""
    return F.pad(t, (0, c - t.shape[-1])) if t.shape[-1] != c else t


# The backward's ticket counters, one a device: zero between launches (the
# kernel's last block resets its own), so launches on one device must run
# in stream order, as the port's single stream runs them.
_TICKETS: dict[int, torch.Tensor] = {}


def _ticket(index: int) -> torch.Tensor:
    t = _TICKETS.get(index)
    if t is None:
        t = _TICKETS[index] = torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", index))
    return t


def fused_combine_dw(x, y0, a, b, bias, kernel) -> tuple[torch.Tensor, torch.Tensor]:
    """(x2, y7) = (bf16(a*x + b*y0 + bias), dwconv(x2)) over (B, H, W, C);
    replaces ``_combine_dw_fwd_kernel`` (dino_pose_tpu/ops/dwconv.py:287, via
    ``combine_dw_frozen`` :407).

    Design (``pair_kernel<K, 0, 8>``, dwconv_kernels.cu): persistent blocks
    stream each item's input rows two at a time through a ring of TMA
    stages (x and y0 boxes with the column halo, zero-filled at the image's
    edge); the block's threads form x2 once per pixel into an f32 conv ring
    (0 outside the image: the padding is x2's, not x's), write the item's
    own x2 pixels once, and take the conv from f32 words, one channel and 8
    columns a thread, taps in registers, so the conv reads x2 as rounded
    (dwconv.py:299-303) and x2 makes no extra round trip through device
    memory. ``_plan`` (cached) sizes bands, column tiles, groups and the
    ring's depth; C not a multiple of 8 is zero-padded to one here (the
    tensor maps' strides), off the arm's t8 path.

    Bound on an H100: x, y0, x2, y7 (bf16) at 3.35 TB/s, or 2*(k*k + 2) f32
    FLOPs an output at 67 TFLOP/s; ``combine_dw_cost`` counts both."""
    name = "fused_combine_dw"
    if not x.is_cuda:
        if x.device.type == "cpu":
            return combine_dw_math(x, y0, a, b, bias, kernel)
        raise ValueError(f"{name}: unsupported device {x.device}")
    _launch_checks(name, x, y0, a, b, bias, kernel)
    bsz, h, w, c, kk = _check(name, kernel, x, y0, vecs=(a, b, bias))
    index = x.get_device()
    cp = _cdiv(c, 8) * 8
    x, y0, a, b, bias, kernel = (_pad_channels(t, cp) for t in (x, y0, a, b, bias, kernel))
    plan = _plan(bsz, h, w, cp, kk, COMBINE, index)
    taps, x2, y7 = _taps(kernel), torch.empty_like(x), torch.empty_like(x)
    err = _ext.lib().dp_combine_dw(plan.addr,
                                   *(t.data_ptr() for t in (x, y0, a, b, bias, taps, x2, y7)),
                                   _ext.stream(index))
    _ext.check(err, name)
    LAUNCHES[name] += 1
    if cp != c:
        return x2[..., :c].contiguous(), y7[..., :c].contiguous()
    return x2, y7


def fused_combine_dw_bwd(x, y0, dx2bar, dy7bar, a, b, kernel):
    """(dx, dy0, da, db, dbias) of the combine + conv segment; replaces
    ``_combine_dw_bwd_kernel`` (dino_pose_tpu/ops/dwconv.py:310, via
    ``_combine_dw_vjp_bwd`` :419). ``kernel`` is the forward's, read
    mirrored by the kernel (JAX's ``_prep_taps(jnp.flip(kernel, (0, 1)))``).

    Design (``pair_kernel<K, 1, 16>``): the forward's ring and conv on
    dy7bar (with its column halo) and the mirrored taps, 16 columns a
    thread, dx2bar, x and y0 staged in the same TMA stages without a halo;
    per output dx2 = dx2bar + the conv (f32), dx and dy0 written once, and
    each thread's f32 sums of
    dx2*x, dx2*y0 and dx2. Each block adds its threads' sums in a fixed
    order into its own slot, and the last block to finish (a ticket counter
    that only counts) adds the slots in block order, in the same launch. No
    atomics add: the same inputs and plan give the same bits.

    Bound on an H100: x, y0, dx2bar, dy7bar, dx, dy0 (bf16) at 3.35 TB/s, or
    (2*k*k + 8) f32 FLOPs an element at 67 TFLOP/s; ``combine_dw_bwd_cost``
    counts both."""
    name = "fused_combine_dw_bwd"
    if not x.is_cuda:
        if x.device.type == "cpu":
            return combine_dw_bwd_math(x, y0, dx2bar, dy7bar, a, b, kernel)
        raise ValueError(f"{name}: unsupported device {x.device}")
    bsz, h, w, c, kk = _check(name, kernel, x, y0, dx2bar, dy7bar, vecs=(a, b))
    index = x.get_device()
    cp = _cdiv(c, 8) * 8
    x, y0, dx2bar, dy7bar, a, b, kernel = (_pad_channels(t, cp)
                                           for t in (x, y0, dx2bar, dy7bar, a, b, kernel))
    plan = _plan(bsz, h, w, cp, kk, COMBINE_BWD, index)
    taps, dx, dy0 = _taps(kernel), torch.empty_like(x), torch.empty_like(x)
    # The blocks' sums (one slot a block) and their total, in one allocation.
    partials = torch.empty(((plan.grid + 1) * 3, cp), dtype=torch.float32, device=x.device)
    sums = partials[plan.grid * 3:]
    err = _ext.lib().dp_combine_dw_bwd(
        plan.addr,
        *(t.data_ptr() for t in (x, y0, dx2bar, dy7bar, a, b, taps, dx, dy0, partials, sums,
                                 _ticket(index))),
        _ext.stream(index))
    _ext.check(err, name)
    LAUNCHES[name] += 1
    if cp != c:
        dx, dy0, sums = dx[..., :c].contiguous(), dy0[..., :c].contiguous(), sums[:, :c]
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
            dx = conv(dy.contiguous(), kernel.detach(), True)
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
