"""FastViT ConvFFN past its depthwise conv: the plain PyTorch version and the
CUDA kernel wrapper (counterpart of dino_pose_tpu/ops/convffn.py).

=================  ================  =========================================
wrapper            plain version     TPU kernel it replaces
=================  ================  =========================================
``fused_convffn``  ``convffn_math``  ``_convffn_fwd_kernel`` (convffn.py:92)
=================  ================  =========================================

Over each row of ``y`` (one token, C channels)::

    m   = y * inv + shift                                  # BatchNorm as an affine
    h   = m @ W1 + b1 + ((m @ A1) * mask1) @ B1 * s        # fc1 + ConvLoRA
    g   = gelu(h)
    out = g @ W2 + b2 + ((g @ A2) * mask2) @ B2 * s        # fc2 + ConvLoRA

On a CPU tensor the wrapper runs ``convffn_math``; on a CUDA tensor it
launches ``convffn_fwd_kernel`` (``ops/csrc/convffn_kernels.cu``) and adds
one to ``LAUNCHES["fused_convffn"]``, or raises; it never falls back. It has
no backward (``_convffn_bwd_kernel`` is the FastViT training slice): on the
card it refuses operands that require grad while grad mode is on.

Rank 0 (no LoRA) is expressed as JAX expresses it (fastvit.py:596-603):
rank-1 zero adapters, ones masks and s = 1, so one kernel serves every
configuration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dino_pose_tpu_torch.ops import _ext

LAUNCHES = _ext.LAUNCHES

_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
MAX_RANK = 8          # LoRA rank the kernel takes (one (row, rank) pair per thread)


class ConvFFNParams(NamedTuple):
    """Everything past the depthwise conv, in the JAX package's layout:
    1x1-conv kernels squeezed to (in, out) matrices; ``m1``/``m2`` the
    per-(sample, rank) Dropout2d masks, already scaled by 1/keep (ones in
    eval). For the kernel, matrices are bf16 and vectors and masks f32."""

    inv: torch.Tensor    # (C,)   f32
    shift: torch.Tensor  # (C,)   f32
    w1: torch.Tensor     # (C, H)
    b1: torch.Tensor     # (H,)   f32
    w2: torch.Tensor     # (H, C)
    b2: torch.Tensor     # (C,)   f32
    a1: torch.Tensor     # (C, R)
    b1l: torch.Tensor    # (R, H)
    a2: torch.Tensor     # (H, R)
    b2l: torch.Tensor    # (R, C)
    m1: torch.Tensor     # (B, R) f32
    m2: torch.Tensor     # (B, R) f32


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of compute-dtype operands, summed in f32 and not rounded
    (JAX's ``preferred_element_type=float32``)."""
    return a.float() @ b.float()


def convffn_math(y: torch.Tensor, p: ConvFFNParams, s_lora: float) -> torch.Tensor:
    """Plain version of ``_convffn_fwd_kernel`` (convffn.py:96-114) on (B, S, C)
    rows, with its rounding points: the products sum in f32, each is rounded
    to y's dtype before its add, and the three terms of h (and of out) add
    left to right in that dtype, each sum rounded."""
    dt = y.dtype
    m = (y.float() * p.inv + p.shift).to(dt)
    u1 = _mm(m, p.a1.to(dt)) * p.m1[:, None, :]
    h = (_mm(m, p.w1.to(dt)).to(dt) + p.b1.to(dt)) + (_mm(u1.to(dt), p.b1l.to(dt)) * s_lora).to(dt)
    g = torch.nn.functional.gelu(h.float()).to(dt)
    u2 = _mm(g, p.a2.to(dt)) * p.m2[:, None, :]
    return (_mm(g, p.w2.to(dt)).to(dt) + p.b2.to(dt)) + (_mm(u2.to(dt), p.b2l.to(dt)) * s_lora).to(dt)


def convffn_cost(b: int, s: int, c: int, h: int, r: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one call: the two products (4*B*S*C*H, JAX's
    CostEstimate) and the four LoRA products (4*B*S*R*(C+H)); y read and out
    written once in bf16, the bf16 weights and LoRA matrices once, the f32
    vectors and masks once."""
    flops = 4 * b * s * c * h + 4 * b * s * r * (c + h)
    nbytes = 2 * b * s * c * 2 + (2 * c * h + 2 * r * (c + h)) * 2 + (3 * c + h) * 4 + 2 * b * r * 4
    return flops, nbytes


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(y: torch.Tensor, p: ConvFFNParams, name: str) -> tuple[int, int, int, int, int]:
    if y.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bf16 activations, got {y.dtype}")
    if y.dim() != 3 or not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError(f"{name}: y must be a contiguous, 16-byte aligned (B, S, C) tensor")
    b, s, c = y.shape
    h, r = p.w1.shape[-1], p.a1.shape[-1]
    if c % 16 or h % 16:
        raise ValueError(f"{name}: widths C={c}, H={h} must be multiples of 16 (the kernel's "
                         f"16x16 tensor-core tiles); fastvit_ma36's C=76 is not ported yet")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{name}: LoRA rank {r} is not in 1..{MAX_RANK} (rank 0 is rank-1 zeros)")
    if _ext.lib().dp_convffn_smem_bytes(c) > _SMEM_LIMIT:
        raise ValueError(f"{name}: rows of width {c} do not fit shared memory")
    shapes = {"inv": (c,), "shift": (c,), "w1": (c, h), "b1": (h,), "w2": (h, c), "b2": (c,),
              "a1": (c, r), "b1l": (r, h), "a2": (h, r), "b2l": (r, c), "m1": (b, r), "m2": (b, r)}
    for field, shape in shapes.items():
        t = getattr(p, field)
        want = torch.bfloat16 if t.dim() == 2 and field not in ("m1", "m2") else torch.float32
        if t.device != y.device or t.dtype != want:
            raise TypeError(f"{name}: {field} must be {want} on {y.device}, got {t.dtype} on {t.device}")
        # 32-byte alignment: the tensor-core tiles read W1 and W2 from device memory.
        if tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name}: {field} must be a contiguous, 32-byte aligned {shape} "
                             f"tensor, got {tuple(t.shape)}")
    return b, s, c, h, r


def fused_convffn(y: torch.Tensor, p: ConvFFNParams, s_lora: float) -> torch.Tensor:
    """out over (B, S, C) rows; replaces ``_convffn_fwd_kernel``
    (dino_pose_tpu/ops/convffn.py:92, via ``fused_convffn`` :258).

    Design: one launch, one block per 32-row tile. The tile's
    m = bf16(y*inv + shift) and its rank-R u1 stay in shared memory; the
    block walks H in 64-column chunks: h-chunk = m @ W1[:, chunk] on the
    tensor cores (W1 read from device memory, L2 at these sizes), the
    bias/LoRA/GELU epilogue into a bf16 g-chunk in shared memory,
    then out += g-chunk @ W2[chunk] into an f32 (32, C) accumulator in shared
    memory, and u2 += g-chunk @ A2[chunk] on the CUDA cores. h and g never
    reach device memory, as on the TPU. The rank-R LoRA products are 8 FMAs
    per output element on the CUDA cores, not padded tensor-core tiles; the
    masks are per sample (row // S). Widths are multiples of 16 (t8 and
    sa12's C = 48-512, H = 144-2048; 16x16 tiles need no edge masks), rows
    are masked at the ragged edge.

    Bound on an H100: 4*B*S*C*H FLOPs (plus 4*B*S*R*(C+H) for LoRA) at
    989 TFLOP/s, or y and out (bf16) plus the weights at 3.35 TB/s;
    ``convffn_cost`` counts both.
    """
    name = "fused_convffn"
    if y.device.type == "cpu":
        return convffn_math(y, p, s_lora)
    if y.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {y.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, *p)):
        raise ValueError(f"{name} has no backward (that is the FastViT training slice), and an "
                         "operand requires grad; run it under torch.no_grad()")
    b, s, c, h, r = _check(y, p, name)
    out = torch.empty_like(y)
    err = _ext.lib().dp_fused_convffn(
        *(t.data_ptr() for t in (y, *p, out)), b * s, s, c, h, r, float(s_lora), _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return out
