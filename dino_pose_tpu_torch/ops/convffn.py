"""FastViT ConvFFN past its depthwise conv: the plain PyTorch version and the
CUDA kernel wrapper (counterpart of dino_pose_tpu/ops/convffn.py).

=====================  ======================  =======================================
wrapper                plain version           TPU kernel it replaces
=====================  ======================  =======================================
``fused_convffn``      ``convffn_math``        ``_convffn_fwd_kernel`` (convffn.py:92)
``fused_convffn_bwd``  ``convffn_bwd_math``    ``_convffn_bwd_kernel`` (convffn.py:117)
``fused_convffn_res``  ``convffn_res_math``    ``_convffn_fwd_res_kernel`` (convffn.py:370)
=====================  ======================  =======================================

Over each row of ``y`` (one token, C channels)::

    m   = y * inv + shift                                  # BatchNorm as an affine
    h   = m @ W1 + b1 + ((m @ A1) * mask1) @ B1 * s        # fc1 + ConvLoRA
    g   = gelu(h)
    out = g @ W2 + b2 + ((g @ A2) * mask2) @ B2 * s        # fc2 + ConvLoRA

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel (``ops/csrc/convffn_kernels.cu``) and adds one to
``LAUNCHES[<wrapper>]``, or raises; it never falls back. ``convffn_train``
is the differentiable ConvFFN (JAX's ``custom_vjp`` ``fused_convffn``):
forward ``fused_convffn``, backward ``fused_convffn_bwd``, gradients for
y, the BatchNorm affine and the four LoRA matrices, none for the frozen
fc1/fc2. ``convffn_res_train`` is the same with the block residual
(JAX's ``fused_convffn_res``, the stage-pair arm's block output): forward
``fused_convffn_res``, backward ``fused_convffn_bwd`` and dres = df.
``convffn_res_enabled`` is JAX's gate for it, with its VMEM byte models
copied.

Rank 0 (no LoRA) is expressed as JAX expresses it (fastvit.py:596-603):
rank-1 zero adapters, ones masks and s = 1, so one kernel serves every
configuration.

The kernels take widths C and H in multiples of 16 (their 16x16 tensor-core
tiles). fastvit_ma36's stages 0 and 1 (C = 76, 152) are not: the wrappers
zero-pad C and H up to the next multiple of 16 before the launch
(``pad_widths``: y, res, df, inv, shift, the W1 rows and columns, the W2
rows and columns, b1, b2, the A1 and A2 rows and the B1 and B2 columns)
and slice the outputs and gradients back (``unpad_grads``). The padded
lanes carry exact zeros through every product (m, h, g, dh and dm are 0
there), so the result is the unpadded one up to the order of the f32 sums.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dino_pose_tpu_torch.ops import _ext
from dino_pose_tpu_torch.ops.block import _gelu_grad

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


class ConvFFNGrads(NamedTuple):
    """The backward's parameter gradients, f32 sums over every row (base
    fc1/fc2 and the masks get none)."""

    inv: torch.Tensor    # (C,)
    shift: torch.Tensor  # (C,)
    a1: torch.Tensor     # (C, R)
    b1l: torch.Tensor    # (R, H)
    a2: torch.Tensor     # (H, R)
    b2l: torch.Tensor    # (R, C)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of compute-dtype operands, summed in f32 and not rounded
    (JAX's ``preferred_element_type=float32``)."""
    return a.float() @ b.float()


def _hidden(y: torch.Tensor, p: ConvFFNParams, s_lora: float):
    """The forward up to g, with the kernels' rounding points: (m, u1 in y's
    dtype, h, g)."""
    dt = y.dtype
    m = (y.float() * p.inv + p.shift).to(dt)
    u1 = (_mm(m, p.a1.to(dt)) * p.m1[:, None, :]).to(dt)
    h = (_mm(m, p.w1.to(dt)).to(dt) + p.b1.to(dt)) + (_mm(u1, p.b1l.to(dt)) * s_lora).to(dt)
    g = torch.nn.functional.gelu(h.float()).to(dt)
    return m, u1, h, g


def convffn_math(y: torch.Tensor, p: ConvFFNParams, s_lora: float) -> torch.Tensor:
    """Plain version of ``_convffn_fwd_kernel`` (convffn.py:96-114) on (B, S, C)
    rows, with its rounding points: the products sum in f32, each is rounded
    to y's dtype before its add, and the three terms of h (and of out) add
    left to right in that dtype, each sum rounded."""
    dt = y.dtype
    _, _, _, g = _hidden(y, p, s_lora)
    u2 = _mm(g, p.a2.to(dt)) * p.m2[:, None, :]
    return (_mm(g, p.w2.to(dt)).to(dt) + p.b2.to(dt)) + (_mm(u2.to(dt), p.b2l.to(dt)) * s_lora).to(dt)


def convffn_bwd_math(y: torch.Tensor, df: torch.Tensor, p: ConvFFNParams,
                     s_lora: float) -> tuple[torch.Tensor, ConvFFNGrads]:
    """Plain version of ``_convffn_bwd_kernel`` (convffn.py:127-175): dy and
    the parameter gradients from the cotangent ``df`` of the output, the
    forward recomputed with its rounding points. The products sum in f32;
    du2, dh and du1 are rounded to y's dtype before they feed products, dg
    stays f32 into gelu'; the gradients are f32 sums over all B*S rows."""
    dt = y.dtype
    yf = y.float()
    m1, m2 = p.m1[:, None, :], p.m2[:, None, :]
    m, u1, h, g = _hidden(y, p, s_lora)
    dfb = df.to(dt)
    u2 = (_mm(g, p.a2.to(dt)) * m2).to(dt)
    du2 = (_mm(dfb, p.b2l.to(dt).t()) * s_lora * m2).to(dt)
    dg = _mm(dfb, p.w2.to(dt).t()) + _mm(du2, p.a2.to(dt).t())
    dh = (dg * _gelu_grad(h.float())).to(dt)
    du1 = (_mm(dh, p.b1l.to(dt).t()) * s_lora * m1).to(dt)
    dm = _mm(dh, p.w1.to(dt).t()) + _mm(du1, p.a1.to(dt).t())

    def outer(a, b):  # sum over rows of a^T b, f32
        return _mm(a.reshape(-1, a.shape[-1]).t(), b.reshape(-1, b.shape[-1]))

    grads = ConvFFNGrads(
        inv=(dm * yf).sum(dim=(0, 1)), shift=dm.sum(dim=(0, 1)),
        a1=outer(m, du1), b1l=outer(u1, dh) * s_lora,
        a2=outer(g, du2), b2l=outer(u2, dfb) * s_lora)
    return (dm * p.inv).to(dt), grads


def convffn_res_math(y: torch.Tensor, res: torch.Tensor, p: ConvFFNParams,
                     s_lora: float) -> torch.Tensor:
    """Plain version of ``_convffn_fwd_res_kernel`` (convffn.py:370):
    ``convffn_math``'s output plus res, added in y's dtype, last."""
    return convffn_math(y, p, s_lora) + res.to(y.dtype)


# JAX's VMEM byte models of the ConvFFN kernels (convffn.py:178-250), copied
# for ``convffn_res_enabled``.
_FWD_BUDGET = 12 * 1024 * 1024
_BWD_BUDGET = 10 * 1024 * 1024


def _fwd_bytes(g: int, sp: int, c: int, h: int, r: int, i: int, streams: int = 2) -> int:
    stream_b = streams * (2 * g * sp * c * i)       # y (+res) in + out, 2x-buffered
    temps = g * sp * c * (i + 4) + g * sp * h * (2 * i + 8) + g * sp * r * 12
    weights = 2 * c * h * i + 2 * r * (c + h) * i
    return stream_b + temps + weights


def _bwd_bytes(spt: int, c: int, h: int, r: int, i: int) -> int:
    streams = 3 * (2 * spt * c * i)                 # y, df, dy
    temps = spt * c * (2 * i + 12) + spt * h * (3 * i + 12) + spt * r * 16
    weights = 2 * c * h * i + 2 * r * (c + h) * i
    accums = 4 * (2 * c + r * (2 * c + 2 * h))
    return streams + temps + weights + accums


def _fwd_plan(sp: int, c: int, h: int, r: int, itemsize: int, batch: int,
              streams: int) -> tuple[int, int]:
    g = 0
    for cand in (8, 4, 2, 1):
        if _fwd_bytes(cand, sp, c, h, r, itemsize, streams) <= _FWD_BUDGET:
            g = cand
            break
    while g > 1 and batch % g:
        g //= 2
    if g:
        return g, 1
    kt = 2
    while kt <= sp // 8:
        if sp % kt == 0 and (sp // kt) % 8 == 0 and _fwd_bytes(
                1, sp // kt, c, h, r, itemsize, streams) <= _FWD_BUDGET:
            return 1, kt
        kt *= 2
    return 0, 0


def _bwd_row_chunks(sp: int, c: int, h: int, r: int, itemsize: int) -> int:
    kt = 1
    while kt <= sp // 8:
        if sp % kt == 0 and (sp // kt) % 8 == 0 and (
                _bwd_bytes(sp // kt, c, h, r, itemsize) <= _BWD_BUDGET):
            return kt
        kt *= 2
    return 0


def convffn_res_enabled(c: int, hidden: int, s: int, itemsize: int, train: bool,
                        lora_rank: int, batch: int | None = None) -> bool:
    """JAX's ``convffn_res_enabled`` (convffn.py:494), its contract part: the
    ConvFFN side of the stage-pair gate, in training only with LoRA (the
    backward gives the base fc1/fc2 no gradient), and only where JAX's
    residual forward plan (three streams) and, in training, its backward
    row chunks fit VMEM. (JAX's ``DINO_POSE_TPU_CONVFFN`` kill switch
    selects its ConvFFN route, which the port does not have.)"""
    if train and lora_rank == 0:
        return False
    sp = -(-s // 8) * 8
    r = max(1, lora_rank)
    if _fwd_plan(sp, c, hidden, r, itemsize, batch or 1, streams=3)[0] == 0:
        return False
    return not train or _bwd_row_chunks(sp, c, hidden, r, itemsize) > 0


def convffn_cost(b: int, s: int, c: int, h: int, r: int, res: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one call: the two products (4*B*S*C*H, JAX's
    CostEstimate) and the four LoRA products (4*B*S*R*(C+H)); y (and with
    ``res`` the residual) read and out written once in bf16, the bf16
    weights and LoRA matrices once, the f32 vectors and masks once."""
    flops = 4 * b * s * c * h + 4 * b * s * r * (c + h) + (b * s * c if res else 0)
    nbytes = ((3 if res else 2) * b * s * c * 2 + (2 * c * h + 2 * r * (c + h)) * 2
              + (3 * c + h) * 4 + 2 * b * r * 4)
    return flops, nbytes


def convffn_bwd_cost(b: int, s: int, c: int, h: int, r: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward call: three products of 2*B*S*C*H (h
    recomputed, dg, dm) and eleven rank-R ones (u1, du2, du1·A1ᵀ, dA1, dB2
    over C; the fc1 LoRA term, u2, du2·A2ᵀ, du1, dB1, dA2 over H); y and df
    read and dy written once in bf16, the bf16 weights and LoRA matrices, the
    f32 inv, shift, b1 and masks once, the f32 gradients written once."""
    m = b * s
    flops = 6 * m * c * h + 2 * m * r * (5 * c + 6 * h)
    nbytes = (3 * m * c * 2 + (2 * c * h + 2 * r * (c + h)) * 2 + (2 * c + h) * 4
              + 2 * b * r * 4 + (2 * c + 2 * r * (c + h)) * 4)
    return flops, nbytes


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def pad_widths(y: torch.Tensor, p: ConvFFNParams, *rows: torch.Tensor
               ) -> tuple[torch.Tensor, ConvFFNParams, tuple[torch.Tensor, ...]]:
    """(y, p, rows) with C and H zero-padded up to multiples of 16, the
    kernels' widths: y and each of ``rows`` (res, df: (B, S, C)) along C;
    inv, shift, b2, the W2 and B2 columns and the W1 and A1 rows along C;
    b1, the W1 and B1 columns and the W2 and A2 rows along H. The masks are
    unchanged. Returns the operands as they are where both widths already
    are multiples of 16."""
    c, h = y.shape[-1], p.w1.shape[-1]
    dc, dh = _up16(c) - c, _up16(h) - h
    if not (dc or dh):
        return y, p, rows

    def pad(t: torch.Tensor, last: int, first: int = 0) -> torch.Tensor:
        return torch.nn.functional.pad(t, (0, last, 0, first) if first else (0, last))

    padded = ConvFFNParams(
        inv=pad(p.inv, dc), shift=pad(p.shift, dc), w1=pad(p.w1, dh, dc), b1=pad(p.b1, dh),
        w2=pad(p.w2, dc, dh), b2=pad(p.b2, dc), a1=pad(p.a1, 0, dc), b1l=pad(p.b1l, dh),
        a2=pad(p.a2, 0, dh), b2l=pad(p.b2l, dc), m1=p.m1, m2=p.m2)
    return pad(y, dc), padded, tuple(pad(t, dc) for t in rows)


def unpad_grads(g: ConvFFNGrads, c: int, h: int) -> ConvFFNGrads:
    """The gradients of ``pad_widths``' operands sliced back to C and H."""
    return ConvFFNGrads(inv=g.inv[:c], shift=g.shift[:c], a1=g.a1[:c].contiguous(),
                        b1l=g.b1l[:, :h].contiguous(), a2=g.a2[:h].contiguous(),
                        b2l=g.b2l[:, :c].contiguous())


def _unpad_rows(t: torch.Tensor, c: int) -> torch.Tensor:
    return t if t.shape[-1] == c else t[..., :c].contiguous()


def _check(y: torch.Tensor, p: ConvFFNParams, name: str) -> tuple[int, int, int, int, int]:
    """Refuses what the kernels do not take, on the caller's (unpadded)
    operands."""
    if y.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bf16 activations, got {y.dtype}")
    if y.dim() != 3 or not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError(f"{name}: y must be a contiguous, 16-byte aligned (B, S, C) tensor")
    b, s, c = y.shape
    h, r = p.w1.shape[-1], p.a1.shape[-1]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{name}: LoRA rank {r} is not in 1..{MAX_RANK} (rank 0 is rank-1 zeros)")
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


def _check_smem(c: int, name: str, smem_bytes: str = "dp_convffn_smem_bytes") -> None:
    if getattr(_ext.lib(), smem_bytes)(c) > _SMEM_LIMIT:
        raise ValueError(f"{name}: rows of width {c} do not fit shared memory")


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
    masks are per sample (row // S). The kernel's widths are multiples of
    16 (16x16 tiles need no edge masks): t8 and sa12's C = 48-512 and
    H = 144-2048 are, ma36's C = 76 and 152 are padded (``pad_widths``);
    rows are masked at the ragged edge.

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
        raise ValueError(f"{name} has no backward of its own, and an operand requires grad: "
                         "convffn_train is the differentiable ConvFFN")
    _check(y, p, name)
    c = y.shape[-1]
    y, p, _ = pad_widths(y, p)
    b, s, cp = y.shape
    _check_smem(cp, name)
    out = torch.empty_like(y)
    err = _ext.lib().dp_fused_convffn(
        *(t.data_ptr() for t in (y, *p, out)), b * s, s, cp, p.w1.shape[-1], p.a1.shape[-1],
        float(s_lora), _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return _unpad_rows(out, c)


def fused_convffn_res(y: torch.Tensor, res: torch.Tensor, p: ConvFFNParams,
                      s_lora: float) -> torch.Tensor:
    """res + out over (B, S, C) rows; replaces ``_convffn_fwd_res_kernel``
    (dino_pose_tpu/ops/convffn.py:370, via ``fused_convffn_res`` :377), the
    stage-pair arm's block output (LayerScale folded into w2, b2 and b2l by
    the caller).

    Design: ``fused_convffn``'s kernel with the residual as one more operand;
    its epilogue adds res to the rounded output, one more bf16 rounding, as
    JAX adds it after the three bf16 terms (convffn.py:112-113). One launch.

    Bound on an H100: ``fused_convffn``'s FLOPs, or y, res and out (bf16)
    plus the weights at 3.35 TB/s; ``convffn_cost(..., res=True)``."""
    name = "fused_convffn_res"
    if y.device.type == "cpu":
        return convffn_res_math(y, res, p, s_lora)
    if y.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {y.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, res, *p)):
        raise ValueError(f"{name} has no backward of its own, and an operand requires grad: "
                         "convffn_res_train is the differentiable one")
    _check(y, p, name)
    if (res.shape != y.shape or res.dtype != y.dtype or res.device != y.device
            or not res.is_contiguous() or res.data_ptr() % 16):
        raise ValueError(f"{name}: res must be a contiguous, 16-byte aligned bf16 tensor of y's "
                         f"shape {tuple(y.shape)}")
    c = y.shape[-1]
    y, p, (res,) = pad_widths(y, p, res)
    b, s, cp = y.shape
    _check_smem(cp, name)
    out = torch.empty_like(y)
    err = _ext.lib().dp_fused_convffn_res(
        *(t.data_ptr() for t in (y, res, *p, out)), b * s, s, cp, p.w1.shape[-1],
        p.a1.shape[-1], float(s_lora), _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return _unpad_rows(out, c)


def fused_convffn_bwd(y: torch.Tensor, df: torch.Tensor, p: ConvFFNParams,
                      s_lora: float) -> tuple[torch.Tensor, ConvFFNGrads]:
    """(dy, parameter gradients) over (B, S, C) rows; replaces
    ``_convffn_bwd_kernel`` (dino_pose_tpu/ops/convffn.py:117, via
    ``fused_convffn``'s vjp :307).

    Design: one launch of ``convffn_bwd_kernel`` on a fixed grid (as many
    blocks as fit on the card at once, at most one per 32-row tile), each
    block walking its tiles in order; then ``convffn_bwd_reduce_kernel``
    (inside the same C entry) sums the blocks' f32 partial gradients in
    block order. No atomics: the result is the same bits from run to run.
    Per tile, m = bf16(y*inv + shift), df and an f32 (32, C) dm accumulator
    stay in shared memory; du2 = bf16(f32(df·B2ᵀ)·s·m2) first; then H is
    walked in 64-column chunks: h-chunk (m·W1, WMMA) with its bias/LoRA
    epilogue and g, dg-chunk = df·W2ᵀ (WMMA) + du2·A2ᵀ, dh = bf16(dg·
    gelu'(h)), dm += dh·W1ᵀ (WMMA), and on the CUDA cores u2 += g·A2,
    du1 += dh·B1ᵀ and the dA2, dB1 partials. After the walk dm += du1·A1ᵀ,
    dy = bf16(dm·inv), and the dinv, dshift, dA1, dB2 partials. The hidden
    h, g, dg and dh never reach device memory.

    Bound on an H100: 6*B*S*C*H FLOPs plus the rank-R terms at 989 TFLOP/s,
    or y, df and dy (bf16) plus the weights at 3.35 TB/s;
    ``convffn_bwd_cost`` counts both."""
    name = "fused_convffn_bwd"
    if y.device.type == "cpu":
        return convffn_bwd_math(y, df, p, s_lora)
    if y.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {y.device}")
    _, _, c, h, _ = _check(y, p, name)
    if (df.shape != y.shape or df.dtype != y.dtype or df.device != y.device
            or not df.is_contiguous() or df.data_ptr() % 16):
        raise ValueError(f"{name}: df must be a contiguous, 16-byte aligned bf16 tensor of y's "
                         f"shape {tuple(y.shape)}")
    y, p, (df,) = pad_widths(y, p, df)
    b, s, cp = y.shape
    hp, r = p.w1.shape[-1], p.a1.shape[-1]
    _check_smem(cp, name, "dp_convffn_bwd_smem_bytes")
    lib = _ext.lib()
    m = b * s
    blocks = lib.dp_convffn_bwd_blocks(m, cp)
    if blocks < 1:
        raise RuntimeError(f"{name}: the kernel's occupancy query failed at C={cp}")
    shapes = ((cp,), (cp,), (cp, r), (r, hp), (hp, r), (r, cp))
    sizes = [math.prod(shape) for shape in shapes]
    partials = torch.empty(blocks * sum(sizes), dtype=torch.float32, device=y.device)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=y.device)
    dy = torch.empty_like(y)
    err = lib.dp_fused_convffn_bwd(
        *(t.data_ptr() for t in (y, df, *p, dy, partials, flat)), blocks, m, s, cp, hp, r,
        float(s_lora), _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    grads = ConvFFNGrads(*(t.view(shape) for t, shape in zip(flat.split(sizes), shapes)))
    return _unpad_rows(dy, c), unpad_grads(grads, c, h)


_FROZEN = ("w1", "b1", "w2", "b2", "m1", "m2")


def _cast(p: ConvFFNParams, dtype: torch.dtype) -> ConvFFNParams:
    """The kernels' layout (JAX ``_prep``): matrices in ``dtype``, vectors
    and masks f32, all contiguous."""
    return ConvFFNParams(**{
        k: t.to(dtype if t.dim() == 2 and k not in ("m1", "m2") else torch.float32).contiguous()
        for k, t in p._asdict().items()})


class _ConvFFNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, res, s_lora, kernels, *params):
        trainable = [k for k, need in zip(ConvFFNParams._fields, ctx.needs_input_grad[4:])
                     if need and k in _FROZEN]
        if trainable:
            raise ValueError(
                f"convffn_train: {trainable} requires grad, but the ConvFFN backward gives the "
                "base fc1/fc2 (and the masks) no gradient, as JAX's does (frozen-backbone LoRA)")
        ctx.save_for_backward(y, *params)
        ctx.s_lora, ctx.kernels = s_lora, kernels
        pc = _cast(ConvFFNParams(*params), y.dtype)
        if res is None:
            return fused_convffn(y, pc, s_lora) if kernels else convffn_math(y, pc, s_lora)
        if kernels:
            return fused_convffn_res(y, res, pc, s_lora)
        return convffn_res_math(y, res, pc, s_lora)

    @staticmethod
    def backward(ctx, df):
        y, *params = ctx.saved_tensors
        pc = _cast(ConvFFNParams(*params), y.dtype)
        bwd = fused_convffn_bwd if ctx.kernels else convffn_bwd_math
        dy, g = bwd(y, df.to(y.dtype).contiguous(), pc, ctx.s_lora)
        g = g._asdict()
        # In each parameter's own dtype (JAX ``astype(p.a1.dtype)``): f32 for f32 masters.
        grads = [g[k].to(t.dtype) if need and k in g else None
                 for k, t, need in zip(ConvFFNParams._fields, params, ctx.needs_input_grad[4:])]
        # The residual is additive: its cotangent is df (convffn.py:442-447).
        dres = df if ctx.needs_input_grad[1] else None
        return (dy if ctx.needs_input_grad[0] else None, dres, None, None, *grads)


def convffn_train(y: torch.Tensor, p: ConvFFNParams, s_lora: float, *,
                  kernels: bool = True) -> torch.Tensor:
    """The ConvFFN past its depthwise conv under autograd (JAX's
    ``custom_vjp`` ``fused_convffn``, convffn.py:258-367): differentiable in
    y, inv, shift, a1, b1l, a2 and b2l. The forward is ``fused_convffn``,
    the backward ``fused_convffn_bwd`` (``kernels=False``: ``convffn_math``
    and ``convffn_bwd_math``, on any device). ``p`` holds the tensors as
    they train (LoRA matrices f32, with their graphs); they are cast to the
    kernels' layout inside, as JAX's ``_prep`` runs inside its
    ``custom_vjp``, so their gradients come back f32. Raises ``ValueError``
    if w1, b1, w2 or b2 requires grad: the backward gives them no gradient.
    Saves only y and ``p``; the backward recomputes the hidden activations."""
    return _ConvFFNTrain.apply(y.contiguous(), None, float(s_lora), kernels, *p)


def convffn_res_train(y: torch.Tensor, res: torch.Tensor, p: ConvFFNParams, s_lora: float, *,
                      kernels: bool = True) -> torch.Tensor:
    """res + the ConvFFN past its depthwise conv under autograd (JAX's
    ``custom_vjp`` ``fused_convffn_res``, convffn.py:377-447): as
    ``convffn_train``, the forward ``fused_convffn_res`` (``kernels=False``:
    ``convffn_res_math``), the backward ``fused_convffn_bwd`` with the
    residual's gradient df. Same contract for the parameters."""
    return _ConvFFNTrain.apply(y.contiguous(), res.contiguous(), float(s_lora), kernels, *p)
