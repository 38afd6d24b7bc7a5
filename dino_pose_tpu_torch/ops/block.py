"""Fused ViT block: plain PyTorch versions and the CUDA kernel wrappers
(counterpart of dino_pose_tpu/ops/block.py).

Four functions of the dinov2 + LoRA path, each with its plain version:

==================  ==================  =====================================
wrapper             plain version       TPU kernel it replaces
==================  ==================  =====================================
``fused_block``     ``block_math``      ``_block_kernel`` (block.py:159)
``fused_attn_part`` ``attn_part_math``  ``_attn_part_kernel`` (block.py:999)
``fused_mlp_part``  ``mlp_part_math``   ``_mlp_part_kernel`` (block.py:1021)
``fused_mlp_dx``    ``mlp_dx_math``     ``_mlp_dx_kernel`` (block.py:1044)
==================  ==================  =====================================

A wrapper takes its plain version only for tensors on the CPU. On a CUDA
tensor it launches the kernels of ``ops/csrc/block_kernels.cu`` or raises;
it never falls back. Each launch adds one to ``LAUNCHES[<wrapper name>]``.

The forward wrappers return tensors without a graph, so they refuse inputs
that require grad while grad mode is on. The one backward is the LoRA
layer's: :func:`mlp_part_frozen` is ``fused_mlp_part`` with an autograd
backward that carries dx2 through ``fused_mlp_dx`` and gives the (frozen)
MLP weights no gradient, as ``fused_mlp_part(..., assume_frozen_weights=True)``
does in the JAX package.

Parameter layouts match the JAX package: matrices are (in, out) and
``wqkv``/``bqkv`` hold q|k|v on the output axis. For the kernels, matrices
are bf16 and vectors (norm scales and biases, linear biases, LayerScales)
f32, as the module stores them; the kernels round biases and LayerScales to
bf16 where the JAX math casts them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dino_pose_tpu_torch.nn.layers import layer_norm
from dino_pose_tpu_torch.ops import _ext
from dino_pose_tpu_torch.ops.attention import plain_attention

LAUNCHES: dict[str, int] = {
    "fused_block": 0, "fused_attn_part": 0, "fused_mlp_part": 0, "fused_mlp_dx": 0,
}

_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class BlockParams(NamedTuple):
    """One transformer block's parameters. Matrices (in, out)."""

    g1: torch.Tensor     # (D,)   norm1 scale
    b1: torch.Tensor     # (D,)   norm1 bias
    wqkv: torch.Tensor   # (D, 3D)
    bqkv: torch.Tensor   # (3D,)
    wo: torch.Tensor     # (D, D)
    bo: torch.Tensor     # (D,)
    ls1: torch.Tensor    # (D,)   layerscale1
    g2: torch.Tensor     # (D,)
    b2: torch.Tensor     # (D,)
    w1: torch.Tensor     # (D, 4D)
    bf1: torch.Tensor    # (4D,)
    w2: torch.Tensor     # (4D, D)
    bf2: torch.Tensor    # (D,)
    ls2: torch.Tensor    # (D,)


class AttnParams(NamedTuple):
    g1: torch.Tensor
    b1: torch.Tensor
    wqkv: torch.Tensor
    bqkv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor


class MlpParams(NamedTuple):
    g2: torch.Tensor
    b2: torch.Tensor
    w1: torch.Tensor
    bf1: torch.Tensor
    w2: torch.Tensor
    bf2: torch.Tensor
    ls2: torch.Tensor


def attn_params(p: BlockParams) -> AttnParams:
    return AttnParams(p.g1, p.b1, p.wqkv, p.bqkv, p.wo, p.bo)


def mlp_params(p: BlockParams) -> MlpParams:
    return MlpParams(p.g2, p.b2, p.w1, p.bf1, p.w2, p.bf2, p.ls2)


# ---------------------------------------------------------------------------
# Plain versions (the JAX rounding points: each product is cast to the
# activation dtype, then the bias is added in that dtype)
# ---------------------------------------------------------------------------

def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (x @ w.to(x.dtype)).to(x.dtype) + b.to(x.dtype)


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x.float(), approximate="none").to(x.dtype)


def attn_part_math(
    x: torch.Tensor, ap: AttnParams, *, num_heads: int, eps: float
) -> torch.Tensor:
    """LN1 -> qkv -> multi-head attention -> out-projection + bias
    (before LayerScale, without the residual)."""
    b, s, d = x.shape
    dh = d // num_heads
    qkv = _dense(layer_norm(x, ap.g1, ap.b1, eps), ap.wqkv, ap.bqkv)
    q, k, v = (
        t.reshape(b, s, num_heads, dh).transpose(1, 2) for t in qkv.split(d, dim=-1)
    )
    ctx = plain_attention(q, k, v, dh**-0.5).transpose(1, 2).reshape(b, s, d)
    return _dense(ctx, ap.wo, ap.bo)


def mlp_part_math(x2: torch.Tensor, mp: MlpParams, *, eps: float) -> torch.Tensor:
    """LN2 -> fc1 -> exact GELU -> fc2 -> LayerScale -> residual."""
    h = _gelu_exact(_dense(layer_norm(x2, mp.g2, mp.b2, eps), mp.w1, mp.bf1))
    h = _dense(h, mp.w2, mp.bf2)
    return x2 + h * mp.ls2.to(h.dtype)


def block_math(
    x: torch.Tensor, p: BlockParams, *, num_heads: int, eps: float
) -> torch.Tensor:
    """One pre-norm block: x2 = x + ls1*attn(x); y = x2 + ls2*mlp(x2)."""
    o = attn_part_math(x, attn_params(p), num_heads=num_heads, eps=eps)
    x2 = x + o * p.ls1.to(o.dtype)
    return mlp_part_math(x2, mlp_params(p), eps=eps)


def _gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz of exact GELU at z (f32 in and out)."""
    phi = torch.exp(-0.5 * z * z) * 0.3989422804014327  # 1/sqrt(2*pi)
    cdf = 0.5 * (1.0 + torch.erf(z * 2.0**-0.5))
    return cdf + z * phi


def mlp_dx_math(
    x2: torch.Tensor, dy: torch.Tensor, mp: MlpParams, *, eps: float
) -> torch.Tensor:
    """Input cotangent of ``mlp_part_math`` with the weights held fixed:
    dx2 = dy + LN2^T(W1^T(gelu'(h1) * W2^T(dy * ls2))).

    The rounding points of ``_mlp_dx_kernel`` (JAX block.py:1050-1059): h1 is
    recomputed as bf16(LN2(x2) @ W1) + bf16(bf1); dy*ls2 is rounded to the
    activation dtype, its product with W2^T is kept in f32, times gelu'(h1)
    rounded again; the product with W1^T is kept in f32; dx2 is rounded once.
    """
    dt = x2.dtype
    xf = x2.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    xhat = (xf - mu) * r
    m = (xhat * mp.g2.float() + mp.b2.float()).to(dt)
    h1 = _dense(m, mp.w1, mp.bf1)
    dyf = dy.float()
    dh2b = (dyf * mp.ls2.float()).to(dt)
    dg = dh2b.float() @ mp.w2.to(dt).float().t()
    dh1b = (dg * _gelu_grad(h1.float())).to(dt)
    dm = dh1b.float() @ mp.w1.to(dt).float().t()
    dh = dm * mp.g2.float()
    mean1 = dh.mean(dim=-1, keepdim=True)
    mean2 = (dh * xhat).mean(dim=-1, keepdim=True)
    return (dyf + r * (dh - mean1 - xhat * mean2)).to(dt)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _route(x: torch.Tensor) -> bool:
    """True -> launch the kernel; False -> the plain version (CPU only)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def _check_act(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernels take bf16 activations, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be a contiguous, 16-byte aligned (B, S, D) tensor")


def _check_params(x: torch.Tensor, p, shapes: dict[str, tuple[int, ...]], name: str) -> None:
    for field, shape in shapes.items():
        t = getattr(p, field)
        want = torch.bfloat16 if t.dim() == 2 else torch.float32
        if t.device != x.device or t.dtype != want:
            raise TypeError(f"{name}: {field} must be {want} on {x.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {field} must be a contiguous {shape} tensor, got {tuple(t.shape)}")


def _check_shapes(d: int, num_heads: int, s: int, name: str) -> None:
    if d % 64:
        raise ValueError(f"{name}: hidden size {d} is not a multiple of 64")
    if d % num_heads or d // num_heads not in (32, 64):
        raise ValueError(f"{name}: head width {d / num_heads} is not 32 or 64")
    smem = _ext.lib().dp_attention_smem_bytes(s, d // num_heads)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"{name}: S={s} needs {smem} B of shared memory for resident K/V "
            f"(limit {_SMEM_LIMIT}); long sequences take the flash-attention slice"
        )


def _check_ln_width(k: int, name: str) -> None:
    if _ext.lib().dp_gemm_smem_bytes(1, k) > _SMEM_LIMIT:
        raise ValueError(f"{name}: LayerNorm rows of width {k} do not fit shared memory")


def _attn_shapes(d: int) -> dict[str, tuple[int, ...]]:
    return {"g1": (d,), "b1": (d,), "wqkv": (d, 3 * d), "bqkv": (3 * d,),
            "wo": (d, d), "bo": (d,)}


def _mlp_shapes(d: int, hidden: int) -> dict[str, tuple[int, ...]]:
    return {"g2": (d,), "b2": (d,), "w1": (d, hidden), "bf1": (hidden,),
            "w2": (hidden, d), "bf2": (d,), "ls2": (d,)}


def _check_hidden(hidden: int, name: str) -> None:
    if hidden % 64:
        raise ValueError(f"{name}: MLP width {hidden} is not a multiple of 64")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """The forward kernels build no autograd graph: refuse to cut one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{name} has no backward, and an input requires grad; run it under "
            "torch.no_grad(), or use mlp_part_frozen for the LoRA layer's MLP half"
        )


def fused_block(
    x: torch.Tensor, p: BlockParams, num_heads: int, eps: float
) -> torch.Tensor:
    """Whole pre-norm block forward; replaces ``_block_kernel``
    (dino_pose_tpu/ops/block.py:159).

    Design: five launches — gemm<LN1 prologue, +bqkv> -> attention ->
    gemm<+bo, *ls1, +x> -> gemm<LN2 prologue, +bf1, GELU> ->
    gemm<+bf2, *ls2, +x2>. The TPU kernel keeps the block's 3.5 MB of weights
    and a few rows in VMEM; Hopper's 227 KB of shared memory cannot, so the
    block is split where a product's whole output tile is ready, and only
    qkv, ctx, x2 and the MLP hidden tensor pass through device memory (L2 at
    these sizes).

    Bound on an H100 at dinov2-small, S = 257: per image 1.011 GFLOP and
    3.54 MB of weights plus 2*S*D*2 B of activations — both ~1 us at batch 1
    (989 TFLOP/s bf16, 3.35 TB/s); operations bound it from batch 2 up.
    """
    name = "fused_block"
    _refuse_grad(name, x, *p)
    if not _route(x):
        return block_math(x, p, num_heads=num_heads, eps=eps)
    _check_act(x, name)
    b, s, d = x.shape
    hidden = p.w1.shape[-1]
    _check_shapes(d, num_heads, s, name)
    _check_hidden(hidden, name)
    _check_ln_width(d, name)
    _check_params(x, p, {**_attn_shapes(d), "ls1": (d,), **_mlp_shapes(d, hidden)}, name)
    qkv = torch.empty((b, s, 3 * d), dtype=x.dtype, device=x.device)
    ctx = torch.empty_like(x)
    x2 = torch.empty_like(x)
    hbuf = torch.empty((b, s, hidden), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    err = _ext.lib().dp_fused_block(
        *(t.data_ptr() for t in (x, *p, qkv, ctx, x2, hbuf, y)),
        b, s, d, num_heads, hidden, eps, _stream(),
    )
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return y


def fused_attn_part(
    x: torch.Tensor, ap: AttnParams, num_heads: int, eps: float
) -> torch.Tensor:
    """Attention half o = Wo*MHA(LN1(x)*Wqkv + bqkv) + bo (before
    LayerScale); replaces ``_attn_part_kernel`` (dino_pose_tpu/ops/block.py:999,
    body ``_attn_half_core`` :948).

    Design: three launches — gemm<LN1 prologue, +bqkv> -> attention (one
    block per batch row, head and 64-query tile; the head's K and V for all
    S keys in shared memory, f32 softmax, P rounded to bf16) -> gemm<+bo>.

    Bound on an H100 at S = 257, D = 384: 0.405 GFLOP per image and 2.36 MB
    of weights; bytes bound it at batch 1, operations from batch 2 up.
    """
    name = "fused_attn_part"
    _refuse_grad(name, x, *ap)
    if not _route(x):
        return attn_part_math(x, ap, num_heads=num_heads, eps=eps)
    _check_act(x, name)
    b, s, d = x.shape
    _check_shapes(d, num_heads, s, name)
    _check_ln_width(d, name)
    _check_params(x, ap, _attn_shapes(d), name)
    qkv = torch.empty((b, s, 3 * d), dtype=x.dtype, device=x.device)
    ctx = torch.empty_like(x)
    out = torch.empty_like(x)
    err = _ext.lib().dp_fused_attn_part(
        *(t.data_ptr() for t in (x, *ap, qkv, ctx, out)),
        b, s, d, num_heads, eps, _stream(),
    )
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return out


def fused_mlp_part(x2: torch.Tensor, mp: MlpParams, eps: float) -> torch.Tensor:
    """MLP half y = x2 + ls2*(W2*gelu(W1*LN2(x2) + bf1) + bf2); replaces
    ``_mlp_part_kernel`` (dino_pose_tpu/ops/block.py:1021).

    Design: two launches — gemm<LN2 prologue, +bf1, exact GELU (erff)> ->
    gemm<+bf2, *ls2, +x2>; the (B*S, 4D) hidden tensor is the only
    intermediate in device memory.

    Bound on an H100 at S = 257, D = 384: 0.606 GFLOP per image and 2.36 MB
    of weights; bytes bound it at batch 1, operations from batch 2 up.
    """
    name = "fused_mlp_part"
    _refuse_grad(name, x2, *mp)
    if not _route(x2):
        return mlp_part_math(x2, mp, eps=eps)
    _check_act(x2, name)
    b, s, d = x2.shape
    hidden = mp.w1.shape[-1]
    if d % 64:
        raise ValueError(f"{name}: hidden size {d} is not a multiple of 64")
    _check_hidden(hidden, name)
    _check_ln_width(d, name)
    _check_params(x2, mp, _mlp_shapes(d, hidden), name)
    hbuf = torch.empty((b, s, hidden), dtype=x2.dtype, device=x2.device)
    y = torch.empty_like(x2)
    err = _ext.lib().dp_fused_mlp_part(
        *(t.data_ptr() for t in (x2, *mp, hbuf, y)),
        b * s, d, hidden, eps, _stream(),
    )
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return y


def fused_mlp_dx(
    x2: torch.Tensor, dy: torch.Tensor, mp: MlpParams, eps: float
) -> torch.Tensor:
    """Activation-only backward of the MLP half, dx2 with no weight
    gradients; replaces ``_mlp_dx_kernel`` (dino_pose_tpu/ops/block.py:1044).

    Design: four launches — gemm<LN2 prologue, +bf1> recomputes h1 (JAX
    keeps only x2 and the weights as residuals) -> gemm_nt<dy*ls2 prologue,
    *gelu'(h1)> gives dh1b -> gemm_nt<f32 out> gives dm = dh1b W1^T -> a row
    kernel applies the LayerNorm backward and adds dy. gemm_nt reads the
    (in, out) weight transposed. h1 and dh1b (B*S, 4D) bf16 and dm (B*S, D)
    f32 pass through device memory.

    Bound on an H100 at S = 257, D = 384: 0.909 GFLOP per image (three
    products of 2*S*D*4D) and 3*B*S*D*2 bytes of activations plus 2.36 MB of
    weights; operations bound it from batch 2 up.
    """
    name = "fused_mlp_dx"
    if not _route(x2):
        return mlp_dx_math(x2, dy, mp, eps=eps)
    _check_act(x2, name)
    _check_act(dy, name)
    if dy.shape != x2.shape:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} and x2 {tuple(x2.shape)} differ")
    b, s, d = x2.shape
    hidden = mp.w1.shape[-1]
    if d % 64:
        raise ValueError(f"{name}: hidden size {d} is not a multiple of 64")
    _check_hidden(hidden, name)
    _check_ln_width(d, name)
    _check_params(x2, mp, _mlp_shapes(d, hidden), name)
    h1 = torch.empty((b, s, hidden), dtype=x2.dtype, device=x2.device)
    dh1b = torch.empty_like(h1)
    dm = torch.empty((b, s, d), dtype=torch.float32, device=x2.device)
    dx2 = torch.empty_like(x2)
    err = _ext.lib().dp_fused_mlp_dx(
        *(t.data_ptr() for t in (x2, dy, *mp, h1, dh1b, dm, dx2)),
        b * s, d, hidden, eps, _stream(),
    )
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return dx2


class _MlpPartFrozen(torch.autograd.Function):
    """``fused_mlp_part`` with the frozen-weight backward: dx2 from
    ``fused_mlp_dx``, no gradient for any MLP parameter. With
    ``kernels=False`` the plain versions of both."""

    @staticmethod
    def forward(ctx, x2, eps, kernels, *mp):
        if any(ctx.needs_input_grad[3:]):
            raise ValueError(
                "mlp_part_frozen: an MLP weight requires grad, but its backward "
                "gives the weights no gradient (assume_frozen_weights); the "
                "weight-gradient backward comes with the unfreeze-last-N slice"
            )
        ctx.save_for_backward(x2, *mp)
        ctx.eps, ctx.kernels = eps, kernels
        if kernels:
            return fused_mlp_part(x2, MlpParams(*mp), eps)
        return mlp_part_math(x2, MlpParams(*mp), eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x2, *mp = ctx.saved_tensors
        args = (x2, dy.contiguous(), MlpParams(*mp))
        dx2 = fused_mlp_dx(*args, ctx.eps) if ctx.kernels else mlp_dx_math(*args, eps=ctx.eps)
        return (dx2, None, None) + (None,) * len(mp)


def mlp_part_frozen(
    x2: torch.Tensor, mp: MlpParams, eps: float, *, kernels: bool = True
) -> torch.Tensor:
    """The LoRA layer's MLP half under autograd (JAX
    ``fused_mlp_part(..., assume_frozen_weights=True)``): the forward is
    ``fused_mlp_part``, the backward ``fused_mlp_dx`` (``kernels=False``:
    ``mlp_part_math`` and ``mlp_dx_math``); only x2 gets a gradient. Raises
    ``ValueError`` if an ``MlpParams`` tensor requires grad. Saves only
    (x2, mp) for the backward, as JAX does."""
    return _MlpPartFrozen.apply(x2, eps, kernels, *mp)


def block_flops(s: int, d: int, hidden: int | None = None) -> dict[str, int]:
    """Matrix-product FLOPs per image of each wrapper's function."""
    h = 4 * d if hidden is None else hidden
    attn = 2 * s * d * 3 * d + 4 * s * s * d + 2 * s * d * d
    mlp = 4 * s * d * h
    return {"fused_attn_part": attn, "fused_mlp_part": mlp, "fused_block": attn + mlp,
            "fused_mlp_dx": 6 * s * d * h}


def block_bytes(b: int, s: int, d: int, hidden: int | None = None) -> dict[str, int]:
    """Bytes each wrapper must move: bf16 weights and activations once, f32
    vectors."""
    h = 4 * d if hidden is None else hidden
    act = 2 * b * s * d * 2
    attn_w = (3 * d * d + d * d) * 2 + (2 * d + 3 * d + d) * 4
    mlp_w = 2 * d * h * 2 + (2 * d + h + d + d) * 4
    return {"fused_attn_part": act + attn_w, "fused_mlp_part": act + mlp_w,
            "fused_block": act + attn_w + mlp_w + d * 4,
            "fused_mlp_dx": 3 * b * s * d * 2 + mlp_w}


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time on an H100 SXM: max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s)."""
    t_ops = flops / 989e12 * 1e3
    t_mem = nbytes / 3.35e12 * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")

