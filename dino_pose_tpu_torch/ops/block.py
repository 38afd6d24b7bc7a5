"""Fused ViT block: plain PyTorch versions and the CUDA kernel wrappers
(counterpart of dino_pose_tpu/ops/block.py).

Fifteen functions of the dinov2 fine-tuning paths, each with its plain
version: nine of the frozen, LoRA and resident paths

==========================  =========================  =====================================
wrapper                     plain version              TPU kernel it replaces
==========================  =========================  =====================================
``fused_block``             ``block_math``             ``_block_kernel`` (block.py:159)
``fused_attn_part``         ``attn_part_math``         ``_attn_part_kernel`` (block.py:999)
``fused_mlp_part``          ``mlp_part_math``          ``_mlp_part_kernel`` (block.py:1021)
``fused_mlp_dx``            ``mlp_dx_math``            ``_mlp_dx_kernel`` (block.py:1044) and
                                                       ``_mlp_stream_dx_kernel`` (:1663)
``fused_block_train``       ``block_train_math``       ``_block_kernel``, training form (:592)
``fused_mlp_bwd``           ``mlp_bwd_math``           ``_mlp_bwd_kernel`` (block.py:284)
``fused_attn_bwd``          ``attn_bwd_math``          ``_attn_bwd_kernel`` (block.py:334)
``fused_attn_part_stream``  ``attn_part_stream_math``  ``_attn_stream_kernel`` (block.py:1807)
``fused_mlp_part_stream``   ``mlp_part_stream_math``   ``_mlp_stream_kernel`` (block.py:1636)
==========================  =========================  =====================================

and three of the trainable streamed halves (dinov2-base and -large):

===============================  ===============================  ==============================
wrapper                          plain version                    TPU kernels it replaces
===============================  ===============================  ==============================
``fused_mlp_part_stream_train``  ``mlp_part_stream_train_math``   ``_mlp_stream_train_kernel``
                                                                  (block.py:1695)
``fused_mlp_bwd_stream``         ``mlp_stream_bwd_math``          ``_mlp_stream_dx_full_kernel``
                                                                  (:1726) and
                                                                  ``_mlp_stream_dw_kernel`` (:1770)
``fused_attn_bwd_stream``        ``attn_stream_bwd_math``         ``_attn_stream_dx_kernel``
                                                                  (:1924) and
                                                                  ``_attn_stream_dw_kernel`` (:1973)
===============================  ===============================  ==============================

and three of one tensor-parallel shard (a ``'model'`` mesh axis of ``tp``
shards, ``core/mesh.py``):

============================  ===========================  ================================
wrapper                       plain version                TPU kernel it replaces
============================  ===========================  ================================
``fused_attn_part_partial``   ``attn_part_math_partial``   ``_attn_part_partial_kernel``
                                                           (block.py:1010)
``fused_mlp_part_partial``    ``mlp_part_math_partial``    ``_mlp_part_partial_kernel``
                                                           (block.py:1062)
``fused_mlp_partial_dx``      ``mlp_partial_dx_math``      ``_mlp_partial_dx_kernel``
                                                           (block.py:1099)
============================  ===========================  ================================

Eighteen TPU kernels: each streamed backward wrapper computes what its pair
of TPU kernels computes together (the TPU splits a backward into a dx pass
and a weight-gradient pass to fit VMEM), and ``_mlp_stream_dx_kernel`` computes
``_mlp_dx_kernel``'s function (up to the f32 summation order over hidden
blocks; it recomputes h1 as bf16(m W1) + bf16(bf1) and reads no rounding of
the forward), so ``fused_mlp_dx`` serves both.

The halves come in two roundings, as in the JAX package, and
:func:`block_route` picks between them as JAX's TPU dispatch does on one
device: the resident kernels (``_block_kernel``, ``_attn_part_kernel``,
``_mlp_part_kernel``; dinov2-small and -base) round each product to bf16 and
add the bias in bf16; the weight-streamed ones (dinov2-large) sum the
out-projection and fc2 in f32 and add the bias, and for fc2 multiply the
LayerScale, in f32 before one rounding. A trainable dinov2-base or -large
block takes the weight-streamed route too (JAX's
``stream_fused_enabled(..., for_training=True)``). Under a mesh whose
``'model'`` axis holds tp > 1 shards (``ops/dispatch.target_mesh``) a frozen
or LoRA block takes JAX's Megatron halves, route ``"tp"``
(:func:`attn_part_tp`, :func:`mlp_part_tp`): each shard runs the resident
rounding on its slice of the weights (:func:`shard_attn`, :func:`shard_mlp`)
and ends in a product with no bias, the mesh's ``all_reduce`` sums the
shards' partials (f32, one rounding), and the bias, LayerScale and residual
follow once in the activation dtype.

A wrapper takes its plain version only for tensors on the CPU. On a CUDA
tensor it launches the kernels of ``ops/csrc/block_kernels.cu`` or raises;
it never falls back. Each launch adds one to ``LAUNCHES[<wrapper name>]``.

Every wrapper takes any sequence length. The attention step of a chain keeps
the head's K and V resident in shared memory up to the resident route's
limits (S = 320 forward and 304 backward at head width 64, dinov2 at 224²),
and each such launch adds one to ``LAUNCHES["attn_fwd"]`` (a forward) or
``LAUNCHES["attn_bwd"]`` (a backward pair); past them it launches the
streamed kernels of ``ops/csrc/flash_kernels.cu`` (``_flash_kernel`` and
``_flash_bwd_kernel``'s counterparts, ``ops/attention.py``), counted under
``LAUNCHES["flash_fwd"]`` and ``["flash_bwd"]``. This is where the port departs
from the JAX route: at 504² (S = 1297) the JAX package runs ``block_math``
in every layer, XLA's dense products around its flash kernel; the port keeps
its GEMM chains, with ``block_math``'s rounding points, and puts the
streamed kernel in the middle. The same chains serve 280-448², where the
JAX package runs its resident, split or weight-streamed block kernels.

The forward wrappers return tensors without a graph, so they refuse inputs
that require grad while grad mode is on. Four autograd functions carry the
backward. :func:`mlp_part_frozen`, for the LoRA layer, is ``fused_mlp_part``
with a backward that carries dx2 through ``fused_mlp_dx`` and gives the
(frozen) MLP weights no gradient, as ``fused_mlp_part(...,
assume_frozen_weights=True)`` does in the JAX package;
:func:`mlp_part_partial_frozen` is its shard form (``fused_mlp_part_partial``,
backward ``fused_mlp_partial_dx``). :func:`block_train`,
for a block that trains whole (unfreeze-last-N), is ``fused_block_train``
with the backward ``fused_mlp_bwd`` then ``fused_attn_bwd``, which give dx
and every weight gradient in f32, as JAX's ``fused_block_train`` does.
:func:`attn_part_stream_train` and :func:`mlp_part_stream_train`, the
halves of a trainable dinov2-base or -large block, are the streamed
forwards with the backward ``fused_attn_bwd_stream`` and
``fused_mlp_bwd_stream``; the LayerScale and residual between them stay in
plain autograd, JAX's XLA stitch.

Parameter layouts match the JAX package: matrices are (in, out) and
``wqkv``/``bqkv`` hold q|k|v on the output axis. For the kernels, matrices
are bf16 and vectors (norm scales and biases, linear biases, LayerScales)
f32, as the module stores them; the kernels round biases and LayerScales to
bf16 where the JAX math casts them.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch

from dino_pose_tpu_torch.core.sharding import vit_block_dims
from dino_pose_tpu_torch.nn.layers import layer_norm
from dino_pose_tpu_torch.ops import _ext
from dino_pose_tpu_torch.ops.attention import plain_attention

LAUNCHES = _ext.LAUNCHES

# Rows per partial of the backward's column sums: a consumer warpgroup's
# rows in gemm_nt's epilogue sums, SUM_ROWS of the LayerNorm-backward row
# kernel.
_SUM_ROWS = 64


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


class AttnTrainParams(NamedTuple):
    """The attention half's parameters with its LayerScale: what
    ``fused_attn_bwd`` takes, and the gradients it returns."""

    g1: torch.Tensor
    b1: torch.Tensor
    wqkv: torch.Tensor
    bqkv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    ls1: torch.Tensor


class AttnPartialParams(NamedTuple):
    """One tensor-parallel shard's attention half (JAX block.py names): its
    heads' q|k|v columns and out-projection rows, no output bias."""

    g1: torch.Tensor     # (D,)
    b1: torch.Tensor     # (D,)
    wqkv: torch.Tensor   # (D, 3D/tp) as [q_l | k_l | v_l]
    bqkv: torch.Tensor   # (3D/tp,)
    wo: torch.Tensor     # (D/tp, D)


class MlpPartialParams(NamedTuple):
    """One shard's MLP half: its fc1 columns and fc2 rows, no fc2 bias."""

    g2: torch.Tensor     # (D,)
    b2: torch.Tensor     # (D,)
    w1: torch.Tensor     # (D, 4D/tp)
    bf1: torch.Tensor    # (4D/tp,)
    w2: torch.Tensor     # (4D/tp, D)


def _cut(t: torch.Tensor, dim: int, tp: int, r: int) -> torch.Tensor:
    """Block ``r`` of ``tp`` equal blocks of ``t`` along ``dim`` (a view)."""
    n = t.shape[dim] // tp
    return t.narrow(dim, r * n, n)


def shard_attn(ap: AttnParams, tp: int, r: int) -> AttnPartialParams:
    """Shard ``r`` of ``tp`` of an attention half, as JAX ``attn_part_tp``
    splits it (block.py:1351-1360) and ``core/sharding.VIT_TP_RULES`` gives
    the dims: q, k and v apart first, each cut along its output features
    into ``tp`` blocks and shard ``r``'s three concatenated back; ``wo``
    cut along its input features. The kernels hold the matrices transposed
    to (in, out), so torch's dim ``k`` is dim ``1 - k`` here. Cut from
    ``ap`` with its autograd (``wo`` a view)."""
    d = ap.wo.shape[0]
    if d % tp:
        raise ValueError(f"shard_attn: width {d} does not divide over {tp} shards")
    dims = vit_block_dims()
    w, b = ap.wqkv.split(d, dim=1), ap.bqkv.split(d)
    return AttnPartialParams(
        g1=ap.g1, b1=ap.b1, wqkv=torch.cat([_cut(t, 1 - dims["qkv"], tp, r) for t in w], dim=1),
        bqkv=torch.cat([_cut(t, dims["qkv_bias"], tp, r) for t in b]),
        wo=_cut(ap.wo, 1 - dims["out"], tp, r))


def shard_mlp(mp: MlpParams, tp: int, r: int) -> MlpPartialParams:
    """Shard ``r`` of ``tp`` of an MLP half, as JAX ``mlp_part_tp`` splits
    it and ``core/sharding.VIT_TP_RULES`` gives the dims: ``w1``/``bf1``
    along fc1's output features, ``w2`` along fc2's input features (the
    matrices transposed, as in :func:`shard_attn`)."""
    h = mp.w1.shape[-1]
    if h % tp:
        raise ValueError(f"shard_mlp: hidden width {h} does not divide over {tp} shards")
    dims = vit_block_dims()
    return MlpPartialParams(g2=mp.g2, b2=mp.b2, w1=_cut(mp.w1, 1 - dims["fc1"], tp, r),
                            bf1=_cut(mp.bf1, dims["fc1_bias"], tp, r),
                            w2=_cut(mp.w2, 1 - dims["fc2"], tp, r))


def attn_params(p: BlockParams) -> AttnParams:
    return AttnParams(p.g1, p.b1, p.wqkv, p.bqkv, p.wo, p.bo)


def attn_train_params(p: BlockParams) -> AttnTrainParams:
    return AttnTrainParams(p.g1, p.b1, p.wqkv, p.bqkv, p.wo, p.bo, p.ls1)


def mlp_params(p: BlockParams) -> MlpParams:
    return MlpParams(p.g2, p.b2, p.w1, p.bf1, p.w2, p.bf2, p.ls2)


def cast_params(p, dtype: torch.dtype):
    """The kernels' layout of a block's (or a half's) parameters, the same
    named tuple (JAX ``_prep_block_args``): matrices in ``dtype``, vectors
    f32, all contiguous. Differentiable: the casts of trainable parameters
    carry their gradients back in the parameters' own dtype."""
    return type(p)(*(
        t.to(dtype).contiguous() if t.dim() == 2 else t.float().contiguous() for t in p
    ))


# ---------------------------------------------------------------------------
# Plain versions (the JAX rounding points: each product is cast to the
# activation dtype, then the bias is added in that dtype)
# ---------------------------------------------------------------------------

def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (x @ w.to(x.dtype)).to(x.dtype) + b.to(x.dtype)


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x.float(), approximate="none").to(x.dtype)


def _dense_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The streamed kernels' output product: x @ w summed in f32 with the
    f32 bias added, not yet rounded."""
    return x.float() @ w.to(x.dtype).float() + b.float()


def _heads_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    q, k, v = (t.reshape(b, s, num_heads, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
    return plain_attention(q, k, v, dh**-0.5).transpose(1, 2).reshape(b, s, d)


# The chains' GEMM epilogues (block_kernels.cu ``Epilogue``), by name.
EPILOGUES = ("bias", "bias_gelu", "bias_ls_res", "bias_gelu_pair", "f32bias",
             "f32bias_ls_res", "f32bias_ls_res_h2", "none")
# Epilogues that write a second output: the GELU pair (h, gelu(h)) and the
# streamed fc2's (y, h2).
PAIRED = ("bias_gelu_pair", "f32bias_ls_res_h2")


def gemm_math(a: torch.Tensor, w: torch.Tensor, epi: str, bias: torch.Tensor | None = None,
              ls: torch.Tensor | None = None, res: torch.Tensor | None = None):
    """The plain version of one product of the chains, ``epilogue(a @ w)``,
    at its rounding points: the ``bias*`` modes round the product to a's
    dtype and add the bias rounded to it (``_dense``), then GELU in f32
    rounded once, or ``res + o * ls`` in a's dtype; the ``f32bias*`` modes
    add the f32 bias (and multiply ls) to the f32 sum and round once, then
    add ``res``; ``none`` rounds the product. The paired modes return
    (out, out2): (h, gelu(h)) and (y, h2)."""
    dt = a.dtype
    if epi == "none":
        return (a @ w.to(dt)).to(dt)
    if epi.startswith("f32bias"):
        o = _dense_f32(a, w, bias)
        if epi == "f32bias":
            return o.to(dt)
        y = res + (o * ls.float()).to(dt)
        return (y, o.to(dt)) if epi == "f32bias_ls_res_h2" else y
    o = _dense(a, w, bias)
    if epi == "bias_gelu":
        return _gelu_exact(o)
    if epi == "bias_gelu_pair":
        return o, _gelu_exact(o)
    if epi == "bias_ls_res":
        return res + o * ls.to(dt)
    return o


def gemm_cost(m: int, n: int, k: int, epi: str = "none") -> tuple[int, int]:
    """(FLOPs, bytes) of one (m, k) @ (k, n) bf16 product with epilogue
    ``epi``: 2mnk FLOPs; a, w and the output once, the f32 bias and ls
    vectors, the residual and a second output where the epilogue has them."""
    nbytes = 2 * (m * k + k * n + m * n)
    if epi != "none":
        nbytes += 4 * n
    if "ls_res" in epi:
        nbytes += 4 * n + 2 * m * n
    if epi in PAIRED:
        nbytes += 2 * m * n
    return 2 * m * n * k, nbytes


# The backward products' epilogues (block_kernels.cu ``EpilogueNT``), by
# name: bf16(acc * gelu'(aux)), the f32 sums, bf16(acc).
EPILOGUES_NT = ("gelu_grad", "f32", "bf16")


def scale_rows_math(a: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The chains' scaled cotangent, a * scale[k] in f32 rounded once to a's
    dtype (bf16(dy * ls2), bf16(dx2 * ls1)): the plain version of
    ``scale_rows_kernel``."""
    return (a.float() * scale.float()).to(a.dtype)


def gemm_nt_math(a: torch.Tensor, w: torch.Tensor, epi: str, *,
                 scale: torch.Tensor | None = None, aux: torch.Tensor | None = None,
                 colsum: bool = False):
    """The plain version of one backward product, ``epilogue(a' @ w^T)``:
    w a forward weight stored (N, K), read transposed; a' = a, or
    ``scale_rows_math(a, scale)``. The f32 sum acc, then ``gelu_grad``
    bf16(acc * gelu'(aux)) (aux (M, N) in a's dtype), ``f32`` acc itself,
    ``bf16`` bf16(acc). With ``colsum`` also the f32 column sums of the
    values before rounding: (out, sums)."""
    dt = a.dtype
    if scale is not None:
        a = scale_rows_math(a, scale)
    acc = a.float() @ w.to(dt).float().t()
    if epi == "gelu_grad":
        acc = acc * _gelu_grad(aux.float())
    out = acc if epi == "f32" else acc.to(dt)
    return (out, _colsum(acc)) if colsum else out


def gemm_tn_math(a: torch.Tensor, g: torch.Tensor, *, scale: torch.Tensor | None = None,
                 gsum: bool = False):
    """The plain version of one weight-gradient product, dW = a^T g' summed
    in f32 over every row (``_tmm``), g' = g or ``scale_rows_math(g,
    scale)``; with ``gsum`` also the f32 column sums of g': (dW, sums)."""
    if scale is not None:
        g = scale_rows_math(g, scale)
    dw = _tmm(a, g)
    return (dw, _colsum(g)) if gsum else dw


def gemm_nt_cost(m: int, n: int, k: int, epi: str = "bf16",
                 colsum: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward product (m, k) @ (n, k)^T: 2mnk FLOPs;
    a, w and the output once (f32 for ``f32``), aux for ``gelu_grad``, the
    f32 column sums where asked."""
    nbytes = 2 * (m * k + n * k) + (4 if epi == "f32" else 2) * m * n
    if epi == "gelu_grad":
        nbytes += 2 * m * n
    if colsum:
        nbytes += 4 * n
    return 2 * m * n * k, nbytes


def gemm_tn_cost(m: int, k_in: int, n: int, gsum: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one weight-gradient product (m, k_in)^T @ (m, n):
    2 m k_in n FLOPs; a and g once, the f32 dW (and g's column sums)."""
    nbytes = 2 * m * (k_in + n) + 4 * k_in * n + (4 * n if gsum else 0)
    return 2 * m * k_in * n, nbytes


def attn_part_math(
    x: torch.Tensor, ap: AttnParams, *, num_heads: int, eps: float
) -> torch.Tensor:
    """LN1 -> qkv -> multi-head attention -> out-projection + bias
    (before LayerScale, without the residual)."""
    qkv = _dense(layer_norm(x, ap.g1, ap.b1, eps), ap.wqkv, ap.bqkv)
    return _dense(_heads_attention(qkv, num_heads), ap.wo, ap.bo)


def mlp_part_math(x2: torch.Tensor, mp: MlpParams, *, eps: float) -> torch.Tensor:
    """LN2 -> fc1 -> exact GELU -> fc2 -> LayerScale -> residual."""
    h = _gelu_exact(_dense(layer_norm(x2, mp.g2, mp.b2, eps), mp.w1, mp.bf1))
    h = _dense(h, mp.w2, mp.bf2)
    return x2 + h * mp.ls2.to(h.dtype)


def attn_part_stream_math(
    x: torch.Tensor, ap: AttnParams, *, num_heads: int, eps: float
) -> torch.Tensor:
    """``attn_part_math``'s function at ``_attn_stream_kernel``'s rounding
    points (JAX block.py:1807-1865): LN1 and qkv = bf16(a Wqkv) + bf16(bqkv)
    in the activation dtype, the attention as ``attn_part_math``'s, then the
    out-projection summed in f32 with bo added in f32 and rounded once."""
    qkv = _dense(layer_norm(x, ap.g1, ap.b1, eps), ap.wqkv, ap.bqkv)
    ctx = _heads_attention(qkv, num_heads)
    return _dense_f32(ctx, ap.wo, ap.bo).to(x.dtype)


def mlp_part_stream_math(x2: torch.Tensor, mp: MlpParams, *, eps: float) -> torch.Tensor:
    """``mlp_part_math``'s function at ``_mlp_stream_kernel``'s rounding
    points (JAX block.py:1636-1660): LN2, h1 = bf16(m W1) + bf16(bf1) and
    its exact GELU in the activation dtype; fc2 summed in f32, bf2 added and
    ls2 multiplied in f32 and rounded once: y = x2 + bf16((g W2 + bf2) ls2)."""
    return mlp_part_stream_train_math(x2, mp, eps=eps)[0]


def mlp_part_stream_train_math(
    x2: torch.Tensor, mp: MlpParams, *, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """``mlp_part_stream_math``'s y and the pre-LayerScale output the
    streamed backward reads, (y, h2): ``_mlp_stream_train_kernel`` (JAX
    block.py:1695-1723), h2 = bf16(g W2 + bf2) from the same f32 sum that
    y = x2 + bf16((g W2 + bf2) ls2) rounds once."""
    h = _gelu_exact(_dense(layer_norm(x2, mp.g2, mp.b2, eps), mp.w1, mp.bf1))
    h2 = _dense_f32(h, mp.w2, mp.bf2)
    return x2 + (h2 * mp.ls2.float()).to(x2.dtype), h2.to(x2.dtype)


def block_train_math(
    x: torch.Tensor, p: BlockParams, *, num_heads: int, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block and its attention residual: (y, x2) with
    x2 = x + ls1*attn(x), y = x2 + ls2*mlp(x2)."""
    o = attn_part_math(x, attn_params(p), num_heads=num_heads, eps=eps)
    x2 = x + o * p.ls1.to(o.dtype)
    return mlp_part_math(x2, mlp_params(p), eps=eps), x2


def block_math(
    x: torch.Tensor, p: BlockParams, *, num_heads: int, eps: float
) -> torch.Tensor:
    """One pre-norm block: x2 = x + ls1*attn(x); y = x2 + ls2*mlp(x2)."""
    return block_train_math(x, p, num_heads=num_heads, eps=eps)[0]


def _gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz of exact GELU at z (f32 in and out)."""
    phi = torch.exp(-0.5 * z * z) * 0.3989422804014327  # 1/sqrt(2*pi)
    cdf = 0.5 * (1.0 + torch.erf(z * 2.0**-0.5))
    return cdf + z * phi


def _ln_fwd(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float):
    """LayerNorm with its f32 statistics: (out in x's dtype, xhat, r)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    xhat = (xf - mu) * r
    return (xhat * g.float() + b.float()).to(x.dtype), xhat, r


def _ln_bwd(dout: torch.Tensor, xhat: torch.Tensor, r: torch.Tensor,
            g: torch.Tensor) -> torch.Tensor:
    """Input cotangent of LayerNorm (f32)."""
    dh = dout * g.float()
    mean1 = dh.mean(dim=-1, keepdim=True)
    mean2 = (dh * xhat).mean(dim=-1, keepdim=True)
    return r * (dh - mean1 - xhat * mean2)


def _colsum(t: torch.Tensor) -> torch.Tensor:
    """f32 sum over every row (all axes but the last)."""
    return t.float().reshape(-1, t.shape[-1]).sum(0)


def _tmm(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """a^T g over every row, in f32: the weight-gradient product."""
    return a.float().reshape(-1, a.shape[-1]).t() @ g.float().reshape(-1, g.shape[-1])


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
    m, xhat, r = _ln_fwd(x2, mp.g2, mp.b2, eps)
    h1 = _dense(m, mp.w1, mp.bf1)
    dyf = dy.float()
    dh2b = (dyf * mp.ls2.float()).to(dt)
    dg = dh2b.float() @ mp.w2.to(dt).float().t()
    dh1b = (dg * _gelu_grad(h1.float())).to(dt)
    dm = dh1b.float() @ mp.w1.to(dt).float().t()
    return (dyf + _ln_bwd(dm, xhat, r, mp.g2)).to(dt)


def attn_part_math_partial(
    x: torch.Tensor, pp: AttnPartialParams, *, num_heads: int, eps: float
) -> torch.Tensor:
    """One shard's attention half (JAX block.py:917-937): LN1 -> its qkv
    columns + bias -> its ``num_heads`` local heads -> the product with its
    out-projection rows, rounded once, with no bias."""
    qkv = _dense(layer_norm(x, pp.g1, pp.b1, eps), pp.wqkv, pp.bqkv)
    ctx = _heads_attention(qkv, num_heads)
    return (ctx @ pp.wo.to(ctx.dtype)).to(ctx.dtype)


def mlp_part_math_partial(x2: torch.Tensor, pp: MlpPartialParams, *, eps: float) -> torch.Tensor:
    """One shard's MLP half (JAX block.py:940-945): LN2 -> its fc1 columns
    + bias -> exact GELU -> the product with its fc2 rows, rounded once; no
    fc2 bias, LayerScale or residual."""
    h = _gelu_exact(_dense(layer_norm(x2, pp.g2, pp.b2, eps), pp.w1, pp.bf1))
    return (h @ pp.w2.to(h.dtype)).to(h.dtype)


def mlp_partial_dx_math(
    x2: torch.Tensor, dp: torch.Tensor, pp: MlpPartialParams, *, eps: float
) -> torch.Tensor:
    """Input cotangent of ``mlp_part_math_partial`` with the weights held
    fixed, given ``dp``, the cotangent of the shard's partial product
    (already times ls2): dx2 = LN2^T(W1^T(gelu'(h1) * W2^T dp)), with no
    residual term. ``mlp_dx_math`` without the LayerScale and without + dy:
    the rounding points of ``_mlp_partial_dx_kernel`` (JAX block.py:1099-1115),
    h1 recomputed as bf16(LN2(x2) W1) + bf16(bf1), dp W2^T kept in f32, times
    gelu'(h1) rounded, the product with W1^T in f32, dx2 rounded once."""
    dt = x2.dtype
    m, xhat, r = _ln_fwd(x2, pp.g2, pp.b2, eps)
    h1 = _dense(m, pp.w1, pp.bf1)
    dg = dp.to(dt).float() @ pp.w2.to(dt).float().t()
    dh1b = (dg * _gelu_grad(h1.float())).to(dt)
    dm = dh1b.float() @ pp.w1.to(dt).float().t()
    return _ln_bwd(dm, xhat, r, pp.g2).to(dt)


def mlp_bwd_math(
    x2: torch.Tensor, dy: torch.Tensor, mp: MlpParams, *, eps: float
) -> tuple[torch.Tensor, MlpParams]:
    """Backward of y = x2 + ls2*(gelu(LN2(x2) W1 + bf1) W2 + bf2): dx2 and
    the gradient of every ``MlpParams`` field, summed in f32 over all rows.

    The rounding points of ``_mlp_bwd_kernel`` (JAX block.py:284-317): h1,
    g = gelu(h1) and h2 recomputed in the activation dtype; dh2 = dy*ls2 in
    f32, rounded for the products; dg, dh1 and dm f32, dh1 rounded for the
    products; the bias gradients sum the unrounded f32 dh1 and dh2.
    """
    return _mlp_bwd(x2, dy, mp, eps, None)


def mlp_stream_bwd_math(
    x2: torch.Tensor, dy: torch.Tensor, h2: torch.Tensor, mp: MlpParams, *, eps: float
) -> tuple[torch.Tensor, MlpParams]:
    """``mlp_bwd_math`` on the streamed route, given the forward's saved
    pre-LayerScale output h2 (``mlp_part_stream_train_math``): JAX
    ``_mlp_stream_bwd`` (block.py:2217-2265), its kernels
    ``_mlp_stream_dx_full_kernel`` (dx2, dg2, db2) and ``_mlp_stream_dw_kernel``
    (dW1, dbf1, dW2) (:1726-1804) at ``_mlp_bwd_kernel``'s rounding points
    (h1 and g recomputed in the activation dtype, dy*ls2 and dh1 rounded for
    the products, dbf1 summing the f32 dh1), and its XLA reductions dls2 =
    sum(dy*h2) on the saved h2 and dbf2 = ls2 * sum(dy), in f32."""
    return _mlp_bwd(x2, dy, mp, eps, h2)


def _mlp_bwd(x2, dy, mp: MlpParams, eps: float, saved_h2: torch.Tensor | None):
    """The two MLP backward rounding routes: h2 recomputed (``saved_h2``
    None, the resident kernel) or read from the forward (the streamed one)."""
    dt = x2.dtype
    m, xhat, r = _ln_fwd(x2, mp.g2, mp.b2, eps)
    h1 = _dense(m, mp.w1, mp.bf1)
    g = _gelu_exact(h1)
    h2 = _dense(g, mp.w2, mp.bf2) if saved_h2 is None else saved_h2
    dyf = dy.float()
    dh2 = dyf * mp.ls2.float()
    dh2b = dh2.to(dt)
    dg = dh2b.float() @ mp.w2.to(dt).float().t()
    dh1 = dg * _gelu_grad(h1.float())
    dh1b = dh1.to(dt)
    dm = dh1b.float() @ mp.w1.to(dt).float().t()
    dx2 = (dyf + _ln_bwd(dm, xhat, r, mp.g2)).to(dt)
    dbf2 = _colsum(dh2) if saved_h2 is None else mp.ls2.float() * _colsum(dyf)
    return dx2, MlpParams(
        g2=_colsum(dm * xhat), b2=_colsum(dm), w1=_tmm(m, dh1b), bf1=_colsum(dh1),
        w2=_tmm(g, dh2b), bf2=dbf2, ls2=_colsum(dyf * h2.float()),
    )


def attn_bwd_math(
    x: torch.Tensor, dx2: torch.Tensor, atp: AttnTrainParams, *, num_heads: int, eps: float
) -> tuple[torch.Tensor, AttnTrainParams]:
    """Backward of x2 = x + ls1*(MHA(LN1(x) Wqkv + bqkv) Wo + bo): dx and the
    gradient of every ``AttnTrainParams`` field, summed in f32 over all rows.

    The rounding points of ``_attn_bwd_kernel`` (JAX block.py:349-404): qkv,
    ctx and o recomputed in the activation dtype, the probabilities P in f32;
    do = dx2*ls1 in f32, rounded for the products; dctx rounded; dP and dS
    f32, dS rounded for dq and dk, P rounded for dv; dq, dk, dv rounded; da
    f32. The bias gradients sum the unrounded do and the rounded dqkv.
    """
    return _attn_bwd(x, dx2, atp, atp.ls1, num_heads, eps)


def attn_stream_bwd_math(
    x: torch.Tensor, do: torch.Tensor, ap: AttnParams, *, num_heads: int, eps: float
) -> tuple[torch.Tensor, AttnParams]:
    """Backward of o = MHA(LN1(x) Wqkv + bqkv) Wo + bo under the streamed
    route's pre-LayerScale contract: ``do`` is the cotangent of o itself
    (bf16, the stitch's ``x + o*ls1`` has already scaled it), the LayerScale
    and the residual live outside. JAX ``_attn_stream_bwd`` (block.py:2389-
    2468) with ``_attn_stream_dx_kernel`` (dx = LN1^T(da) with no residual,
    dg1, db1) and ``_attn_stream_dw_kernel`` (dWqkv, dbqkv, dWo) (:1868-2012),
    at ``attn_bwd_math``'s rounding points with dob = do, and its XLA dbo =
    sum(do) in f32. Returns dx and the gradient of every ``AttnParams``
    field."""
    return _attn_bwd(x, do, ap, None, num_heads, eps)


def packed_attention_bwd_math(qkv: torch.Tensor, dctx: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """The attention step's backward on the chains' packed layout: dqkv (B,
    S, 3D) from qkv (B, S, 3D), q|k|v on the last axis, and the cotangent of
    ctx, dctx (B, S, D). The per-head loop of ``_attn_bwd_kernel`` (JAX
    block.py:384-397) at its rounding points: the probabilities P in f32
    (recomputed from q and k), dP = dO V^T and dS = P * (dP - rowsum(P * dP))
    in f32, dS rounded for dq = dS K * scale and dk = dS^T Q * scale, P
    rounded for dv = P^T dO; dq, dk, dv rounded. The plain version of
    ``packed_attention_bwd`` and of the backward chains' attention step."""
    dt = qkv.dtype
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    scale = dh**-0.5

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, s, num_heads, dh).transpose(1, 2).float()

    def merge(t: torch.Tensor) -> torch.Tensor:
        return t.transpose(1, 2).reshape(b, s, d).to(dt)

    q, k, v = (heads(t) for t in qkv.split(d, dim=-1))
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    pb = p.to(dt).float()
    do = heads(dctx)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dsb = ds.to(dt).float()
    return torch.cat([merge((dsb @ k) * scale), merge((dsb.transpose(-1, -2) @ q) * scale),
                      merge(pb.transpose(-1, -2) @ do)], dim=-1)


def _attn_bwd(x, dres, ap, ls1: torch.Tensor | None, num_heads: int, eps: float):
    """The two attention backward routes: ``dres`` is dx2 and the LayerScale
    ``ls1`` scales it (the resident kernel, its residual added to dx), or,
    with ``ls1`` None, the pre-LayerScale cotangent do (the streamed one).
    The attention step's dqkv is ``packed_attention_bwd_math``'s."""
    dt = x.dtype
    a, xhat, r = _ln_fwd(x, ap.g1, ap.b1, eps)
    qkv = _dense(a, ap.wqkv, ap.bqkv)
    ctx = _heads_attention(qkv, num_heads)
    if ls1 is None:
        do = dres.float()
        dob = dres
    else:
        dx2f = dres.float()
        do = dx2f * ls1.float()
        dob = do.to(dt)
    dctx = (dob.float() @ ap.wo.to(dt).float().t()).to(dt)
    dqkv = packed_attention_bwd_math(qkv, dctx, num_heads)
    da = dqkv.float() @ ap.wqkv.to(dt).float().t()
    dln = _ln_bwd(da, xhat, r, ap.g1)
    grads = dict(g1=_colsum(da * xhat), b1=_colsum(da), wqkv=_tmm(a, dqkv), bqkv=_colsum(dqkv),
                 wo=_tmm(ctx, dob), bo=_colsum(do))
    if ls1 is None:
        return dln.to(dt), AttnParams(**grads)
    o = _dense(ctx, ap.wo, ap.bo)
    return (dx2f + dln).to(dt), AttnTrainParams(**grads, ls1=_colsum(dx2f * o.float()))


# ---------------------------------------------------------------------------
# The rounding route (the JAX package's single-device TPU block dispatch)
# ---------------------------------------------------------------------------

_MIB = 1024 * 1024


def _whole_block_fits(d: int, sp: int, hidden: int, itemsize: int) -> bool:
    """JAX ``fused_blocks_enabled`` on one TPU: ratio-4 MLP, D <= 512 and at
    least one batch row beside the weights in 10 MiB (``_rows_per_program``)."""
    if hidden != 4 * d or d > 512:
        return False
    weights = 4 * d * d * itemsize + 2 * d * hidden * itemsize
    per_row = 9 * sp * d * itemsize + 2 * sp * hidden * itemsize + sp * sp * 4
    return (10 * _MIB - weights) // max(1, per_row) >= 1


def _halves_fit(d: int, sp: int, hidden: int, itemsize: int, tp: int = 1) -> bool:
    """JAX ``parts_fused_enabled``: each resident half's forward working set
    within 13 MiB, its weights and hidden tensor divided over ``tp`` model
    shards (block.py:2566-2590)."""
    attn = 8 * d * d * itemsize // tp + 7 * sp * d * itemsize + 2 * sp * sp * 4
    mlp = 2 * d * hidden * itemsize // tp + 3 * sp * d * itemsize + sp * hidden * itemsize // tp
    return max(attn, mlp) <= 13 * _MIB


def _stream_plans_exist(d: int, sp: int, num_heads: int, hidden: int, itemsize: int) -> bool:
    """JAX ``_stream_mlp_plan`` and ``_stream_attn_plan`` at batch 1 (one row
    a program): some hidden block, and the head group
    ``_attn_heads_per_block`` gives, fit the streaming budget of 16 MiB."""
    i = itemsize
    mlp = any(
        hidden % bh == 0
        and sp * d * (5 * i + 8) + sp * bh * (i + 4) + 4 * d * bh * i <= 16 * _MIB
        for bh in (2048, 1024, 512, 256)
    )
    dh = d // num_heads
    hpb = max(1, -(-128 // dh))
    while hpb <= num_heads and (num_heads % hpb or (hpb * dh) % 128):
        hpb += 1
    if hpb > num_heads:
        return False
    gw = hpb * dh
    attn = sp * d * (5 * i + 8) + sp * sp * 4 + 8 * sp * gw * i + 8 * d * gw * i
    return mlp and attn <= 16 * _MIB


def block_route(d: int, s: int, num_heads: int, hidden: int, itemsize: int, *,
                lora: bool, training: bool, tp: int = 1) -> str:
    """The rounding route of one dinov2 block: the one JAX's TPU dispatch
    takes (``models/vit.py:276-342`` with ``fused_blocks_enabled``,
    ``parts_fused_enabled`` and ``stream_fused_enabled``, ``ops/block.py``)
    on one device, or under a mesh of ``tp`` model shards.

    It picks JAX's rounding points, not a VMEM plan: the byte models only
    decide, as on the TPU, which of its kernels a block of this shape takes.
    ``"block"`` where JAX takes a resident kernel (``_block_kernel``, or the
    halves ``_attn_part_kernel`` + XLA stitch + ``_mlp_part_kernel``: the
    same rounding), ``"stream"`` where it takes the weight-streamed halves,
    ``"math"`` where it runs its XLA ``block_math`` or the halves' math,
    which round like ``"block"``. ``lora``: the block holds a LoRA adapter
    (its route ignores ``training``); ``training``: a non-LoRA block whose
    weights train in this pass. At 224² (S = 257) in bf16: dinov2-small
    ``"block"``, dinov2-base ``"block"`` (``"stream"`` when training),
    dinov2-large ``"stream"``; at S = 1297 all three ``"math"``.

    With ``tp > 1`` (a mesh of one batch shard): JAX turns down the whole
    block and the streamed halves on any mesh with a model axis, so a
    frozen or LoRA block takes ``"tp"``, the Megatron halves
    (``_tp_shard_mesh``, ``attn_part_tp``/``mlp_part_tp``), where the heads
    and the MLP width divide over the shards and the tp-divided byte model
    fits, and ``"math"`` otherwise, as does a block that trains whole. At
    224² in bf16 dinov2-base and -large take ``"tp"`` at tp 2 and 4,
    dinov2-small at tp 2 (its 6 heads do not divide over 4); at S = 1297
    ``"math"``.

    ``DINO_POSE_TPU_BLOCK`` is read at call time, as JAX's three gates read
    it (``fused_blocks_enabled``, ``stream_fused_enabled``,
    ``parts_fused_enabled``, ops/block.py:2650-2675, :2513-2517,
    :2557-2561): ``unfused``/``xla`` close all three (``"math"``);
    ``fused``/``pallas`` open the whole-block gate at any shape (``"block"``;
    under a mesh a frozen block keeps the whole kernel over its data shard, a
    trainable one gives way to ``block_math``, a LoRA block takes the TP
    halves without a fit); ``parts`` sizes the halves on one device's
    byte model; ``stream`` opens the streamed gate, which the halves' gate
    precedes, so it moves no route of the TPU dispatch. Every route still
    runs the port's kernel chains on the card."""
    sp = -(-s // 8) * 8
    override = os.environ.get("DINO_POSE_TPU_BLOCK", "").lower()
    if override in ("unfused", "xla"):
        return "math"
    forced = override in ("fused", "pallas") and hidden == 4 * d
    if tp > 1:
        if forced and not lora:
            return "math" if training else "block"
        if (training and not lora) or num_heads % tp or hidden % tp:
            return "math"
        fits = _halves_fit(d, sp, hidden, itemsize, 1 if override == "parts" else tp)
        return "tp" if forced or fits else "math"
    if forced or _whole_block_fits(d, sp, hidden, itemsize):
        return "block"
    streams = _stream_plans_exist(d, sp, num_heads, hidden, itemsize)
    if training and not lora:
        return "stream" if streams else "math"
    if _halves_fit(d, sp, hidden, itemsize):
        return "block"
    return "stream" if streams else "math"


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


def _count_attention(s: int, dh: int, backward: bool = False) -> None:
    """Count the attention step's kernels inside a chain: the streamed
    forward (and backward pair) past the resident route's limits, else the
    resident ones (``LAUNCHES["attn_fwd"]``, ``["attn_bwd"]``). A backward
    chain recomputes its forward on the route of its backward."""
    lib = _ext.lib()
    flash = lib.dp_flash_backward(s, dh) if backward else lib.dp_flash_forward(s, dh)
    LAUNCHES["flash_fwd" if flash else "attn_fwd"] += 1
    if backward:
        LAUNCHES["flash_bwd" if flash else "attn_bwd"] += 1


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


def _check_shapes(d: int, num_heads: int, name: str) -> None:
    if d % 64:
        raise ValueError(f"{name}: hidden size {d} is not a multiple of 64")
    if d % num_heads or d // num_heads not in (32, 64):
        raise ValueError(f"{name}: head width {d / num_heads} is not 32 or 64")


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

    Design: seven launches — LN1 rows -> gemm<+bqkv> -> attention (K/V
    resident, or streamed past S ~ 320) -> gemm<+bo, *ls1, +x> -> LN2 rows
    -> gemm<+bf1, GELU> -> gemm<+bf2, *ls2, +x2>, each gemm the wgmma/TMA
    kernel of ``block_kernels.cu``. The TPU kernel keeps the block's 3.5 MB
    of weights and a few rows in VMEM; Hopper's 227 KB of shared memory
    cannot, so the block is split where a product's whole output tile is
    ready, and only the normalised rows, qkv, ctx, x2 and the MLP hidden
    tensor pass through device memory (L2 at these sizes).

    Bound on an H100 at dinov2-small, S = 257: per image 1.011 GFLOP and
    3.54 MB of weights plus 2*S*D*2 B of activations — both ~1 us at batch 1
    (989 TFLOP/s bf16, 3.35 TB/s); operations bound it from batch 2 up.
    """
    name = "fused_block"
    _refuse_grad(name, x, *p)
    if not _route(x):
        return block_math(x, p, num_heads=num_heads, eps=eps)
    return _launch_block(x, p, num_heads, eps, name)[0]


def fused_block_train(
    x: torch.Tensor, p: BlockParams, num_heads: int, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole block forward that also returns the attention residual x2, the
    one activation the training backward keeps: (y, x2). Replaces
    ``_block_kernel`` in its training form (dino_pose_tpu/ops/block.py:592,
    ``_fused_forward_train``).

    Design: the launches of ``fused_block``, whose chain already writes x2 to
    a buffer of the caller's; here that buffer is returned. Bound as
    ``fused_block``, plus B*S*D*2 bytes for x2.
    """
    name = "fused_block_train"
    _refuse_grad(name, x, *p)
    if not _route(x):
        return block_train_math(x, p, num_heads=num_heads, eps=eps)
    return _launch_block(x, p, num_heads, eps, name)


def _launch_block(x: torch.Tensor, p: BlockParams, num_heads: int, eps: float,
                  name: str) -> tuple[torch.Tensor, torch.Tensor]:
    _check_act(x, name)
    b, s, d = x.shape
    hidden = p.w1.shape[-1]
    _check_shapes(d, num_heads, name)
    _check_hidden(hidden, name)
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
    _count_attention(s, d // num_heads)
    return y, x2


def fused_attn_part(
    x: torch.Tensor, ap: AttnParams, num_heads: int, eps: float
) -> torch.Tensor:
    """Attention half o = Wo*MHA(LN1(x)*Wqkv + bqkv) + bo (before
    LayerScale); replaces ``_attn_part_kernel`` (dino_pose_tpu/ops/block.py:999,
    body ``_attn_half_core`` :948).

    Design: four launches — LN1 rows (once, into the output buffer) ->
    gemm<+bqkv> -> attention (one block per batch row, head and 64-query
    tile; the head's K and V for all S keys in shared memory, f32 softmax,
    P rounded to bf16; past S ~ 320 the streamed flash_fwd_kernel) ->
    gemm<+bo>.

    Bound on an H100 at S = 257, D = 384: 0.405 GFLOP per image and 2.36 MB
    of weights; bytes bound it at batch 1, operations from batch 2 up.
    """
    name = "fused_attn_part"
    _refuse_grad(name, x, *ap)
    if not _route(x):
        return attn_part_math(x, ap, num_heads=num_heads, eps=eps)
    return _launch_attn_part(x, ap, num_heads, eps, name, _ext.lib().dp_fused_attn_part)


def fused_attn_part_stream(
    x: torch.Tensor, ap: AttnParams, num_heads: int, eps: float
) -> torch.Tensor:
    """``fused_attn_part``'s function at the weight-streamed rounding points
    (o = bf16(ctx Wo + bo), summed and biased in f32); replaces
    ``_attn_stream_kernel`` (dino_pose_tpu/ops/block.py:1807), dinov2-large's
    attention half.

    Design: ``fused_attn_part``'s four launches with another epilogue on
    the last — LN1 rows -> gemm<+bqkv> -> attention (K/V resident; the
    streamed flash_fwd_kernel past S ~ 320) -> gemm<f32 +bo>. The TPU
    kernel streams per-head-group weight slices through VMEM because one
    half's 8 MB of bf16 weights (D = 1024) exceed its 16 MiB budget with the
    activations; the Hopper GEMMs already stream every weight in 64-deep
    TMA tiles through shared memory, so that plan has nothing to carry over.

    Bound on an H100 at S = 257, D = 1024: 2.43 GFLOP per image and 8.4 MB
    of weights; bytes bound it at batch 1, operations from batch 2 up.
    """
    name = "fused_attn_part_stream"
    _refuse_grad(name, x, *ap)
    if not _route(x):
        return attn_part_stream_math(x, ap, num_heads=num_heads, eps=eps)
    return _launch_attn_part(x, ap, num_heads, eps, name, _ext.lib().dp_fused_attn_part_stream)


def _launch_attn_part(x: torch.Tensor, ap: AttnParams, num_heads: int, eps: float,
                      name: str, entry) -> torch.Tensor:
    _check_act(x, name)
    b, s, d = x.shape
    _check_shapes(d, num_heads, name)
    _check_params(x, ap, _attn_shapes(d), name)
    qkv = torch.empty((b, s, 3 * d), dtype=x.dtype, device=x.device)
    ctx = torch.empty_like(x)
    out = torch.empty_like(x)
    err = entry(*(t.data_ptr() for t in (x, *ap, qkv, ctx, out)),
                b, s, d, num_heads, eps, _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    _count_attention(s, d // num_heads)
    return out


def fused_mlp_part(x2: torch.Tensor, mp: MlpParams, eps: float) -> torch.Tensor:
    """MLP half y = x2 + ls2*(W2*gelu(W1*LN2(x2) + bf1) + bf2); replaces
    ``_mlp_part_kernel`` (dino_pose_tpu/ops/block.py:1021).

    Design: three launches — LN2 rows (once, into the output buffer) ->
    gemm<+bf1, exact GELU (erff)> -> gemm<+bf2, *ls2, +x2>; the (B*S, 4D)
    hidden tensor is the only other intermediate in device memory.

    Bound on an H100 at S = 257, D = 384: 0.606 GFLOP per image and 2.36 MB
    of weights; bytes bound it at batch 1, operations from batch 2 up.
    """
    name = "fused_mlp_part"
    _refuse_grad(name, x2, *mp)
    if not _route(x2):
        return mlp_part_math(x2, mp, eps=eps)
    return _launch_mlp_part(x2, mp, eps, name, _ext.lib().dp_fused_mlp_part)


def fused_mlp_part_stream(x2: torch.Tensor, mp: MlpParams, eps: float) -> torch.Tensor:
    """``fused_mlp_part``'s function at the weight-streamed rounding points
    (y = x2 + bf16((g W2 + bf2) ls2), fc2 summed, biased and scaled in f32);
    replaces ``_mlp_stream_kernel`` (dino_pose_tpu/ops/block.py:1636),
    dinov2-large's MLP half.

    Design: ``fused_mlp_part``'s three launches with another epilogue on the
    last — LN2 rows -> gemm<+bf1, exact GELU> -> gemm<f32 +bf2, *ls2,
    rounded, +x2>. The TPU kernel streams (D, bh) fc1 and (bh, D) fc2 blocks
    through VMEM (16.8 MB of bf16 weights at D = 1024) with an f32 (rows, D)
    accumulator resident; here each output tile's f32 accumulator lives in
    registers over the whole hidden axis, and the weights reach shared
    memory in 64-deep TMA tiles, so no plan of hidden blocks is needed.

    Bound on an H100 at S = 257, D = 1024: 4.31 GFLOP per image and 16.8 MB
    of weights; bytes bound it at batch 1, operations from batch 2 up.
    """
    name = "fused_mlp_part_stream"
    _refuse_grad(name, x2, *mp)
    if not _route(x2):
        return mlp_part_stream_math(x2, mp, eps=eps)
    return _launch_mlp_part(x2, mp, eps, name, _ext.lib().dp_fused_mlp_part_stream)


def fused_mlp_part_stream_train(
    x2: torch.Tensor, mp: MlpParams, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """``fused_mlp_part_stream``'s y and the pre-LayerScale output h2 =
    bf16(g W2 + bf2) that the streamed backward reads: (y, h2); replaces
    ``_mlp_stream_train_kernel`` (dino_pose_tpu/ops/block.py:1695), the MLP
    half of a trainable dinov2-base or -large block.

    Design: ``fused_mlp_part_stream``'s three launches, the fc2 epilogue
    also storing h2 from the f32 sum it scales for y — LN2 rows ->
    gemm<+bf1, exact GELU> -> gemm<f32 +bf2, h2 out, *ls2, rounded, +x2>. The TPU
    kernel adds an h2 output block to ``_mlp_stream_kernel``'s hidden-block
    walk; here the output tile's epilogue writes it.

    Bound on an H100 at S = 257, D = 1024: 4.31 GFLOP per image and 16.8 MB
    of weights, plus B*S*D*2 bytes for h2; bytes bound it at batch 1,
    operations from batch 2 up.
    """
    name = "fused_mlp_part_stream_train"
    _refuse_grad(name, x2, *mp)
    if not _route(x2):
        return mlp_part_stream_train_math(x2, mp, eps=eps)
    return _launch_mlp_part(x2, mp, eps, name, _ext.lib().dp_fused_mlp_part_stream_train,
                            save_h2=True)


def _launch_mlp_part(x2: torch.Tensor, mp: MlpParams, eps: float, name: str,
                     entry, save_h2: bool = False):
    _check_act(x2, name)
    b, s, d = x2.shape
    hidden = mp.w1.shape[-1]
    if d % 64:
        raise ValueError(f"{name}: hidden size {d} is not a multiple of 64")
    _check_hidden(hidden, name)
    _check_params(x2, mp, _mlp_shapes(d, hidden), name)
    hbuf = torch.empty((b, s, hidden), dtype=x2.dtype, device=x2.device)
    outs = (torch.empty_like(x2), torch.empty_like(x2)) if save_h2 else (torch.empty_like(x2),)
    # The entry takes h2 before y.
    err = entry(*(t.data_ptr() for t in (x2, *mp, hbuf, *outs[::-1])), b * s, d, hidden, eps,
                _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return outs if save_h2 else outs[0]


def fused_mlp_dx(
    x2: torch.Tensor, dy: torch.Tensor, mp: MlpParams, eps: float
) -> torch.Tensor:
    """Activation-only backward of the MLP half, dx2 with no weight
    gradients; replaces ``_mlp_dx_kernel`` (dino_pose_tpu/ops/block.py:1044).

    Design: six launches — LN2 rows (into dm's buffer) -> gemm<+bf1>
    recomputes h1 (JAX keeps only x2 and the weights as residuals) ->
    scale_rows forms bf16(dy*ls2) (into dm's buffer again) -> gemm_nt<
    *gelu'(h1)> gives dh1b -> gemm_nt<f32 out> gives dm = dh1b W1^T -> a row
    kernel applies the LayerNorm backward and adds dy. gemm_nt reads the
    (in, out) weight as it is stored, both operands K-major for wgmma. h1
    and dh1b (B*S, 4D) bf16 and dm (B*S, D) f32 pass through device memory.

    Bound on an H100 at S = 257, D = 384: 0.909 GFLOP per image (three
    products of 2*S*D*4D) and 3*B*S*D*2 bytes of activations plus 2.36 MB of
    weights; operations bound it from batch 2 up.
    """
    name = "fused_mlp_dx"
    if not _route(x2):
        return mlp_dx_math(x2, dy, mp, eps=eps)
    _check_pair(x2, dy, name)
    b, s, d = x2.shape
    hidden = mp.w1.shape[-1]
    if d % 64:
        raise ValueError(f"{name}: hidden size {d} is not a multiple of 64")
    _check_hidden(hidden, name)
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


def _check_partial_widths(d: int, n_in: int, k_out: int, name: str) -> None:
    """A shard's chain: the first product's N (3D/tp or the local MLP width)
    a multiple of 64, the last product's K (D/tp or the local MLP width) a
    multiple of 32, the model width D a multiple of 64."""
    if d % 64:
        raise ValueError(f"{name}: hidden size {d} is not a multiple of 64")
    if n_in % 64 or k_out % 32:
        raise ValueError(f"{name}: the shard's widths ({n_in} wide, {k_out} deep) are not "
                         "multiples of 64 and 32")


def fused_attn_part_partial(
    x: torch.Tensor, pp: AttnPartialParams, num_heads: int, eps: float
) -> torch.Tensor:
    """One tensor-parallel shard's attention half: its ``num_heads`` local
    heads and the partial out-projection product, o_l = bf16(MHA_l(LN1(x)
    Wqkv_l + bqkv_l) Wo_l) with no bias; replaces
    ``_attn_part_partial_kernel`` (dino_pose_tpu/ops/block.py:1010, body
    ``_attn_half_core`` :948, launched by ``_part_call`` :1117 from
    ``fused_attn_part_partial`` :1250).

    Design: ``fused_attn_part``'s four launches at the shard's widths —
    LN1 rows of width D (each shard normalises every row once, into its own
    output buffer, as JAX's shard kernel does) -> gemm<+bqkv> with N = 3D/tp
    -> attention on the H/tp heads of the packed [q_l | k_l | v_l] (K/V
    resident; the streamed flash_fwd_kernel past S ~ 320) -> gemm<no bias>
    with K = D/tp. The TPU kernel holds the shard's 8D²/tp bytes of weights
    in VMEM; here the wgmma GEMMs stream them through a TMA ring. What bounds
    it from batch 8 up is the tensor cores (the two products at ~512 FLOPs
    a byte at D = 768); the WMMA GEMM it replaces ran its qkv product at
    ~18 TFLOP/s, one block an SM renormalising its rows in each column
    block.

    Bound on an H100 at dinov2-base's shard (D = 768, tp = 2), S = 257:
    0.708 GFLOP per image and 2.36 MB of weights; bytes bound it at batch
    1, operations from batch 2 up.
    """
    name = "fused_attn_part_partial"
    _refuse_grad(name, x, *pp)
    if not _route(x):
        return attn_part_math_partial(x, pp, num_heads=num_heads, eps=eps)
    _check_act(x, name)
    b, s, d = x.shape
    dl = pp.wqkv.shape[-1] // 3
    _check_partial_widths(d, 3 * dl, dl, name)
    _check_shapes(dl, num_heads, name)
    _check_params(x, pp, {"g1": (d,), "b1": (d,), "wqkv": (d, 3 * dl), "bqkv": (3 * dl,),
                          "wo": (dl, d)}, name)
    qkv = _act(b, s, 3 * dl, like=x)
    ctx = _act(b, s, dl, like=x)
    out = torch.empty_like(x)
    err = _ext.lib().dp_fused_attn_part_partial(
        *(t.data_ptr() for t in (x, *pp, qkv, ctx, out)), b, s, d, dl, num_heads, eps, _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    _count_attention(s, dl // num_heads)
    return out


def _partial_mlp_checks(x2: torch.Tensor, pp: MlpPartialParams, name: str) -> tuple:
    _check_act(x2, name)
    b, s, d = x2.shape
    hidden = pp.w1.shape[-1]
    _check_partial_widths(d, hidden, hidden, name)
    _check_params(x2, pp, {"g2": (d,), "b2": (d,), "w1": (d, hidden), "bf1": (hidden,),
                           "w2": (hidden, d)}, name)
    return b, s, d, hidden


def fused_mlp_part_partial(x2: torch.Tensor, pp: MlpPartialParams, eps: float) -> torch.Tensor:
    """One shard's MLP half, bf16(gelu(bf16(LN2(x2) W1_l) + bf16(bf1_l)) W2_l)
    with no bias, LayerScale or residual; replaces
    ``_mlp_part_partial_kernel`` (dino_pose_tpu/ops/block.py:1062, through
    ``fused_mlp_part_partial`` :1288).

    Design: ``fused_mlp_part``'s three launches at the shard's MLP width
    4D/tp — LN2 rows (once, into the output buffer) -> gemm<+bf1, exact
    GELU> -> gemm<no bias> with K = 4D/tp; the (B*S, 4D/tp) hidden tensor
    is the only other intermediate in device memory. Bound by the tensor
    cores from batch 8 up; both products run on the wgmma/TMA GEMM (the WMMA
    GEMM's LayerNorm prologue it replaces held fc1 at ~26 TFLOP/s).

    Bound on an H100 at dinov2-base's shard (D = 768, tp = 2), S = 257:
    1.212 GFLOP per image and 4.72 MB of weights; bytes bound it at batch
    1, operations from batch 2 up.
    """
    name = "fused_mlp_part_partial"
    _refuse_grad(name, x2, *pp)
    if not _route(x2):
        return mlp_part_math_partial(x2, pp, eps=eps)
    b, s, d, hidden = _partial_mlp_checks(x2, pp, name)
    hbuf = _act(b, s, hidden, like=x2)
    out = torch.empty_like(x2)
    err = _ext.lib().dp_fused_mlp_part_partial(
        *(t.data_ptr() for t in (x2, *pp, hbuf, out)), b * s, d, hidden, eps, _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return out


def fused_mlp_partial_dx(
    x2: torch.Tensor, dp: torch.Tensor, pp: MlpPartialParams, eps: float
) -> torch.Tensor:
    """Activation-only backward of one shard's MLP half: dx2 =
    LN2^T(W1_l^T(gelu'(h1) * W2_l^T dp)), ``dp`` the cotangent of the
    shard's partial product (already times ls2), no residual term, no weight
    gradients; replaces ``_mlp_partial_dx_kernel``
    (dino_pose_tpu/ops/block.py:1099, through ``_mlp_partial_bwd`` :1309).

    Design: ``fused_mlp_dx``'s five launches at the shard's MLP width with
    two steps off — LN2 rows -> gemm<+bf1> recomputes h1 -> gemm_nt<
    *gelu'(h1)> on dp as it comes (no scale_rows) gives dh1b -> gemm_nt<f32>
    gives dm -> the LayerNorm-backward row kernel with no residual.

    Bound on an H100 at dinov2-base's shard (D = 768, tp = 2), S = 257:
    1.818 GFLOP per image and 3*B*S*D*2 bytes of activations plus 4.72 MB
    of weights; operations bound it from batch 2 up.
    """
    name = "fused_mlp_partial_dx"
    if not _route(x2):
        return mlp_partial_dx_math(x2, dp, pp, eps=eps)
    _check_pair(x2, dp, name)
    b, s, d, hidden = _partial_mlp_checks(x2, pp, name)
    h1 = _act(b, s, hidden, like=x2)
    dh1b = torch.empty_like(h1)
    dm = _f32(b, s, d, like=x2)
    dx2 = torch.empty_like(x2)
    err = _ext.lib().dp_fused_mlp_partial_dx(
        *(t.data_ptr() for t in (x2, dp, *pp, h1, dh1b, dm, dx2)), b * s, d, hidden, eps,
        _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return dx2


def _check_operand(t: torch.Tensor, what: str, like: torch.Tensor, name: str) -> None:
    """A bf16 matrix the kernels read by TMA: 2-D, contiguous, 16-byte
    aligned, on ``like``'s device."""
    if t.dtype != torch.bfloat16 or t.device != like.device or t.dim() != 2:
        raise TypeError(f"{name}: {what} must be a bf16 matrix on {like.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must be contiguous and 16-byte aligned")


def _check_vector(t: torch.Tensor, n: int, what: str, like: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (n,) or t.device != like.device \
            or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous ({n},) f32 tensor on {like.device}")


def fused_gemm(a: torch.Tensor, w: torch.Tensor, epi: str, *, bias: torch.Tensor | None = None,
               ls: torch.Tensor | None = None, res: torch.Tensor | None = None):
    """One product of the chains alone, ``epilogue(a @ w)`` (plain version
    :func:`gemm_math`): a (M, K) and w (K, N) bf16, bias and ls (N,) f32,
    res (M, N) bf16 as ``epi`` reads them; returns out, or (out, out2) for
    the paired epilogues. M any, N a multiple of 64, K of 32.

    The chains (every wrapper above) launch the same GEMM kernel through
    their own C entries; this wrapper exists so that the card tests and
    ``chip_smoke.py`` can hold and time the GEMM core by itself. It counts
    its launches under ``LAUNCHES["fused_gemm"]``, which no path calls.
    """
    if epi not in EPILOGUES:
        raise ValueError(f"fused_gemm: unknown epilogue {epi!r}")
    if not _route(a):
        return gemm_math(a, w, epi, bias, ls, res)
    name = "fused_gemm"
    _refuse_grad(name, a, w)
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: a (M, K) and w (K, N) expected, got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    (m, k), n = a.shape, w.shape[1]
    _check_operand(a, "a", a, name)
    _check_operand(w, "w", a, name)
    if n % 64 or k % 32:
        raise ValueError(f"{name}: N = {n} is not a multiple of 64 or K = {k} of 32")
    # What the epilogue reads: the f32 bias (all but "none"), ls and res.
    wants = {"bias": (torch.float32, (n,)), "ls": (torch.float32, (n,)),
             "res": (torch.bfloat16, (m, n))}
    reads = {"bias": epi != "none", "ls": "ls_res" in epi, "res": "ls_res" in epi}
    given = {"bias": bias, "ls": ls, "res": res}
    for what, (dtype, shape) in wants.items():
        t = given[what] if reads[what] else None
        given[what] = t
        if reads[what] and (t is None or t.dtype != dtype or tuple(t.shape) != shape
                            or not t.is_contiguous() or t.device != a.device):
            raise ValueError(f"{name}: epilogue {epi} needs {what} as a contiguous {shape} "
                             f"{dtype} tensor on {a.device}")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    out2 = torch.empty_like(out) if epi in PAIRED else None
    ptr = [0 if t is None else t.data_ptr() for t in (a, w, *given.values(), out, out2)]
    err = _ext.lib().dp_gemm(*ptr, m, n, k, EPILOGUES.index(epi), _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return (out, out2) if out2 is not None else out


def fused_gemm_nt(a: torch.Tensor, w: torch.Tensor, epi: str, *,
                  scale: torch.Tensor | None = None, aux: torch.Tensor | None = None,
                  colsum: bool = False):
    """One backward product of the chains alone, ``epilogue(a' @ w^T)``
    (plain version :func:`gemm_nt_math`): a (M, K) and w (N, K) bf16, the
    forward weight read transposed; ``scale`` (K,) f32 forms a' =
    bf16(a * scale) first (``scale_rows_kernel``, as the chains do); aux (M,
    N) bf16 for ``gelu_grad``. Returns out ((M, N), f32 for ``f32``, else
    bf16), or (out, the (N,) f32 column sums before rounding) with
    ``colsum``. M any, N a multiple of 64, K of 32.

    Every backward chain launches ``gemm_nt_kernel`` through its own C
    entry; this wrapper exists so that the card tests and ``chip_smoke.py``
    can hold and time it alone. It counts its launches under
    ``LAUNCHES["fused_gemm_nt"]``, which no path calls.
    """
    if epi not in EPILOGUES_NT:
        raise ValueError(f"fused_gemm_nt: unknown epilogue {epi!r}")
    if not _route(a):
        return gemm_nt_math(a, w, epi, scale=scale, aux=aux, colsum=colsum)
    name = "fused_gemm_nt"
    _refuse_grad(name, a, w)
    _check_operand(a, "a", a, name)
    _check_operand(w, "w", a, name)
    (m, k), n = a.shape, w.shape[0]
    if w.shape[1] != k:
        raise ValueError(f"{name}: a (M, K) and w (N, K) expected, got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    if n % 64 or k % 32:
        raise ValueError(f"{name}: N = {n} is not a multiple of 64 or K = {k} of 32")
    if epi == "gelu_grad":
        if aux is None or tuple(aux.shape) != (m, n):
            raise ValueError(f"{name}: epilogue gelu_grad needs aux as an ({m}, {n}) bf16 tensor")
        _check_operand(aux, "aux", a, name)
    else:
        aux = None
    scaled = None
    if scale is not None:
        _check_vector(scale, k, "scale", a, name)
        scaled = torch.empty_like(a)
    out = torch.empty((m, n), dtype=torch.float32 if epi == "f32" else a.dtype, device=a.device)
    part = sums = None
    if colsum:
        part, sums = _f32(-(-m // _SUM_ROWS), n, like=a), _f32(n, like=a)
    ptr = [0 if t is None else t.data_ptr() for t in (a, w, scale, scaled, aux, out, part, sums)]
    err = _ext.lib().dp_gemm_nt(*ptr, m, n, k, EPILOGUES_NT.index(epi), _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return (out, sums) if colsum else out


def fused_gemm_tn(a: torch.Tensor, g: torch.Tensor, *, scale: torch.Tensor | None = None,
                  gsum: bool = False):
    """One weight-gradient product of the chains alone, dW = a^T g' (plain
    version :func:`gemm_tn_math`): a (M, K_in) and g (M, N) bf16, g' = g or
    bf16(g * scale) with ``scale`` (N,) f32; dW (K_in, N) f32 summed over the
    M rows in ``_splits`` row splits added in a fixed order; with ``gsum``
    also the (N,) f32 column sums of g': (dW, sums). K_in and N multiples of
    64. Counts its launches under ``LAUNCHES["fused_gemm_tn"]``; no path
    calls it (the chains launch ``gemm_tn_kernel`` through their C entries).
    """
    if not _route(a):
        return gemm_tn_math(a, g, scale=scale, gsum=gsum)
    name = "fused_gemm_tn"
    _refuse_grad(name, a, g)
    _check_operand(a, "a", a, name)
    _check_operand(g, "g", a, name)
    (m, k_in), n = a.shape, g.shape[1]
    if g.shape[0] != m:
        raise ValueError(f"{name}: a (M, K_in) and g (M, N) expected, got {tuple(a.shape)} and "
                         f"{tuple(g.shape)}")
    if k_in % 64 or n % 64:
        raise ValueError(f"{name}: K_in = {k_in} or N = {n} is not a multiple of 64")
    scaled = None
    if scale is not None:
        _check_vector(scale, n, "scale", a, name)
        scaled = torch.empty_like(g)
    s = _splits(m, k_in, n)
    ws, dw = _partials(s, k_in, n, like=a), _f32(k_in, n, like=a)
    gws = sums = None
    if gsum:  # a partial per split and 64 rows of dW
        gws, sums = _f32(s * (k_in // 64), n, like=a), _f32(n, like=a)
    ptr = [0 if t is None else t.data_ptr() for t in (a, g, scale, scaled, ws, gws, dw, sums)]
    err = _ext.lib().dp_gemm_tn(*ptr, m, k_in, n, s, _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return (dw, sums) if gsum else dw


def ln_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """The chains' LayerNorm step alone: the rows of x (..., D) bf16
    normalised with f32 statistics (lane-strided sums, two-pass variance)
    and the f32 scale g and bias b, rounded to bf16 once: what every chain's
    first product reads. Plain version: ``_ln_fwd``'s output. Counts its
    launches under ``LAUNCHES["ln_rows"]``; no path calls it."""
    if not _route(x):
        return _ln_fwd(x, g, b, eps)[0]
    name = "ln_rows"
    d = x.shape[-1]
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be a contiguous, 16-byte aligned bf16 tensor")
    for t in (g, b):
        if t.dtype != torch.float32 or tuple(t.shape) != (d,) or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: scale and bias must be contiguous ({d},) f32 on {x.device}")
    out = torch.empty_like(x)
    err = _ext.lib().dp_ln_rows(x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(),
                                x.numel() // d, d, eps, _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return out


def packed_attention(qkv: torch.Tensor, num_heads: int, *, streamed: bool) -> torch.Tensor:
    """The chains' attention step alone on a packed qkv (B, S, 3D) bf16,
    q|k|v on the last axis: ctx (B, S, D). ``streamed`` picks the kernel:
    flash_fwd_kernel (counted under ``LAUNCHES["flash_fwd"]`` too) or the
    resident attn_fwd_kernel (under ``LAUNCHES["attn_fwd"]``; K/V in shared
    memory, S up to 320 at head width 64: the chains' choice where it fits).
    Plain version: the chains' ``_heads_attention``. Counts its launches
    under ``LAUNCHES["packed_attention"]``; no path calls it: it holds and
    times the chains' attention step."""
    if not _route(qkv):
        return _heads_attention(qkv, num_heads)
    name = "packed_attention"
    _check_act(qkv, name)
    b, s, d3 = qkv.shape
    _check_shapes(d3 // 3, num_heads, name)
    dh = d3 // 3 // num_heads
    if not streamed and _ext.lib().dp_flash_forward(s, dh):
        raise ValueError(f"{name}: K and V of {s} keys do not fit the resident kernel")
    ctx = _act(b, s, d3 // 3, like=qkv)
    err = _ext.lib().dp_packed_attention(qkv.data_ptr(), ctx.data_ptr(), b, s, num_heads, dh,
                                         int(streamed), _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    LAUNCHES["flash_fwd" if streamed else "attn_fwd"] += 1
    return ctx


def packed_attention_bwd(qkv: torch.Tensor, dctx: torch.Tensor, num_heads: int, *,
                         streamed: bool) -> torch.Tensor:
    """The chains' attention backward alone: dqkv (B, S, 3D) from a packed
    qkv (B, S, 3D) bf16 and the cotangent of its ctx, dctx (B, S, D).
    ``streamed`` picks the kernels: the streamed flash_fwd_kernel (for the
    row statistics) then flash_bwd_dq_kernel + flash_bwd_dkv_kernel (counted
    under ``LAUNCHES["flash_fwd"]`` and ``["flash_bwd"]`` too), or the
    resident pair attn_bwd_dq_kernel + attn_bwd_dkv_kernel (under
    ``LAUNCHES["attn_bwd"]``; S up to 304 at head width 64: the backward
    chains' choice where it fits). Plain version: ``packed_attention_bwd_math``.
    Counts its launches under ``LAUNCHES["packed_attention_bwd"]``; no path
    calls it: it times the backward chains' attention step."""
    if not _route(qkv):
        return packed_attention_bwd_math(qkv, dctx, num_heads)
    name = "packed_attention_bwd"
    _check_act(qkv, name)
    _check_act(dctx, name)
    b, s, d3 = qkv.shape
    d = d3 // 3
    _check_shapes(d, num_heads, name)
    if tuple(dctx.shape) != (b, s, d) or dctx.device != qkv.device:
        raise ValueError(f"{name}: dctx must be ({b}, {s}, {d}) on {qkv.device}, "
                         f"got {tuple(dctx.shape)} on {dctx.device}")
    dh = d // num_heads
    if not streamed and _ext.lib().dp_flash_backward(s, dh):
        raise ValueError(f"{name}: {s} queries do not fit the resident backward kernels")
    # The streamed forward's output (its statistics are what the backward
    # reads), and the softmax statistics (B, H, 3, S).
    ctx = _act(b, s, d, like=qkv) if streamed else _act(0, like=qkv)
    stats = _f32(b, num_heads, 3, s, like=qkv)
    dqkv = torch.empty_like(qkv)
    err = _ext.lib().dp_packed_attention_bwd(qkv.data_ptr(), dctx.data_ptr(), ctx.data_ptr(),
                                             stats.data_ptr(), dqkv.data_ptr(), b, s, num_heads,
                                             dh, int(streamed), _stream())
    _ext.check(err, name)
    LAUNCHES[name] += 1
    LAUNCHES["flash_bwd" if streamed else "attn_bwd"] += 1
    LAUNCHES["flash_fwd"] += int(streamed)
    return dqkv


def attention_core_cost(b: int, h: int, s: int, dh: int, backward: bool) -> tuple[int, int]:
    """(FLOPs, bytes) of the chains' attention step on the packed layout, for
    its bound: JAX's FLOPs at the true length s (``flash_cost``'s count: 4
    * B*H*S^2*dh forward, scores and PV; 10 backward, the recomputed scores,
    dP, dq, dk and dv), and each byte once: qkv read and ctx written, or
    qkv and dctx read and dqkv written (bf16)."""
    unit, act = b * h * s * s * dh, b * s * h * dh * 2
    return (10 * unit, 7 * act) if backward else (4 * unit, 4 * act)


def attention_core_executed(b: int, h: int, s: int, dh: int, backward: bool) -> int:
    """FLOPs the resident kernels execute at (b, h, s, dh), for their rate:
    every 64-row query tile against the 16 * NK16 keys of the instantiation
    that takes s (``dp_attention_keys``). Forward: Q K^T and P V. Backward:
    the dq kernel's Q K^T, dO V^T and dS K, and the dkv kernel's K Q^T, V
    dO^T, P^T dO and dS^T Q over 64-query chunks. Needs the built library."""
    rows = -(-s // 64) * 64
    keys = _ext.lib().dp_attention_keys(s, dh)
    if not backward:
        return 4 * b * h * rows * keys * dh
    return b * h * dh * (6 * rows * keys + 8 * rows * rows)


_SMS = 132  # the H100's streaming multiprocessors


def _tn_tile(k_in: int, n: int) -> tuple[int, int]:
    """gemm_tn_kernel's tile (rows of dW, columns) for a (k_in, n) weight
    gradient: the largest the shape takes, as ``tn_plan`` in
    block_kernels.cu picks it (128 x 128, 64 x 128 or 64 x 64)."""
    if n % 128:
        return 64, 64
    return (128 if k_in % 128 == 0 else 64), 128


def _split_rows(m: int, s: int) -> int:
    """Rows of each of s row splits of m rows: the 64-row steps shared out
    evenly (``split_rows`` in block_kernels.cu), so no TMA box of a split
    reads the next split's rows."""
    steps = -(-m // 64)
    return -(-steps // s) * 64


@functools.lru_cache(maxsize=256)
def _splits(m: int, k_in: int, n: int) -> int:
    """Row splits of a weight-gradient product dW (k_in, n) over m rows, each
    non-empty: the count with the least modelled time, as waves of tiles
    over the card's SMs (a 64-row step of a 128 x 128 tile ~0.38 us at 5.5
    TFLOP/s an SM, ~1.5 us a tile to fill the ring and store) plus the
    fixed-order pass that adds the f32 partials (read once each at ~2.5
    TB/s, 3 us a launch) where there is more than one."""
    tm, tn = _tn_tile(k_in, n)
    tiles = (k_in // tm) * (n // tn)
    steps = -(-m // 64)
    best, best_us = 1, None
    for s in range(1, min(steps, 32) + 1):
        rows = _split_rows(m, s)
        s_eff = -(-m // rows)
        waves = -(-tiles * s_eff // _SMS)
        us = waves * (rows / 64 * 2 * 64 * tm * tn / 5.5e6 + 1.5)
        if s_eff > 1:
            us += (s_eff + 1) * k_in * n * 4 / 2.5e6 + 3
        if best_us is None or us < best_us - 1e-9:
            best, best_us = s_eff, us
    return best


def _partials(s: int, k_in: int, n: int, like: torch.Tensor) -> torch.Tensor:
    """The f32 partials (s, k_in, n) of a product split over s row splits;
    with one split the kernel writes the result itself, and none are made."""
    return _f32(s, k_in, n, like=like) if s > 1 else _f32(0, like=like)


def _f32(*shape: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def _act(*shape: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _check_pair(x: torch.Tensor, dy: torch.Tensor, name: str) -> None:
    _check_act(x, name)
    _check_act(dy, name)
    if dy.shape != x.shape:
        raise ValueError(f"{name}: cotangent {tuple(dy.shape)} and input {tuple(x.shape)} differ")


def fused_mlp_bwd(
    x2: torch.Tensor, dy: torch.Tensor, mp: MlpParams, eps: float
) -> tuple[torch.Tensor, MlpParams]:
    """Backward of the MLP half with its weight gradients: (dx2, gradients
    of every ``MlpParams`` field in f32, summed over all B*S rows); replaces
    ``_mlp_bwd_kernel`` (dino_pose_tpu/ops/block.py:284, via ``_mlp_bwd`` :634).

    Design: LN2 rows -> gemm<+bf1, h1 and GELU pair> -> gemm<+bf2>(h2) ->
    scale_rows(bf16(dy*ls2), once for both products that read it) ->
    gemm_nt<*gelu'(h1), column sums>(dh1b, dbf1) -> gemm_tn(dW2 = g^T
    bf16(dy*ls2)) -> gemm_nt<f32>(dm) -> LayerNorm-backward rows with column
    sums (dx2, dbf2, dls2, dg2, db2) -> gemm_tn(dW1 = m^T dh1b). The TPU
    kernel adds each batch row's weight gradients into VMEM across its
    sequential grid; here gemm_tn reduces over the rows inside each tile and
    splits them into 64-row-aligned ranges (``_splits``) only where the
    tiles alone do not fill the card, their f32 partials added by a second
    pass in a fixed order (reproducible bits, no atomics). h1, g and h2 are
    recomputed, as JAX saves only x2.

    Bound on an H100 at S = 257, D = 384: six products of 2*S*D*4D = 1.818
    GFLOP per image, 0.235 ms at batch 128; operations bound it from batch 2.
    """
    name = "fused_mlp_bwd"
    if not _route(x2):
        return mlp_bwd_math(x2, dy, mp, eps=eps)
    return _launch_mlp_bwd(x2, dy, None, mp, eps, name, _ext.lib().dp_fused_mlp_bwd)


def fused_mlp_bwd_stream(
    x2: torch.Tensor, dy: torch.Tensor, h2: torch.Tensor, mp: MlpParams, eps: float
) -> tuple[torch.Tensor, MlpParams]:
    """Backward of the trainable streamed MLP half, given the forward's
    saved pre-LayerScale output h2 (``fused_mlp_part_stream_train``): (dx2,
    gradients of every ``MlpParams`` field in f32); replaces the pair
    ``_mlp_stream_dx_full_kernel`` (dx2, dg2, db2; dino_pose_tpu/ops/block.py:
    1726) and ``_mlp_stream_dw_kernel`` (dW1, dbf1, dW2; :1770), with JAX's
    XLA dls2 = sum(dy*h2) and dbf2 = ls2*sum(dy) (``_mlp_stream_bwd`` :2217).

    Design: ``fused_mlp_bwd``'s chain without the h2 GEMM — LN2 rows ->
    gemm<+bf1, h1 and GELU pair> -> scale_rows(bf16(dy*ls2)) -> gemm_nt<
    *gelu'(h1), column sums>(dh1b, dbf1) -> gemm_tn(dW2) -> gemm_nt<f32>(dm)
    -> LayerNorm-backward rows with column sums (dx2, sum(dy), dls2 on the
    saved h2, dg2, db2) -> gemm_tn(dW1); the wrapper scales sum(dy) by ls2.
    The TPU pair streams (D, bh)/(bh, D) weight blocks through VMEM, the dW
    pass hidden-block-major so each gradient block stays resident over the
    rows; here every GEMM walks the weights in tiles, and dW sums fixed-order
    f32 partials over row splits.

    Bound on an H100 at S = 257, D = 1024: five products of 2*S*D*4D (h1,
    dg, dm, dW1, dW2) = 10.78 GFLOP per image, 1.39 ms at batch 128;
    operations bound it from batch 1.
    """
    name = "fused_mlp_bwd_stream"
    if not _route(x2):
        return mlp_stream_bwd_math(x2, dy, h2, mp, eps=eps)
    _check_pair(x2, h2, name)
    return _launch_mlp_bwd(x2, dy, h2, mp, eps, name, _ext.lib().dp_fused_mlp_bwd_stream)


def _launch_mlp_bwd(x2: torch.Tensor, dy: torch.Tensor, h2: torch.Tensor | None, mp: MlpParams,
                    eps: float, name: str, entry) -> tuple[torch.Tensor, MlpParams]:
    """The MLP backward chain: h2 recomputed into scratch (None) or read."""
    _check_pair(x2, dy, name)
    b, s, d = x2.shape
    hidden = mp.w1.shape[-1]
    if d % 64:
        raise ValueError(f"{name}: hidden size {d} is not a multiple of 64")
    _check_hidden(hidden, name)
    _check_params(x2, mp, _mlp_shapes(d, hidden), name)
    m_rows = b * s
    nblk = -(-m_rows // _SUM_ROWS)
    s1, s2 = _splits(m_rows, d, hidden), _splits(m_rows, hidden, d)
    # m, h1, g, h2, dh1b, dm, then the partials of dbf1, of the row sums,
    # of dW1 and of dW2.
    scratch = (_act(m_rows, d, like=x2), _act(m_rows, hidden, like=x2),
               _act(m_rows, hidden, like=x2), _act(m_rows, d, like=x2) if h2 is None else h2,
               _act(m_rows, hidden, like=x2), _f32(m_rows, d, like=x2),
               _f32(nblk, hidden, like=x2), _f32(nblk, 4, d, like=x2),
               _partials(s1, d, hidden, like=x2), _partials(s2, hidden, d, like=x2))
    dx2 = torch.empty_like(x2)
    dw1, dbf1 = _f32(d, hidden, like=x2), _f32(hidden, like=x2)
    dw2, vec4 = _f32(hidden, d, like=x2), _f32(4, d, like=x2)
    err = entry(
        *(t.data_ptr() for t in (x2, dy, *mp, *scratch, dx2, dw1, dbf1, dw2, vec4)),
        m_rows, d, hidden, s1, s2, eps, _stream(),
    )
    _ext.check(err, name)
    LAUNCHES[name] += 1
    dbf2, dls2, dg2, db2 = vec4
    if h2 is not None:
        dbf2 = mp.ls2 * dbf2  # the chain summed dy
    return dx2, MlpParams(g2=dg2, b2=db2, w1=dw1, bf1=dbf1, w2=dw2, bf2=dbf2, ls2=dls2)


def fused_attn_bwd(
    x: torch.Tensor, dx2: torch.Tensor, atp: AttnTrainParams, num_heads: int, eps: float
) -> tuple[torch.Tensor, AttnTrainParams]:
    """Backward of the attention half with its weight gradients: (dx,
    gradients of every ``AttnTrainParams`` field in f32, summed over all B*S
    rows); replaces ``_attn_bwd_kernel`` (dino_pose_tpu/ops/block.py:334,
    via ``_attn_bwd`` :654).

    Design: LN1 rows -> gemm<+bqkv> -> attention (ctx) -> gemm<+bo>(o) ->
    scale_rows(bf16(dx2*ls1)) -> gemm_nt<bf16>(dctx) -> gemm_tn(dWo = ctx^T
    bf16(dx2*ls1)) -> attention backward: a dq kernel per 64-query tile with
    the head's K and V resident (f32 P, rowsum(P*dP) saved) and a dk/dv
    kernel per 64-key tile with Q and dctx resident (past S = 304 the
    streamed flash_bwd_dq/dkv kernels, after a streamed forward that saves
    the row statistics they read) -> gemm_nt<f32>(da) -> LayerNorm-backward
    rows with column sums (dx, dbo, dls1, dg1, db1) -> gemm_tn with column
    sums (dWqkv, dbqkv). qkv, P, ctx and o are recomputed from x, as JAX
    saves only x; weight gradients are reduced in fixed order.

    Bound on an H100 at S = 257, D = 384: three qkv-sized products, three of
    2*S*D^2 and six of 2*S^2*D = 1.214 GFLOP per image, 0.157 ms at batch
    128; operations bound it from batch 2.
    """
    name = "fused_attn_bwd"
    if not _route(x):
        return attn_bwd_math(x, dx2, atp, num_heads=num_heads, eps=eps)
    dx, g, vec4 = _launch_attn_bwd(x, dx2, atp, num_heads, eps, name, stream=False)
    dbo, dls1, dg1, db1 = vec4
    return dx, AttnTrainParams(g1=dg1, b1=db1, ls1=dls1, bo=dbo, **g)


def fused_attn_bwd_stream(
    x: torch.Tensor, do: torch.Tensor, ap: AttnParams, num_heads: int, eps: float
) -> tuple[torch.Tensor, AttnParams]:
    """Backward of the trainable streamed attention half under its
    pre-LayerScale contract: ``do`` (bf16) is the cotangent of the output o
    itself, already times ls1 (the stitch ``x + o*ls1`` holds the LayerScale
    and the residual). (dx, gradients of every ``AttnParams`` field in f32);
    replaces the pair ``_attn_stream_dx_kernel`` (dx, dg1, db1;
    dino_pose_tpu/ops/block.py:1924) and ``_attn_stream_dw_kernel`` (dWqkv,
    dbqkv, dWo; :1973), with JAX's XLA dbo = sum(do) (``_attn_stream_bwd``
    :2389).

    Design: ``fused_attn_bwd``'s chain without the o recompute and without a
    residual — LN1 rows -> gemm<+bqkv> -> attention (ctx, the row statistics)
    -> gemm_nt<bf16>(dctx = do Wo^T) -> gemm_tn(dWo = ctx^T do) -> attention
    backward (the resident dq and dk/dv kernels; past S = 304 the streamed
    flash pair) -> gemm_nt<f32>(da) -> LayerNorm-backward rows with column
    sums (dx = LN1^T(da), dbo, dg1, db1) -> gemm_tn with column sums
    (dWqkv, dbqkv). The TPU pair streams per-head-group q/k/v
    column and out-projection row slices, summing da over the groups in a
    VMEM accumulator; here the GEMMs walk the weights in tiles.

    Bound on an H100 at S = 257, D = 1024: three qkv-sized products, two of
    2*S*D^2 (dctx, dWo) and six of 2*S^2*D = 6.74 GFLOP per image, 0.87 ms
    at batch 128; operations bound it from batch 1.
    """
    name = "fused_attn_bwd_stream"
    if not _route(x):
        return attn_stream_bwd_math(x, do, ap, num_heads=num_heads, eps=eps)
    dx, g, vec4 = _launch_attn_bwd(x, do, ap, num_heads, eps, name, stream=True)
    return dx, AttnParams(g1=vec4[2], b1=vec4[3], bo=vec4[0], **g)


def _launch_attn_bwd(x: torch.Tensor, dres: torch.Tensor, ap, num_heads: int, eps: float,
                     name: str, stream: bool):
    """The attention backward chain: (dx, {wqkv, bqkv, wo} gradients, the
    row kernel's four column sums). ``stream``: ``dres`` is do and ``ap``
    an ``AttnParams``; else ``dres`` is dx2 and ``ap`` carries ls1."""
    _check_pair(x, dres, name)
    b, s, d = x.shape
    _check_shapes(d, num_heads, name)
    _check_params(x, ap, _attn_shapes(d) if stream else {**_attn_shapes(d), "ls1": (d,)}, name)
    m_rows = b * s
    nblk = -(-m_rows // _SUM_ROWS)
    sq, so = _splits(m_rows, d, 3 * d), _splits(m_rows, d, d)

    # a, qkv, ctx, o (not on the streamed route), dctx, dqkv, da, the
    # softmax statistics, then the partials of the row sums, of dWqkv, of
    # dWo and of dbqkv (a split's and 64 rows of dWqkv's each).
    o = () if stream else (_act(m_rows, d, like=x),)
    scratch = (_act(m_rows, d, like=x), _act(m_rows, 3 * d, like=x), _act(m_rows, d, like=x),
               *o, _act(m_rows, d, like=x), _act(m_rows, 3 * d, like=x),
               _f32(m_rows, d, like=x), _f32(b, num_heads, 3, s, like=x),
               _f32(nblk, 4, d, like=x), _partials(sq, d, 3 * d, like=x),
               _partials(so, d, d, like=x), _f32(sq * (d // 64), 3 * d, like=x))
    dx = torch.empty_like(x)
    dwqkv, dbqkv = _f32(d, 3 * d, like=x), _f32(3 * d, like=x)
    dwo, vec4 = _f32(d, d, like=x), _f32(4, d, like=x)
    entry = _ext.lib().dp_fused_attn_bwd_stream if stream else _ext.lib().dp_fused_attn_bwd
    err = entry(
        *(t.data_ptr() for t in (x, dres, *ap, *scratch, dx, dwqkv, dbqkv, dwo, vec4)),
        b, s, d, num_heads, sq, so, eps, _stream(),
    )
    _ext.check(err, name)
    LAUNCHES[name] += 1
    _count_attention(s, d // num_heads, backward=True)
    return dx, {"wqkv": dwqkv, "bqkv": dbqkv, "wo": dwo}, vec4


class _MlpPartFrozen(torch.autograd.Function):
    """An MLP half with the frozen-weight backward, no gradient for any of
    its parameters. ``route`` ``"stream"``: forward ``fused_mlp_part_stream``,
    backward ``fused_mlp_dx``; ``"partial"`` (one tensor-parallel shard):
    forward ``fused_mlp_part_partial``, backward ``fused_mlp_partial_dx``;
    any other: forward ``fused_mlp_part``, backward ``fused_mlp_dx``. With
    ``kernels=False`` the plain versions of both. The wrappers are looked
    up when called, so that a caller may substitute a recording one."""

    @staticmethod
    def forward(ctx, x2, eps, kernels, route, *mp):
        if any(ctx.needs_input_grad[4:]):
            raise ValueError(
                "mlp_part_frozen: an MLP weight requires grad, but its backward "
                "gives the weights no gradient (assume_frozen_weights); a block "
                "that trains whole goes through block_train"
            )
        ctx.save_for_backward(x2, *mp)
        ctx.eps, ctx.kernels, ctx.route = eps, kernels, route
        if route == "partial":
            pp = MlpPartialParams(*mp)
            if kernels:
                return fused_mlp_part_partial(x2, pp, eps)
            return mlp_part_math_partial(x2, pp, eps=eps)
        stream = route == "stream"
        if kernels:
            return (fused_mlp_part_stream if stream else fused_mlp_part)(x2, MlpParams(*mp), eps)
        return (mlp_part_stream_math if stream else mlp_part_math)(x2, MlpParams(*mp), eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x2, *mp = ctx.saved_tensors
        partial = ctx.route == "partial"
        args = (x2, dy.contiguous(), (MlpPartialParams if partial else MlpParams)(*mp))
        if ctx.kernels:
            dx2 = (fused_mlp_partial_dx if partial else fused_mlp_dx)(*args, ctx.eps)
        else:
            dx2 = (mlp_partial_dx_math if partial else mlp_dx_math)(*args, eps=ctx.eps)
        return (dx2, None, None, None) + (None,) * len(mp)


def mlp_part_frozen(
    x2: torch.Tensor, mp: MlpParams, eps: float, *, kernels: bool = True,
    route: str = "block",
) -> torch.Tensor:
    """The LoRA layer's MLP half under autograd (JAX
    ``fused_mlp_part(..., assume_frozen_weights=True)``, or on ``route``
    ``"stream"`` ``fused_mlp_part_stream(..., True)``): the forward is
    ``fused_mlp_part`` (``"stream"``: ``fused_mlp_part_stream``), the
    backward ``fused_mlp_dx`` on either route, since JAX's
    ``_mlp_stream_dx_kernel`` computes ``_mlp_dx_kernel``'s function
    (``kernels=False``: the plain versions); only x2 gets a gradient. Raises
    ``ValueError`` if an ``MlpParams`` tensor requires grad. Saves only
    (x2, mp) for the backward, as JAX does."""
    return _MlpPartFrozen.apply(x2, eps, kernels, route, *mp)


def mlp_part_partial_frozen(
    x2: torch.Tensor, pp: MlpPartialParams, eps: float, *, kernels: bool = True
) -> torch.Tensor:
    """One shard's MLP half under autograd, :func:`mlp_part_frozen`'s
    contract (JAX ``fused_mlp_part_partial(..., assume_frozen_weights=True)``):
    the forward is ``fused_mlp_part_partial``, the backward gives x2 the
    cotangent ``fused_mlp_partial_dx`` computes; raises ``ValueError`` if a
    shard weight requires grad. Where JAX's ``_mlp_dx_fits`` turns the shard
    down (dinov2-large at tp = 2, S = 257) JAX takes the unfused vjp of the
    partial math instead; the port keeps this chain there, which differs
    from it only in bf16 rounding. ``kernels=False``: the plain versions."""
    return _MlpPartFrozen.apply(x2, eps, kernels, "partial", *pp)


def attn_part_tp(
    x: torch.Tensor, ap: AttnParams, num_heads: int, eps: float, mesh, *,
    kernels: bool = True, shards: list[AttnPartialParams] | None = None,
) -> torch.Tensor:
    """The attention half over ``mesh``'s model axis (JAX ``attn_part_tp``,
    block.py:1342-1375): each shard's ``fused_attn_part_partial`` on its
    ``num_heads/tp`` heads (``kernels=False``: ``attn_part_math_partial``),
    in rank order, the mesh's ``all_reduce`` of the partials, then ``+ bo``
    in the activation dtype. Across ranks this process computes its own
    shard only (``mesh.local_model_ranks``) and the all-reduce runs over the
    model group. ``shards``: ``shard_attn(ap, tp, r)`` for each local shard,
    cut once by the caller; cut here when None. Its forward only, as JAX's
    is on the LoRA path (nothing below the adapter trains)."""
    tp = mesh.tp
    if num_heads % tp:
        raise ValueError(f"attn_part_tp: {num_heads} heads do not divide over {tp} shards")
    if shards is None:
        shards = [shard_attn(ap, tp, r) for r in mesh.local_model_ranks]
    fn = fused_attn_part_partial if kernels else (
        lambda x_, pp, h, e: attn_part_math_partial(x_, pp, num_heads=h, eps=e))
    parts = [fn(x_r, pp, num_heads // tp, eps) for x_r, pp in zip(mesh.replicate(x), shards)]
    o = mesh.all_reduce(parts)
    return o + ap.bo.to(o.dtype)


def mlp_part_tp(
    x2: torch.Tensor, mp: MlpParams, eps: float, mesh, *,
    kernels: bool = True, shards: list[MlpPartialParams] | None = None,
) -> torch.Tensor:
    """The MLP half over ``mesh``'s model axis (JAX ``mlp_part_tp`` with
    ``assume_frozen_weights=True``, block.py:1378-1401): each shard's
    ``mlp_part_partial_frozen`` in rank order, the mesh's ``all_reduce``,
    then ``+ bf2`` and ``x2 + h2 * ls2`` in the activation dtype. x2's
    cotangent is the shards' dx2 summed by ``mesh.replicate``'s transpose,
    plus the residual's; a shard weight that requires grad is refused.
    ``shards``: as for :func:`attn_part_tp` (``shard_mlp``), the local
    shards only across ranks."""
    tp = mesh.tp
    if shards is None:
        shards = [shard_mlp(mp, tp, r) for r in mesh.local_model_ranks]
    h2 = mesh.all_reduce([mlp_part_partial_frozen(x_r, pp, eps, kernels=kernels)
                          for x_r, pp in zip(mesh.replicate(x2), shards)])
    h2 = h2 + mp.bf2.to(h2.dtype)
    return x2 + h2 * mp.ls2.to(h2.dtype)


class _BlockTrain(torch.autograd.Function):
    """A block that trains whole: forward ``fused_block_train``, backward
    ``fused_mlp_bwd`` then ``fused_attn_bwd`` on the dx2 it gives (JAX
    ``fused_block_train``, ``_train_fwd``/``_train_bwd``). With
    ``kernels=False`` the plain versions of all three, inside this same
    function, so that both paths keep the f32 intermediates of the JAX
    kernels (autograd of the bf16 ``block_math`` would round them)."""

    @staticmethod
    def forward(ctx, x, num_heads, eps, kernels, *params):
        pc = cast_params(BlockParams(*params), x.dtype)
        if kernels:
            y, x2 = fused_block_train(x, pc, num_heads, eps)
        else:
            y, x2 = block_train_math(x, pc, num_heads=num_heads, eps=eps)
        ctx.save_for_backward(x, x2, *params)
        ctx.num_heads, ctx.eps, ctx.kernels = num_heads, eps, kernels
        return y

    @staticmethod
    def backward(ctx, dy):
        x, x2, *params = ctx.saved_tensors
        pc = cast_params(BlockParams(*params), x.dtype)
        h, eps = ctx.num_heads, ctx.eps
        if ctx.kernels:
            dx2, mg = fused_mlp_bwd(x2, dy.contiguous(), mlp_params(pc), eps)
            dx, ag = fused_attn_bwd(x, dx2, attn_train_params(pc), h, eps)
        else:
            dx2, mg = mlp_bwd_math(x2, dy, mlp_params(pc), eps=eps)
            dx, ag = attn_bwd_math(x, dx2, attn_train_params(pc), num_heads=h, eps=eps)
        grads = BlockParams(**ag._asdict(), **mg._asdict())
        # In each parameter's own dtype (JAX ``like``): f32 for f32 masters.
        grads = (g.to(t.dtype) for g, t in zip(grads, params))
        return (dx if ctx.needs_input_grad[0] else None, None, None, None, *grads)


def block_train(
    x: torch.Tensor, p: BlockParams, num_heads: int, eps: float, *, kernels: bool = True
) -> torch.Tensor:
    """A trainable block under autograd (JAX ``fused_block_train``). ``p``
    holds the parameters as they train (f32, with their graphs); they are
    cast to the kernels' layout inside, and their gradients come back f32.
    Saves only (x, x2, p) for the backward, as JAX does. ``kernels=False``:
    the plain versions of the forward and both backward halves."""
    return _BlockTrain.apply(x, num_heads, eps, kernels, *p)


class _AttnPartStreamTrain(torch.autograd.Function):
    """The attention half of a trainable streamed block: forward
    ``fused_attn_part_stream``, backward ``fused_attn_bwd_stream`` (JAX
    ``fused_attn_part_stream``'s custom vjp, ``_attn_stream_fwd``/
    ``_attn_stream_bwd``). With ``kernels=False`` the plain versions of both,
    inside this same function, so that both paths keep the f32
    intermediates of the JAX kernels."""

    @staticmethod
    def forward(ctx, x, num_heads, eps, kernels, *params):
        ap = cast_params(AttnParams(*params), x.dtype)
        if kernels:
            o = fused_attn_part_stream(x, ap, num_heads, eps)
        else:
            o = attn_part_stream_math(x, ap, num_heads=num_heads, eps=eps)
        ctx.save_for_backward(x, *params)
        ctx.num_heads, ctx.eps, ctx.kernels = num_heads, eps, kernels
        return o

    @staticmethod
    def backward(ctx, do):
        x, *params = ctx.saved_tensors
        ap = cast_params(AttnParams(*params), x.dtype)
        if ctx.kernels:
            dx, grads = fused_attn_bwd_stream(x, do.contiguous(), ap, ctx.num_heads, ctx.eps)
        else:
            dx, grads = attn_stream_bwd_math(x, do, ap, num_heads=ctx.num_heads, eps=ctx.eps)
        grads = (g.to(t.dtype) for g, t in zip(grads, params))
        return (dx if ctx.needs_input_grad[0] else None, None, None, None, *grads)


def attn_part_stream_train(
    x: torch.Tensor, ap: AttnParams, num_heads: int, eps: float, *, kernels: bool = True
) -> torch.Tensor:
    """The attention half o of a trainable dinov2-base or -large block under
    autograd (JAX ``fused_attn_part_stream`` with its streamed backward):
    ``ap`` holds the parameters as they train (f32, with their graphs), cast
    to the kernels' layout inside; their gradients come back f32. The
    cotangent of o is the stitch's (``x + o*ls1``). Saves only (x, ap) for
    the backward, as JAX does. ``kernels=False``: the plain versions."""
    return _AttnPartStreamTrain.apply(x, num_heads, eps, kernels, *ap)


class _MlpPartStreamTrain(torch.autograd.Function):
    """The MLP half of a trainable streamed block: forward
    ``fused_mlp_part_stream_train`` (y, and h2 saved), backward
    ``fused_mlp_bwd_stream`` (JAX ``fused_mlp_part_stream``'s custom vjp,
    ``_mlp_stream_fwd``/``_mlp_stream_bwd``). With ``kernels=False`` the
    plain versions of both, inside this same function."""

    @staticmethod
    def forward(ctx, x2, eps, kernels, *params):
        mp = cast_params(MlpParams(*params), x2.dtype)
        if kernels:
            y, h2 = fused_mlp_part_stream_train(x2, mp, eps)
        else:
            y, h2 = mlp_part_stream_train_math(x2, mp, eps=eps)
        ctx.save_for_backward(x2, h2, *params)
        ctx.eps, ctx.kernels = eps, kernels
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, h2, *params = ctx.saved_tensors
        mp = cast_params(MlpParams(*params), x2.dtype)
        if ctx.kernels:
            dx2, grads = fused_mlp_bwd_stream(x2, dy.contiguous(), h2, mp, ctx.eps)
        else:
            dx2, grads = mlp_stream_bwd_math(x2, dy, h2, mp, eps=ctx.eps)
        grads = (g.to(t.dtype) for g, t in zip(grads, params))
        return (dx2 if ctx.needs_input_grad[0] else None, None, None, *grads)


def mlp_part_stream_train(
    x2: torch.Tensor, mp: MlpParams, eps: float, *, kernels: bool = True
) -> torch.Tensor:
    """The MLP half of a trainable dinov2-base or -large block under autograd
    (JAX ``fused_mlp_part_stream`` with trainable weights): ``mp`` as they
    train (f32, with their graphs), cast inside, gradients back f32. Saves
    (x2, mp, h2) for the backward, as JAX does. ``kernels=False``: the plain
    versions."""
    return _MlpPartStreamTrain.apply(x2, eps, kernels, *mp)


def block_flops(s: int, d: int, hidden: int | None = None, tp: int = 1) -> dict[str, int]:
    """Matrix-product FLOPs per image of each wrapper's function: the
    products it needs, each counted once. The resident backward halves
    recompute their forward: the MLP backward is six products of 2*S*D*4D
    (h1, h2, dg, dm, dW1, dW2), the attention backward three qkv-sized ones
    (qkv, dWqkv, da), three of 2*S*D^2 (o, dWo, dctx) and six of 2*S^2*D
    (scores, PV, dP, dq, dk, dv). The streamed ones read h2 and need no o:
    the MLP backward five of 2*S*D*4D (h1, dg, dm, dW1, dW2), the attention
    backward the same but two of 2*S*D^2 (dWo, dctx). Not counted: the
    scores the attention backward kernels compute twice (the dq and dk/dv
    kernels each rebuild P), nor JAX's two-pass recompute of h1 or q/k/v.
    The shard wrappers at ``tp`` model shards: the attention half's
    products at the local width D/tp (qkv, scores and PV, out-projection),
    the MLP half and its dx at the local MLP width."""
    h = 4 * d if hidden is None else hidden
    dl, hl = d // tp, h // tp
    attn = 2 * s * d * 3 * d + 4 * s * s * d + 2 * s * d * d
    mlp = 4 * s * d * h
    attn_bwd_stream = 3 * 2 * s * d * 3 * d + 2 * 2 * s * d * d + 6 * 2 * s * s * d
    return {"fused_attn_part": attn, "fused_mlp_part": mlp, "fused_block": attn + mlp,
            "fused_attn_part_stream": attn, "fused_mlp_part_stream": mlp,
            "fused_mlp_dx": 6 * s * d * h, "fused_block_train": attn + mlp,
            "fused_mlp_bwd": 12 * s * d * h,
            "fused_attn_bwd": attn_bwd_stream + 2 * s * d * d,
            "fused_mlp_part_stream_train": mlp, "fused_mlp_bwd_stream": 10 * s * d * h,
            "fused_attn_bwd_stream": attn_bwd_stream,
            "fused_attn_part_partial": 2 * s * d * 3 * dl + 4 * s * s * dl + 2 * s * dl * d,
            "fused_mlp_part_partial": 4 * s * d * hl, "fused_mlp_partial_dx": 6 * s * d * hl}


def block_bytes(b: int, s: int, d: int, hidden: int | None = None,
                tp: int = 1) -> dict[str, int]:
    """Bytes each wrapper must move: bf16 weights and activations once (the
    streamed MLP half's h2 out of its forward and into its backward), f32
    vectors, f32 weight gradients; a shard wrapper its own slice of the
    weights at ``tp`` model shards."""
    h = 4 * d if hidden is None else hidden
    dl, hl = d // tp, h // tp
    act = 2 * b * s * d * 2
    attn_w = (3 * d * d + d * d) * 2 + (2 * d + 3 * d + d) * 4
    mlp_w = 2 * d * h * 2 + (2 * d + h + d + d) * 4
    attn_g = (3 * d * d + d * d) * 4 + (2 * d + 3 * d + d) * 4
    mlp_g = 2 * d * h * 4 + (2 * d + h + d + d) * 4
    block = act + attn_w + mlp_w + d * 4
    return {"fused_attn_part": act + attn_w, "fused_mlp_part": act + mlp_w,
            "fused_attn_part_stream": act + attn_w, "fused_mlp_part_stream": act + mlp_w,
            "fused_block": block, "fused_mlp_dx": 3 * b * s * d * 2 + mlp_w,
            "fused_block_train": block + b * s * d * 2,
            "fused_mlp_bwd": 3 * b * s * d * 2 + mlp_w + mlp_g,
            "fused_attn_bwd": 3 * b * s * d * 2 + attn_w + d * 4 + attn_g + d * 4,
            "fused_mlp_part_stream_train": act + mlp_w + b * s * d * 2,
            "fused_mlp_bwd_stream": 4 * b * s * d * 2 + mlp_w + mlp_g,
            "fused_attn_bwd_stream": 3 * b * s * d * 2 + attn_w + attn_g,
            "fused_attn_part_partial": act + 4 * d * dl * 2 + (2 * d + 3 * dl) * 4,
            "fused_mlp_part_partial": act + 2 * d * hl * 2 + (2 * d + hl) * 4,
            "fused_mlp_partial_dx": 3 * b * s * d * 2 + 2 * d * hl * 2 + (2 * d + hl) * 4}


F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores


def bound_ms(flops: float, nbytes: float, flops_per_s: float = 989e12) -> tuple[float, str]:
    """Least time on an H100 SXM: max(FLOPs / 989 TFLOP/s (bf16 tensor cores;
    ``flops_per_s`` for work of another type, as ``F32_FLOPS``), bytes /
    3.35 TB/s)."""
    t_ops = flops / flops_per_s * 1e3
    t_mem = nbytes / 3.35e12 * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")

