"""Multi-head attention: the plain version and the streamed ("flash")
attention kernels (counterpart of dino_pose_tpu/ops/attention.py).

=====================  ===================  =================================
wrapper                plain version        TPU kernel it replaces
=====================  ===================  =================================
``flash_attention``    ``flash_math``       ``_flash_kernel`` (attention.py:40)
its backward           ``flash_bwd_math``   ``_flash_bwd_kernel`` (:130)
=====================  ===================  =================================

``flash_attention`` is a ``torch.autograd.Function`` on (B, H, S, dh)
tensors, the counterpart of JAX's ``custom_vjp`` (attention.py:240-254). On
a CUDA tensor its forward launches ``flash_fwd_kernel`` and its backward
``flash_bwd_dq_kernel`` then ``flash_bwd_dkv_kernel``
(``ops/csrc/flash_kernels.cu``, bf16, head width 32 or 64, any S): every
product a ``wgmma``, K and V (Q and dO) streamed by TMA through a ring of
``mbarrier`` stages that a producer warp keeps full, P and dS fed to the
tensor cores from registers, JAX's rounding points kept; it never falls
back. On the CPU it runs ``flash_math`` and ``flash_bwd_math`` inside the
same function, so that both paths keep JAX's f32 intermediates.
``flash_cost`` counts their work: JAX's FLOPs and bytes, which give the
bound, and the FLOPs the kernels execute.

The same kernels are the attention step of the block chains
(``ops/block.py``) wherever the head's K and V do not fit shared memory
(S > ~320 at dh = 64): at 504² input all twelve dinov2 layers take them.
FastViT's SpatialAttention (``models/fastvit.py``; the JAX package's
fastvit.py:850) calls :func:`attention`: in fastvit_sa12 at 256², 16 heads
of 32 over an 8x8 grid, S = 64, in each of its two attention blocks.
"""

from __future__ import annotations

import torch

from dino_pose_tpu_torch.ops import _ext

def plain_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """q, k, v: (B, H, S, dh). f32 scores and softmax; the probabilities are
    cast to the input dtype before the PV product, which accumulates in f32
    and rounds to the input dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores * scale, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def flash_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of ``_flash_kernel`` (attention.py:40-69) on (B, H, S, dh):
    f32 probabilities rounded to the input dtype before P V, which sums in
    f32 and is rounded once — the rounding points of ``plain_attention``."""
    return plain_attention(q, k, v, scale)


def flash_bwd_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                   scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``_flash_bwd_kernel`` (attention.py:130-186): P and
    dP = dO V^T in f32, dS = P * (dP - rowsum(P * dP)); bf16(P) and bf16(dS)
    (the input dtype) enter dv = P^T dO, dk = dS^T Q * scale and
    dq = dS K * scale, which sum in f32 and are rounded once."""
    dt = q.dtype
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    del dp
    pb = p.to(dt).float()
    del p
    dsb = ds.to(dt).float()
    del ds
    dv = torch.matmul(pb.transpose(-1, -2), dof).to(dt)
    dk = (torch.matmul(dsb.transpose(-1, -2), q.float()) * scale).to(dt)
    dq = (torch.matmul(dsb, k.float()) * scale).to(dt)
    return dq, dk, dv


def flash_cost(b: int, h: int, s: int, dh: int) -> dict[str, tuple[int, int, int]]:
    """(FLOPs, bytes, executed FLOPs) of the flash forward and backward on
    (b, h, s, dh) bf16 tensors. FLOPs and bytes are the JAX kernels'
    ``CostEstimate`` (attention.py:120-124 and :226-230) at the true length
    s, where JAX counts its padded one: 4 and 10 * B*H*S^2*dh FLOPs; q, k, v
    in and o out, then q, k, v and the cotangent in and dq, dk, dv out, each
    once. They give the bound. The kernels execute 6 (Q K^T in both passes)
    and 18 (Q K^T and dO V^T in both passes of the dq kernel and again in
    the dkv kernel) * B*H*S^2*dh: the price of the normalised P and the
    exact rowsum(P * dP)."""
    unit, act = b * h * s * s * dh, b * h * s * dh * 2
    return {"flash_attention": (4 * unit, 4 * act, 6 * unit),
            "flash_attention_bwd": (10 * unit, 7 * act, 18 * unit)}


def _check(name: str, *tensors: torch.Tensor) -> None:
    shape = tensors[0].shape
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernels take bf16, got {t.dtype}")
        if t.dim() != 4 or t.shape != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: q, k, v (and the cotangent) must be contiguous, "
                             f"16-byte aligned (B, H, S, dh) tensors of one shape")
    if shape[-1] not in (32, 64):
        raise ValueError(f"{name}: head width {shape[-1]} is not 32 or 64")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_fwd_kernel`` on CUDA (B, H, S, dh) bf16 tensors:
    (o, stats), stats (B, H, 3, S) f32 holding each row's max and sum in its
    first two rows for the backward."""
    name = "flash_fwd"
    _check(name, q, k, v)
    b, h, s, dh = q.shape
    o = torch.empty_like(q)
    stats = torch.empty((b, h, 3, s), dtype=torch.float32, device=q.device)
    err = _ext.lib().dp_flash_fwd(*(t.data_ptr() for t in (q, k, v, o, stats)),
                                  b, h, s, dh, scale, _stream())
    _ext.check(err, name)
    _ext.LAUNCHES[name] += 1
    return o, stats


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
              stats: torch.Tensor, scale: float
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel``: (dq, dk,
    dv) from the cotangent ``do`` and the forward's ``stats`` (a copy is
    written: its third row takes rowsum(P * dP))."""
    name = "flash_bwd"
    _check(name, q, k, v, do)
    b, h, s, dh = q.shape
    if stats.shape != (b, h, 3, s) or stats.dtype != torch.float32:
        raise ValueError(f"{name}: stats must be the forward's (B, H, 3, S) f32 tensor")
    stats = stats.clone()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    err = _ext.lib().dp_flash_bwd(*(t.data_ptr() for t in (q, k, v, do, stats, dq, dk, dv)),
                                  b, h, s, dh, scale, _stream())
    _ext.check(err, name)
    _ext.LAUNCHES[name] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            o, stats = flash_math(q, k, v, scale), None
        elif q.device.type == "cuda":
            o, stats = flash_fwd(q, k, v, scale)
        else:
            raise ValueError(f"unsupported device {q.device}")
        ctx.save_for_backward(q, k, v, stats)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, stats = ctx.saved_tensors
        if stats is None:
            grads = flash_bwd_math(q, k, v, do, ctx.scale)
        else:
            grads = flash_bwd(q, k, v, do.contiguous(), stats, ctx.scale)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v on (B, H, S, dh) tensors under autograd (JAX
    ``flash_attention``). On the card the forward is ``flash_fwd_kernel``
    (one launch, ``_ext.LAUNCHES["flash_fwd"]``) and the backward the dq/dkv
    kernel pair (``_ext.LAUNCHES["flash_bwd"]``); on the CPU ``flash_math`` and
    ``flash_bwd_math``. Saves q, k, v and, on the card, the forward's row
    max and sum (B*H*S*8 bytes) for the backward, where JAX saves only
    q, k, v and its backward recomputes the rows' statistics."""
    return _FlashAttention.apply(q, k, v, scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The JAX dispatcher's counterpart (attention.py:266), called by
    FastViT's SpatialAttention: the streamed kernels on the card at every S
    (where the JAX package takes its flash kernel from S = 512 on a TPU and
    XLA's unfused attention below; the kernel keeps no (S, S) score tensor
    in device memory at any length), the plain versions on the CPU."""
    return flash_attention(q, k, v, scale)
