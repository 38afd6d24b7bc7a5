"""Plain multi-head attention (counterpart of dino_pose_tpu/ops/attention.py
``xla_attention``).

At the dinov2 serving length (S = 257) the JAX package runs XLA's unfused
attention, not its flash kernel (that engages at S >= 512 and is a later
slice of the port). Inside the fused block kernels the attention is part of
the hand-written CUDA code; this function is the plain version they are held
against.
"""

from __future__ import annotations

import torch


def plain_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """q, k, v: (B, H, S, dh). f32 scores and softmax; the probabilities are
    cast to the input dtype before the PV product, which accumulates in f32
    and rounds to the input dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores * scale, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)
