"""Mixed-precision policy (counterpart of dino_pose_tpu/core/precision.py).

bf16 compute on the card, f32 on the CPU (CPU runs stay deterministic and
comparable with the JAX package's f32 tests); parameters are stored in f32.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def policy_for_device(device: torch.device | str) -> Policy:
    """bf16 compute on CUDA, f32 elsewhere."""
    return DEFAULT_POLICY if torch.device(device).type == "cuda" else FP32_POLICY
