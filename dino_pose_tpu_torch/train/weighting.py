"""Dynamic kp/z loss balancing, kept on the device
(counterpart of dino_pose_tpu/train/weighting.py).

EMA-tracked per-loss averages (momentum 0.9), a weight EMA'd toward the kp/z
ratio and clamped to [1e-3, 10]. Training minimises the balanced loss
``kp/kp_avg + z/z_avg`` (denominators detached); validation reports
``kp + weight * z``. Every field is a 0-d tensor on the loss's device and
every update is a ``torch.where``: nothing here reads a value back to the
host.
"""

from __future__ import annotations

import dataclasses

import torch

_MOMENTUM = 0.9
_ADJUST_RATE = 0.1
_MIN_WEIGHT = 1e-3
_MAX_WEIGHT = 10.0
_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class LossWeightState:
    weight: torch.Tensor
    kp_avg: torch.Tensor
    z_avg: torch.Tensor
    initialized: torch.Tensor  # bool: averages seeded yet?
    best_weight: torch.Tensor
    best_val_loss: torch.Tensor

    @classmethod
    def create(cls, initial_weight: float = 0.1, device=None) -> "LossWeightState":
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(
            weight=f32(initial_weight), kp_avg=f32(0.0), z_avg=f32(0.0),
            initialized=torch.tensor(False, device=device),
            best_weight=f32(initial_weight), best_val_loss=f32(float("inf")),
        )


def update(state: LossWeightState, kp_loss: torch.Tensor, z_loss: torch.Tensor) -> LossWeightState:
    """Training-step update of the averages and the weight."""
    kp = kp_loss.detach()
    z = z_loss.detach()
    kp_avg = torch.where(state.initialized, _MOMENTUM * state.kp_avg + (1 - _MOMENTUM) * kp, kp)
    z_avg = torch.where(state.initialized, _MOMENTUM * state.z_avg + (1 - _MOMENTUM) * z, z)
    target = (kp + _EPS) / (z + _EPS)
    weight = torch.clamp(
        (1 - _ADJUST_RATE) * state.weight + _ADJUST_RATE * target, _MIN_WEIGHT, _MAX_WEIGHT
    )
    return dataclasses.replace(
        state, weight=weight, kp_avg=kp_avg, z_avg=z_avg,
        initialized=torch.ones_like(state.initialized),
    )


def balanced_loss(state: LossWeightState, kp_loss: torch.Tensor, z_loss: torch.Tensor) -> torch.Tensor:
    """Training objective; ``state`` must already be updated this step."""
    normalized = kp_loss / (state.kp_avg + _EPS) + z_loss / (state.z_avg + _EPS)
    fallback = kp_loss + state.weight * z_loss
    return torch.where(state.initialized, normalized, fallback)


def validation_loss(state: LossWeightState, kp_loss: torch.Tensor, z_loss: torch.Tensor) -> torch.Tensor:
    return kp_loss + state.weight * z_loss


def loss_contributions(state: LossWeightState, kp_loss: torch.Tensor, z_loss: torch.Tensor):
    kp_c = torch.where(state.initialized, kp_loss / (state.kp_avg + _EPS), kp_loss)
    z_c = torch.where(state.initialized, z_loss / (state.z_avg + _EPS), state.weight * z_loss)
    return kp_c, z_c


def update_best(state: LossWeightState, val_loss: torch.Tensor) -> LossWeightState:
    """Track the weight that achieved the best validation loss."""
    better = val_loss < state.best_val_loss
    return dataclasses.replace(
        state,
        best_val_loss=torch.where(better, val_loss, state.best_val_loss),
        best_weight=torch.where(better, state.weight, state.best_weight),
    )
