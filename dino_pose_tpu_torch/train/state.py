"""Train state and optimizer (counterpart of dino_pose_tpu/train/state.py).

The JAX optimizer is ``optax.chain(scale_by_adam(0.9, 0.999, 1e-8),
add_decayed_weights(wd))`` with the step applying ``-lr``:
p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p). ``torch.optim.AdamW``
applies the decay first, p <- p * (1 - lr * wd), then the same Adam step;
the Adam step does not read p, so the update is the same. It runs over the
trainable parameters only, and the step sets the learning rate each call.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch
from torch import nn

from dino_pose_tpu_torch.train.partition import apply_partition
from dino_pose_tpu_torch.train.weighting import LossWeightState


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    loss_weight: LossWeightState


def make_optimizer(params: Iterable[torch.Tensor], weight_decay: float) -> torch.optim.AdamW:
    """AdamW with torch's hyperparameters; the learning rate is set per step."""
    return torch.optim.AdamW(
        list(params), lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


def create_train_state(
    model: nn.Module,
    config_model: dict,
    weight_decay: float = 1e-6,
) -> tuple[TrainState, torch.optim.AdamW, frozenset[str]]:
    """Apply the partition to ``model`` and build its optimizer and state
    (loss weight 0.1, the JAX default). Returns ``(state, optimizer,
    trainable names)``."""
    partition = apply_partition(model, config_model)
    optimizer = make_optimizer((p for p in model.parameters() if p.requires_grad), weight_decay)
    device = next(model.parameters()).device
    state = TrainState(
        step=0, model=model, optimizer=optimizer,
        loss_weight=LossWeightState.create(device=device),
    )
    return state, optimizer, partition
