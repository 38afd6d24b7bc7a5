"""ReduceLROnPlateau with torch semantics, epoch-level and host-side
(counterpart of dino_pose_tpu/train/schedule.py).

The reference trainer's settings: mode 'min', factor 0.7, patience 3,
min_lr 1e-6, (torch default) relative threshold 1e-4.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PlateauState:
    lr: float
    factor: float = 0.7
    patience: int = 3
    min_lr: float = 1e-6
    threshold: float = 1e-4
    best: float = float("inf")
    num_bad_epochs: int = 0

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d: dict) -> "PlateauState":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def plateau_step(state: PlateauState, val_loss: float) -> PlateauState:
    """Returns the updated scheduler state after one epoch's validation loss."""
    s = dataclasses.replace(state)
    if val_loss < s.best * (1 - s.threshold):
        s.best = val_loss
        s.num_bad_epochs = 0
    else:
        s.num_bad_epochs += 1
    if s.num_bad_epochs > s.patience:
        s.lr = max(s.lr * s.factor, s.min_lr)
        s.num_bad_epochs = 0
    return s
