"""Device resolution for the port's entry points.

The default device is ``cuda``, and under a multi-process launch
(``core/distributed.launch_contract``) this rank's card, ``cuda:LOCAL_RANK``.
Without a card an entry point raises unless the caller asked for the CPU
explicitly: nothing silently carries on there, and two ranks never
silently share a card. An explicit ``device`` always wins.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (``cuda:LOCAL_RANK`` under a launch; raises
    without a card or when the local rank has none); ``"cpu"`` is
    honoured."""
    if device is None:
        from dino_pose_tpu_torch.core.distributed import launch_contract

        launch = launch_contract()
        if launch is not None and launch.world > 1:
            if torch.cuda.is_available() and launch.local_rank >= torch.cuda.device_count():
                raise RuntimeError(
                    f"local rank {launch.local_rank} has no card: this host has "
                    f"{torch.cuda.device_count()}; launch at most one process per card"
                )
            device = f"cuda:{launch.local_rank}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
