"""Device resolution for the port's entry points.

The default device is ``cuda``. Without a card an entry point raises unless
the caller asked for the CPU explicitly: nothing silently carries on there.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); ``"cpu"`` is honoured."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
