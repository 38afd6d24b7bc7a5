"""Which parameters train (counterpart of dino_pose_tpu/train/partition.py).

The JAX package splits its parameter tree with a boolean mask; here the same
mask sets ``requires_grad``, so autograd builds no graph below the deepest
trainable parameter and the optimizer sees only the trainable tensors.

dinov2 + LoRA: the pose heads and the adapters' ``lora_A``/``lora_B``.
dinov2 without LoRA: the pose heads only. Unfreeze-last-N without LoRA is
refused: the forward block kernels have no backward in the port yet.
"""

from __future__ import annotations

from torch import nn


def is_trainable(name: str, use_lora: bool) -> bool:
    """Whether the parameter ``name`` trains: the pose heads, and under LoRA
    the adapters. The registry builds models frozen by this rule too."""
    parts = name.split(".")
    if parts[0] == "pose_heads":
        return True
    return use_lora and ("lora_output" in parts or parts[-1] in ("lora_A", "lora_B"))


def trainable_mask(model: nn.Module, config_model: dict) -> dict[str, bool]:
    """{parameter name: trains?} over ``model.named_parameters()``."""
    use_lora = bool(config_model.get("use_lora", False))
    unfreeze_n = int(config_model.get("unfreeze_last_n_layers", 0) or 0)
    if unfreeze_n > 0 and not use_lora:
        raise NotImplementedError(
            "unfreeze_last_n_layers > 0 trains whole encoder blocks, which the "
            "unfreeze-last-N slice of the port brings (the block kernels have "
            "no backward yet); use LoRA or unfreeze_last_n_layers=0"
        )
    return {name: is_trainable(name, use_lora) for name, _ in model.named_parameters()}


def apply_partition(model: nn.Module, config_model: dict) -> frozenset[str]:
    """Set ``requires_grad`` from :func:`trainable_mask`; return the names
    that train."""
    mask = trainable_mask(model, config_model)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return frozenset(n for n, m in mask.items() if m)
