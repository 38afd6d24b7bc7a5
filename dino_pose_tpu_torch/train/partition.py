"""Which parameters train (counterpart of dino_pose_tpu/train/partition.py).

The JAX package splits its parameter tree with a boolean mask; here the same
mask sets ``requires_grad``, so autograd builds no graph below the deepest
trainable parameter and the optimizer sees only the trainable tensors.

dinov2 + LoRA: the pose heads and the adapters' ``lora_A``/``lora_B`` (the
unfreeze count is ignored, as in the JAX package). dinov2 without LoRA: the
pose heads and every parameter of the last ``unfreeze_last_n_layers``
encoder blocks; the final backbone LayerNorm stays frozen. FastViT: the pose
heads (torch keys ``backbone.head.*``), and with LoRA every ConvFFN's
``lora_A``/``lora_B``; unfreeze-last-N is a dinov2 feature.
"""

from __future__ import annotations

from torch import nn


def is_trainable(name: str, use_lora: bool, first_unfrozen: int | None = None) -> bool:
    """Whether the parameter ``name`` trains: the pose heads; under LoRA the
    adapters; otherwise the parameters of encoder blocks
    ``backbone.encoder.layer.{i}`` with ``i >= first_unfrozen`` (None: no
    block trains)."""
    parts = name.split(".")
    if parts[0] == "pose_heads" or parts[:2] == ["backbone", "head"]:
        return True
    if use_lora:
        return "lora_output" in parts or "lora_A" in parts or "lora_B" in parts
    if first_unfrozen is not None and parts[:3] == ["backbone", "encoder", "layer"]:
        return int(parts[3]) >= first_unfrozen
    return False


def trainable_mask(model: nn.Module, config_model: dict) -> dict[str, bool]:
    """{parameter name: trains?} over ``model.named_parameters()``."""
    use_lora = bool(config_model.get("use_lora", False))
    unfreeze_n = int(config_model.get("unfreeze_last_n_layers", 0) or 0)
    first = None
    if unfreeze_n > 0 and hasattr(model.backbone, "encoder"):
        first = len(model.backbone.encoder.layer) - unfreeze_n
    return {name: is_trainable(name, use_lora, first) for name, _ in model.named_parameters()}


def apply_partition(model: nn.Module, config_model: dict) -> frozenset[str]:
    """Set ``requires_grad`` from :func:`trainable_mask`; return the names
    that train."""
    mask = trainable_mask(model, config_model)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return frozenset(n for n, m in mask.items() if m)
