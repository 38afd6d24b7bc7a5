"""Backbone registry and model factory (counterpart of
dino_pose_tpu/models/registry.py).

Only the dinov2 family is ported; FastViT names are registered (so that
names resolve as in the JAX package) but raise ``NotImplementedError``.
Weights are made from a seed with an explicit ``torch.Generator``; trained
weights come in through ``load_state_dict`` (reference schema) or
``io/convert.py`` (the JAX package's variables).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from dino_pose_tpu_torch.core.device import resolve_device
from dino_pose_tpu_torch.models.pose import DinoPoseModule
from dino_pose_tpu_torch.models.vit import VIT_PRESETS, LoRAAdapter, ViTConfig, _LayerScale


@dataclasses.dataclass
class BackboneEntry:
    family: str
    default_config: dict
    variant: str = ""


_DINO_DEFAULT = {
    "num_keypoints": 24,
    "output_heatmap_size": 48,
    "use_lora": False,
    "unfreeze_last_n_layers": 0,
}
_FASTVIT_DEFAULT = {"num_keypoints": 24, "output_heatmap_size": 48, "use_lora": False}

BACKBONE_REGISTRY: dict[str, BackboneEntry] = {
    "facebook/dinov2-small": BackboneEntry("dinov2", dict(_DINO_DEFAULT)),
    "facebook/dinov2-base": BackboneEntry("dinov2", dict(_DINO_DEFAULT)),
    "facebook/dinov2-large": BackboneEntry("dinov2", dict(_DINO_DEFAULT)),
    "timm/fastvit_t8.apple_in1k": BackboneEntry("fastvit", dict(_FASTVIT_DEFAULT), "t8"),
    "timm/fastvit_ma36.apple_in1k": BackboneEntry("fastvit", dict(_FASTVIT_DEFAULT), "ma36"),
    "timm/fastvit_sa12.apple_in1k": BackboneEntry("fastvit", dict(_FASTVIT_DEFAULT), "sa12"),
    "timm/fastvit_sa24.apple_in1k": BackboneEntry("fastvit", dict(_FASTVIT_DEFAULT), "sa24"),
    "timm/fastvit_sa36.apple_in1k": BackboneEntry("fastvit", dict(_FASTVIT_DEFAULT), "sa36"),
    "test/vit-tiny": BackboneEntry("dinov2", dict(_DINO_DEFAULT)),
    "test/fastvit-tiny": BackboneEntry(
        "fastvit", dict(_FASTVIT_DEFAULT, input_size=128), "test-tiny"
    ),
}

FAMILY_DEFAULTS: dict[str, str] = {
    "dinov2": "facebook/dinov2-small",
    "fastvit": "timm/fastvit_t8.apple_in1k",
}


def resolve_model_name(model_name_or_family: str) -> str:
    if model_name_or_family in BACKBONE_REGISTRY:
        return model_name_or_family
    return FAMILY_DEFAULTS.get(model_name_or_family, model_name_or_family)


def vit_config_for(name: str, config: dict) -> ViTConfig:
    """The ViTConfig a dinov2 registry entry builds with ``config``."""
    preset = VIT_PRESETS[name]
    use_lora = bool(config.get("use_lora", False))
    return dataclasses.replace(
        preset,
        lora_layers=(preset.num_layers - 1,) if use_lora else (),
        lora_rank=int(config.get("lora_rank", 8)),
        lora_alpha=float(config.get("lora_alpha", 16)),
        lora_dropout=float(config.get("lora_dropout", 0.1)),
        num_unfrozen_layers=0 if use_lora else int(
            config.get("unfreeze_last_n_layers", 0) or 0
        ),
    )


def create_model_from_config(
    config_model: dict[str, Any],
    *,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> DinoPoseModule:
    """Build a pose model from a ``config_model`` dict, in eval mode, with
    weights drawn from ``seed``. ``device`` defaults to ``cuda``."""
    name = resolve_model_name(config_model["model_name"])
    if name not in BACKBONE_REGISTRY:
        raise ValueError(f"Unsupported backbone: {name}")
    entry = BACKBONE_REGISTRY[name]
    if entry.family != "dinov2":
        raise NotImplementedError(f"{name} ({entry.family}) is not yet ported")
    dev = resolve_device(device)
    merged = {**entry.default_config, **config_model, "model_name": name}
    with torch.device("meta"):
        model = DinoPoseModule(
            vit_config_for(name, merged),
            num_keypoints=int(merged.get("num_keypoints", 24)),
            heatmap_size=int(merged.get("output_heatmap_size", 48)),
        )
    model = model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    model.model_name = name
    model.config_model = merged
    return model.to(dev).eval()


def init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """The JAX package's initialisers, drawn from ``gen``: torch-default
    U(+-1/sqrt(fan_in)) for Linear/Conv/ConvTranspose, N(0, 1) for the cls
    and position tokens, LoRA A U(+-1/sqrt(r)) and B = 0, LayerScale at its
    configured init, norms and BatchNorm at identity."""

    def uniform_(t: torch.Tensor, bound: float) -> None:
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                if isinstance(m, nn.ConvTranspose2d):
                    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                else:
                    fan_in = math.prod(w.shape[1:])
                bound = 1.0 / math.sqrt(max(1, fan_in))
                uniform_(w, bound)
                if m.bias is not None:
                    uniform_(m.bias, bound)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
                    m.num_batches_tracked.zero_()
            elif isinstance(m, LoRAAdapter):
                uniform_(m.lora_A, 1.0 / math.sqrt(m.lora_A.shape[1]))
                m.lora_B.zero_()
            elif isinstance(m, _LayerScale):
                m.lambda1.fill_(model.vit.layerscale_init)
        emb = model.backbone.embeddings
        for t in (emb.cls_token, emb.position_embeddings):
            t.copy_(torch.randn(t.shape, generator=gen))
        emb.mask_token.zero_()
