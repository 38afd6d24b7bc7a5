"""Backbone registry and model factory (counterpart of
dino_pose_tpu/models/registry.py).

Both families build: dinov2 (``models/pose.py``) and FastViT
(``models/fastvit_pose.py``, every preset, eval only so far). Weights are
made from a seed with an explicit ``torch.Generator``; trained weights come
in through ``load_state_dict`` (reference schema) or ``io/convert.py`` (the
JAX package's variables).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from dino_pose_tpu_torch.core.device import resolve_device
from dino_pose_tpu_torch.models.fastvit import FASTVIT_PRESETS, ConvLoRA, FastViTConfig
from dino_pose_tpu_torch.models.fastvit_pose import FastVitPoseModule
from dino_pose_tpu_torch.models.pose import DinoPoseModule
from dino_pose_tpu_torch.models.vit import VIT_PRESETS, LoRAAdapter, ViTConfig, _LayerScale
from dino_pose_tpu_torch.train.partition import apply_partition


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


def fastvit_config_for(variant: str, config: dict) -> FastViTConfig:
    """The FastViTConfig a fastvit registry entry builds with ``config``
    (JAX ``create_fastvit_pose``): LoRA of ``lora_rank`` (8 by default) on
    every ConvFFN when ``use_lora``."""
    use_lora = bool(config.get("use_lora", False))
    return dataclasses.replace(
        FASTVIT_PRESETS[variant],
        lora_rank=int(config.get("lora_rank", 8)) if use_lora else 0,
        lora_alpha=float(config.get("lora_alpha", 16)),
        lora_dropout=float(config.get("lora_dropout", 0.1)),
    )


def create_model_from_config(
    config_model: dict[str, Any],
    *,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> DinoPoseModule | FastVitPoseModule:
    """Build a pose model from a ``config_model`` dict, in eval mode, with
    weights drawn from ``seed`` and ``requires_grad`` set by
    ``train.partition``: the backbone frozen outside the LoRA adapters or the
    last ``unfreeze_last_n_layers`` blocks (dinov2 only). ``device``
    defaults to ``cuda``. ``model.input_size`` is the family's input
    resolution: 224 for dinov2, ``input_size`` for FastViT (timm's 256;
    128 for ``test/fastvit-tiny``)."""
    name = resolve_model_name(config_model["model_name"])
    if name not in BACKBONE_REGISTRY:
        raise ValueError(f"Unsupported backbone: {name}")
    entry = BACKBONE_REGISTRY[name]
    dev = resolve_device(device)
    merged = {**entry.default_config, **config_model, "model_name": name}
    num_keypoints = int(merged.get("num_keypoints", 24))
    heatmap_size = int(merged.get("output_heatmap_size", 48))
    with torch.device("meta"):
        if entry.family == "dinov2":
            model = DinoPoseModule(vit_config_for(name, merged), num_keypoints, heatmap_size)
        else:
            model = FastVitPoseModule(fastvit_config_for(entry.variant, merged),
                                      num_keypoints, heatmap_size)
    model = model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    # The reference freezes the backbone when it builds the model; the heads,
    # the LoRA adapters or the last unfrozen blocks stay trainable, by the
    # train step's own rule.
    apply_partition(model, merged)
    model.model_name = name
    model.config_model = merged
    model.input_size = 224 if entry.family == "dinov2" else int(merged.get("input_size", 256))
    return model.to(dev).eval()


def init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """The JAX package's initialisers, drawn from ``gen``: torch-default
    U(+-1/sqrt(fan_in)) for Linear/Conv/ConvTranspose (FastViT's ConvLoRA A
    included), norms and BatchNorm at identity; for dinov2 N(0, 1) for the
    cls and position tokens, LoRA A U(+-1/sqrt(r)) and B = 0, LayerScale at
    its configured init; for FastViT ConvLoRA B = 0 and every LayerScale at
    ``layer_scale_init``."""

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
        if isinstance(model, FastVitPoseModule):
            for m in model.modules():
                if isinstance(m, ConvLoRA):
                    m.lora_B.weight.zero_()
            for name, p in model.named_parameters():
                if name.rsplit(".", 1)[-1] in ("layer_scale", "layer_scale_1", "layer_scale_2"):
                    p.fill_(model.cfg.layer_scale_init)
            return
        emb = model.backbone.embeddings
        for t in (emb.cls_token, emb.position_embeddings):
            t.copy_(torch.randn(t.shape, generator=gen))
        emb.mask_token.zero_()
