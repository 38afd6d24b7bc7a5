"""Weight carry: the JAX package's variables -> the port's ``state_dict``.

The input is ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays (what ``jax.device_get`` of the JAX model's variables gives; no JAX is
needed here). The output carries the reference torch key names
(``backbone.encoder.layer.11.attention.original_attention.attention.query.weight``,
``pose_heads.heatmap_head.feature_refine.0.weight``, ...), so
``DinoPoseModule.load_state_dict(..., strict=True)`` takes it, and
reference-schema ``.pth`` files load the same way.

Layout transforms per parameter kind (JAX layout -> torch layout):

==========  ===========================  =============================
kind        JAX layout                   torch layout
==========  ===========================  =============================
linear      (in, out)                    (out, in)
conv        (kh, kw, in/g, out) [HWIO]   (out, in/g, kh, kw)
convT       (kh, kw, in, out), flipped   (in, out, kh, kw), unflipped
none        identical                    identical
==========  ===========================  =============================

``ConvTranspose`` in the JAX package stores the kernel of the equivalent
dilated convolution (spatially flipped); torch's ``ConvTranspose2d`` takes
the unflipped weight, hence the flip back.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Rule:
    """One parameter correspondence: JAX variable path <-> torch key."""

    jax_path: tuple[str, ...]
    torch_key: str
    kind: str = "none"  # linear | conv | convT | none


def _to_torch(w: np.ndarray, kind: str) -> np.ndarray:
    if kind == "linear":
        return np.ascontiguousarray(w.T)
    if kind == "conv":
        return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))
    if kind == "convT":
        return np.ascontiguousarray(np.transpose(w[::-1, ::-1], (2, 3, 0, 1)))
    return np.asarray(w)


def vit_rules(num_layers: int, lora_layers: Iterable[int] = ()) -> list[Rule]:
    """DINOv2 backbone vs HF ``Dinov2Model`` keys; ``lora_layers`` move under
    ``attention.original_attention`` beside ``attention.lora_output``."""
    lora_layers = set(lora_layers)
    rules = [
        Rule(("cls_token",), "embeddings.cls_token"),
        Rule(("mask_token",), "embeddings.mask_token"),
        Rule(("pos_embed",), "embeddings.position_embeddings"),
        Rule(("patch_embed", "kernel"), "embeddings.patch_embeddings.projection.weight", "conv"),
        Rule(("patch_embed", "bias"), "embeddings.patch_embeddings.projection.bias"),
        Rule(("layernorm", "scale"), "layernorm.weight"),
        Rule(("layernorm", "bias"), "layernorm.bias"),
    ]
    for i in range(num_layers):
        fl = (f"layer{i}",)
        tl = f"encoder.layer.{i}."
        attn = f"{tl}attention."
        if i in lora_layers:
            attn = f"{tl}attention.original_attention."
            rules += [
                Rule(fl + ("attention", "lora_output", "lora_A"), f"{tl}attention.lora_output.lora_A"),
                Rule(fl + ("attention", "lora_output", "lora_B"), f"{tl}attention.lora_output.lora_B"),
            ]
        for nm in ("query", "key", "value"):
            rules += [
                Rule(fl + ("attention", nm, "kernel"), f"{attn}attention.{nm}.weight", "linear"),
                Rule(fl + ("attention", nm, "bias"), f"{attn}attention.{nm}.bias"),
            ]
        rules += [
            Rule(fl + ("attention", "out", "kernel"), f"{attn}output.dense.weight", "linear"),
            Rule(fl + ("attention", "out", "bias"), f"{attn}output.dense.bias"),
            Rule(fl + ("norm1", "scale"), f"{tl}norm1.weight"),
            Rule(fl + ("norm1", "bias"), f"{tl}norm1.bias"),
            Rule(fl + ("norm2", "scale"), f"{tl}norm2.weight"),
            Rule(fl + ("norm2", "bias"), f"{tl}norm2.bias"),
            Rule(fl + ("layerscale1",), f"{tl}layer_scale1.lambda1"),
            Rule(fl + ("layerscale2",), f"{tl}layer_scale2.lambda1"),
            Rule(fl + ("fc1", "kernel"), f"{tl}mlp.fc1.weight", "linear"),
            Rule(fl + ("fc1", "bias"), f"{tl}mlp.fc1.bias"),
            Rule(fl + ("fc2", "kernel"), f"{tl}mlp.fc2.weight", "linear"),
            Rule(fl + ("fc2", "bias"), f"{tl}mlp.fc2.bias"),
        ]
    return rules


def _conv_bn_rules(jax_base, torch_conv, torch_bn, *, deconv=False) -> list[Rule]:
    """A Conv(Transpose)+BatchNorm pair; BN running stats live in
    ``batch_stats``."""
    kind = "convT" if deconv else "conv"
    conv = "deconv" if deconv else "conv"
    return [
        Rule(("params",) + jax_base + (conv, "kernel"), f"{torch_conv}.weight", kind),
        Rule(("params",) + jax_base + (conv, "bias"), f"{torch_conv}.bias"),
        Rule(("params",) + jax_base + ("bn", "scale"), f"{torch_bn}.weight"),
        Rule(("params",) + jax_base + ("bn", "bias"), f"{torch_bn}.bias"),
        Rule(("batch_stats",) + jax_base + ("bn", "mean"), f"{torch_bn}.running_mean"),
        Rule(("batch_stats",) + jax_base + ("bn", "var"), f"{torch_bn}.running_var"),
    ]


def spatial_heads_rules(num_up_stages: int = 2, z_hidden_count: int = 3) -> list[Rule]:
    """``SpatialAwarePoseHeads`` vs the reference Sequential index naming."""
    hm = ("pose_heads", "heatmap_head")
    thm = "pose_heads.heatmap_head."
    hg = hm + ("hourglass",)
    thg = f"{thm}feature_refine.3."
    rules: list[Rule] = []
    rules += _conv_bn_rules(hm + ("refine_in",), f"{thm}feature_refine.0", f"{thm}feature_refine.1")
    rules += _conv_bn_rules(hg + ("dw",), f"{thg}depthwise_conv.0", f"{thg}depthwise_conv.1")
    rules += _conv_bn_rules(hg + ("pw",), f"{thg}depthwise_conv.3", f"{thg}depthwise_conv.4")
    rules += _conv_bn_rules(hg + ("down1",), f"{thg}down1.0", f"{thg}down1.1")
    rules += _conv_bn_rules(hg + ("down2",), f"{thg}down2.0", f"{thg}down2.1")
    rules += _conv_bn_rules(hg + ("btl1",), f"{thg}bottleneck.0", f"{thg}bottleneck.1")
    rules += [
        Rule(("params",) + hg + ("btl2_conv", "kernel"), f"{thg}bottleneck.3.weight", "conv"),
        Rule(("params",) + hg + ("btl2_conv", "bias"), f"{thg}bottleneck.3.bias"),
        Rule(("params",) + hg + ("btl2_bn", "scale"), f"{thg}bottleneck.4.weight"),
        Rule(("params",) + hg + ("btl2_bn", "bias"), f"{thg}bottleneck.4.bias"),
        Rule(("batch_stats",) + hg + ("btl2_bn", "mean"), f"{thg}bottleneck.4.running_mean"),
        Rule(("batch_stats",) + hg + ("btl2_bn", "var"), f"{thg}bottleneck.4.running_var"),
    ]
    rules += _conv_bn_rules(hg + ("up1",), f"{thg}up1.0", f"{thg}up1.1", deconv=True)
    rules += _conv_bn_rules(hg + ("up2",), f"{thg}up2.0", f"{thg}up2.1", deconv=True)
    rules += _conv_bn_rules(hg + ("skip",), f"{thg}skip.0", f"{thg}skip.1")
    rules += _conv_bn_rules(hm + ("refine_out",), f"{thm}feature_refine.4", f"{thm}feature_refine.5")
    for j in range(num_up_stages):
        rules += _conv_bn_rules(
            hm + (f"up{j}",), f"{thm}upsampling.{j}.0", f"{thm}upsampling.{j}.1", deconv=True
        )
    rules += _conv_bn_rules(hm + ("pred_conv",), f"{thm}prediction.0", f"{thm}prediction.1")
    rules += [
        Rule(("params",) + hm + ("pred_out", "kernel"), f"{thm}prediction.3.weight", "conv"),
        Rule(("params",) + hm + ("pred_out", "bias"), f"{thm}prediction.3.bias"),
    ]
    z = ("pose_heads", "z_head")
    tz = "pose_heads.z_head.mlp."
    for j in range(z_hidden_count):
        rules += [
            Rule(("params",) + z + (f"fc{j}", "kernel"), f"{tz}{3 * j}.weight", "linear"),
            Rule(("params",) + z + (f"fc{j}", "bias"), f"{tz}{3 * j}.bias"),
        ]
    rules += [
        Rule(("params",) + z + ("out", "kernel"), f"{tz}{3 * z_hidden_count}.weight", "linear"),
        Rule(("params",) + z + ("out", "bias"), f"{tz}{3 * z_hidden_count}.bias"),
    ]
    return rules


def dinov2_pose_rules(
    num_layers: int, lora_layers: Iterable[int] = (), num_up_stages: int = 2
) -> list[Rule]:
    """Full variable-tree mapping for ``DinoPoseModule``."""
    rules = [
        Rule(("params", "backbone") + r.jax_path, f"backbone.{r.torch_key}", r.kind)
        for r in vit_rules(num_layers, lora_layers)
    ]
    return rules + spatial_heads_rules(num_up_stages)


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def state_dict_from_jax(variables: Mapping, model) -> dict[str, torch.Tensor]:
    """Render the JAX variables of a dinov2 pose model into the port's
    ``state_dict`` for ``model`` (a ``DinoPoseModule``). Every key of the
    model is produced, BatchNorm ``num_batches_tracked`` as 0."""
    from dino_pose_tpu_torch.models.heads import upsampling_plan

    vit = model.vit
    num_up = len(upsampling_plan(model.input_size // vit.patch_size, model.heatmap_size))
    rules = dinov2_pose_rules(vit.num_layers, vit.lora_layers, num_up)
    flat = _flatten(variables)
    out: dict[str, torch.Tensor] = {}
    for rule in rules:
        if rule.jax_path not in flat:
            raise KeyError(f"JAX variables miss {'/'.join(rule.jax_path)} (for {rule.torch_key})")
        w = _to_torch(flat[rule.jax_path], rule.kind).astype(np.float32)
        out[rule.torch_key] = torch.from_numpy(w.copy())
        if rule.torch_key.endswith(".running_mean"):
            key = rule.torch_key.replace(".running_mean", ".num_batches_tracked")
            out[key] = torch.zeros((), dtype=torch.long)
    return out
