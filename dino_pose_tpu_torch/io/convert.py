"""Weight carry: the JAX package's variables -> the port's ``state_dict``.

The input is ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays (what ``jax.device_get`` of the JAX model's variables gives; no JAX is
needed here). The output carries the reference torch key names
(``backbone.encoder.layer.11.attention.original_attention.attention.query.weight``,
``pose_heads.heatmap_head.feature_refine.0.weight``, ...; for FastViT
timm's ``backbone.stem.0.rbr_conv.0.conv.weight``, ..., heads under
``backbone.head.``), so ``DinoPoseModule`` and ``FastVitPoseModule`` take it
with ``load_state_dict(..., strict=True)``, and reference-schema ``.pth``
files load the same way.

Layout transforms per parameter kind (JAX layout -> torch layout):

==========  ===========================  =============================
kind        JAX layout                   torch layout
==========  ===========================  =============================
linear      (in, out)                    (out, in)
conv        (kh, kw, in/g, out) [HWIO]   (out, in/g, kh, kw)
convT       (kh, kw, in, out), flipped   (in, out, kh, kw), unflipped
scale2d     (C,)                         (C, 1, 1) (FastViT LayerScale)
none        identical                    identical
==========  ===========================  =============================

``ConvTranspose`` in the JAX package stores the kernel of the equivalent
dilated convolution (spatially flipped); torch's ``ConvTranspose2d`` takes
the unflipped weight, hence the flip back.

Pretrained DINOv2 weights from the hub cache (``io/hf_cache.py``) carry
the plain HF keys; :func:`backbone_state_from_hf` renames them onto the
backbone, LoRA layers included, from the same rule table.

A JAX ``TrainState`` carries over in two parts: ``params`` and
``batch_stats`` through :func:`state_dict_from_jax`, ``loss_weight``
through :func:`loss_weight_from_jax`. Adam moments are not carried (both
sides start them at zero).
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
    kind: str = "none"  # linear | conv | convT | scale2d | none


def _to_torch(w: np.ndarray, kind: str) -> np.ndarray:
    if kind == "linear":
        return np.ascontiguousarray(w.T)
    if kind == "conv":
        return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))
    if kind == "convT":
        return np.ascontiguousarray(np.transpose(w[::-1, ::-1], (2, 3, 0, 1)))
    if kind == "scale2d":
        return np.asarray(w).reshape(-1, 1, 1)
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


def backbone_state_from_hf(hf_state: Mapping[str, torch.Tensor], num_layers: int,
                           lora_layers: Iterable[int] = ()) -> dict[str, torch.Tensor]:
    """HF ``Dinov2Model`` weights (plain keys, torch layout) under the
    port's ``backbone.`` names: the rules of the plain layout and of the
    ``lora_layers`` one paired by their JAX path, so a LoRA layer's
    ``attention.attention.query.weight`` lands on
    ``attention.original_attention.attention.query.weight``. Keys the rules
    do not name are left out; the layouts match, so tensors pass as they
    are."""
    port = {r.jax_path: r.torch_key for r in vit_rules(num_layers, lora_layers)}
    return {f"backbone.{port[r.jax_path]}": hf_state[r.torch_key]
            for r in vit_rules(num_layers) if r.torch_key in hf_state}


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


def spatial_heads_rules(num_up_stages: int = 2, z_hidden_count: int = 3,
                        torch_prefix: str = "pose_heads.") -> list[Rule]:
    """``SpatialAwarePoseHeads`` vs the reference Sequential index naming;
    the torch keys under ``torch_prefix`` (FastViT: ``backbone.head.``)."""
    hm = ("pose_heads", "heatmap_head")
    thm = f"{torch_prefix}heatmap_head."
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
    tz = f"{torch_prefix}z_head.mlp."
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


def _split_conv_bn_rules(path: tuple[str, ...], jconv: str, jbn: str, tconv: str,
                         tbn: str) -> list[Rule]:
    """A (conv, BN) pair whose JAX variables are siblings (``<name>/kernel``
    beside ``<name>_bn``) vs torch ``<tconv>.weight`` / ``<tbn>.*``."""
    return [
        Rule(("params",) + path + (jconv, "kernel"), f"{tconv}.weight", "conv"),
        Rule(("params",) + path + (jbn, "scale"), f"{tbn}.weight"),
        Rule(("params",) + path + (jbn, "bias"), f"{tbn}.bias"),
        Rule(("batch_stats",) + path + (jbn, "mean"), f"{tbn}.running_mean"),
        Rule(("batch_stats",) + path + (jbn, "var"), f"{tbn}.running_var"),
    ]


def _bn_module_rules(path: tuple[str, ...], tbn: str) -> list[Rule]:
    """A standalone torch BatchNorm2d."""
    return [
        Rule(("params",) + path + ("scale",), f"{tbn}.weight"),
        Rule(("params",) + path + ("bias",), f"{tbn}.bias"),
        Rule(("batch_stats",) + path + ("mean",), f"{tbn}.running_mean"),
        Rule(("batch_stats",) + path + ("var",), f"{tbn}.running_var"),
    ]


def mobileone_rules(path: tuple[str, ...], tp: str, *, kernel: int = 3, identity: bool = True,
                    num_branches: int = 1, use_se: bool = False) -> list[Rule]:
    """MobileOneBlock: JAX conv{b}/conv{b}_bn/scale/scale_bn/skip_bn/se vs
    torch rbr_conv.{b}/rbr_scale/rbr_skip/se."""
    rules: list[Rule] = []
    for b in range(num_branches):
        rules += _split_conv_bn_rules(path, f"conv{b}", f"conv{b}_bn",
                                      f"{tp}rbr_conv.{b}.conv", f"{tp}rbr_conv.{b}.bn")
    if kernel > 1:
        rules += _split_conv_bn_rules(path, "scale", "scale_bn",
                                      f"{tp}rbr_scale.conv", f"{tp}rbr_scale.bn")
    if identity:
        rules += _bn_module_rules(path + ("skip_bn",), f"{tp}rbr_skip")
    if use_se:
        for nm in ("reduce", "expand"):
            rules += [
                Rule(("params",) + path + ("se", nm, "kernel"), f"{tp}se.{nm}.weight", "conv"),
                Rule(("params",) + path + ("se", nm, "bias"), f"{tp}se.{nm}.bias"),
            ]
    return rules


def fastvit_backbone_rules(cfg) -> list[Rule]:
    """The FastViT backbone vs timm's keys under ``backbone.``: ``stem.{i}``,
    ``stages.{i}.{downsample.proj.{0,1},pos_emb,blocks.{j}}``,
    ``final_conv``. A RepMixer block's ``layer_scale_2`` is torch's
    ``layer_scale``, an attention block's ``layer_scale_2``; LoRA moves fc1
    and fc2 under ``original_conv``."""
    base, p = ("backbone",), "backbone."
    lora = cfg.lora_rank > 0
    rules = mobileone_rules(base + ("stem0",), f"{p}stem.0.", identity=False)
    rules += mobileone_rules(base + ("stem1",), f"{p}stem.1.", identity=False)
    rules += mobileone_rules(base + ("stem2",), f"{p}stem.2.", kernel=1)
    for i in range(len(cfg.embed_dims)):
        sp = f"{p}stages.{i}."
        if i > 0:
            for jname, tname in (("large", "lkb_origin"), ("small", "small_conv")):
                rules += _split_conv_bn_rules(
                    base + (f"downsample{i}", "proj"), jname, f"{jname}_bn",
                    f"{sp}downsample.proj.0.{tname}.conv", f"{sp}downsample.proj.0.{tname}.bn")
            rules += mobileone_rules(base + (f"downsample{i}", "mix"), f"{sp}downsample.proj.1.",
                                     kernel=1)
        if cfg.pos_embs[i]:
            rules += [
                Rule(("params", *base, f"pos_emb{i}", "pe", "kernel"), f"{sp}pos_emb.pe.weight",
                     "conv"),
                Rule(("params", *base, f"pos_emb{i}", "pe", "bias"), f"{sp}pos_emb.pe.bias"),
            ]
        for j in range(cfg.depths[i]):
            bp = base + (f"stage{i}_block{j}",)
            tb = f"{sp}blocks.{j}."
            repmixer = cfg.token_mixers[i] == "repmixer"
            if repmixer:
                rules += mobileone_rules(bp + ("token_mixer", "mixer"), f"{tb}token_mixer.mixer.")
                rules += _bn_module_rules(bp + ("token_mixer", "norm", "skip_bn"),
                                          f"{tb}token_mixer.norm.rbr_skip")
                rules += [Rule(("params",) + bp + ("token_mixer", "layer_scale"),
                               f"{tb}token_mixer.layer_scale", "scale2d")]
            else:
                rules += _bn_module_rules(bp + ("attn", "norm"), f"{tb}norm")
                rules += [
                    Rule(("params",) + bp + ("attn", "qkv", "kernel"),
                         f"{tb}token_mixer.qkv.weight", "linear"),
                    Rule(("params",) + bp + ("attn", "proj", "kernel"),
                         f"{tb}token_mixer.proj.weight", "linear"),
                    Rule(("params",) + bp + ("attn", "proj", "bias"), f"{tb}token_mixer.proj.bias"),
                    Rule(("params",) + bp + ("layer_scale_1",), f"{tb}layer_scale_1", "scale2d"),
                ]
            rules += _split_conv_bn_rules(bp + ("mlp",), "conv", "conv_bn",
                                          f"{tb}mlp.conv.conv", f"{tb}mlp.conv.bn")
            for fc in ("fc1", "fc2"):
                tfc = f"{tb}mlp.{fc}.original_conv." if lora else f"{tb}mlp.{fc}."
                rules += [
                    Rule(("params",) + bp + ("mlp", fc, "kernel"), f"{tfc}weight", "conv"),
                    Rule(("params",) + bp + ("mlp", fc, "bias"), f"{tfc}bias"),
                ]
                if lora:
                    rules += [
                        Rule(("params",) + bp + ("mlp", f"{fc}_lora", ab, "kernel"),
                             f"{tb}mlp.{fc}.{ab}.weight", "conv")
                        for ab in ("lora_A", "lora_B")
                    ]
            rules += [Rule(("params",) + bp + ("layer_scale_2",),
                           f"{tb}layer_scale" if repmixer else f"{tb}layer_scale_2", "scale2d")]
    rules += mobileone_rules(base + ("final_conv",), f"{p}final_conv.", identity=False,
                             use_se=cfg.final_se)
    return rules


def fastvit_pose_rules(cfg, num_up_stages: int = 2) -> list[Rule]:
    """Full variable-tree mapping for ``FastVitPoseModule``: the heads at
    ``backbone.head.*`` (the reference replaces timm's head attribute)."""
    return fastvit_backbone_rules(cfg) + spatial_heads_rules(
        num_up_stages, torch_prefix="backbone.head.")


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def state_dict_from_jax(variables: Mapping, model) -> dict[str, torch.Tensor]:
    """Render the JAX variables of a pose model into the port's
    ``state_dict`` for ``model`` (a ``DinoPoseModule`` or a
    ``FastVitPoseModule``). Every key of the model is produced, BatchNorm
    ``num_batches_tracked`` as 0."""
    if hasattr(model, "vit"):
        num_up = len(model.pose_heads.heatmap_head.upsampling)
        rules = dinov2_pose_rules(model.vit.num_layers, model.vit.lora_layers, num_up)
    else:
        rules = fastvit_pose_rules(model.cfg, len(model.backbone.head.heatmap_head.upsampling))
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


def loss_weight_from_jax(loss_weight, device=None):
    """The JAX package's ``LossWeightState`` (an object or a mapping with
    its six fields, numpy-convertible) as the port's, on ``device``."""
    from dino_pose_tpu_torch.train.weighting import LossWeightState

    def get(name):
        v = loss_weight[name] if isinstance(loss_weight, Mapping) else getattr(loss_weight, name)
        return torch.as_tensor(np.array(v), device=device)

    return LossWeightState(**{f.name: get(f.name) for f in dataclasses.fields(LossWeightState)})
