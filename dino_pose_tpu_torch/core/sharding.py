"""Tensor-parallel rules for the ('data', 'model') mesh (counterpart of
dino_pose_tpu/core/sharding.py), over the reference torch key names.

A rule is (regex searched in the state-dict key, the dim split over
``'model'``); the first match wins. JAX writes its rules over its variable
paths and layouts; these are the same rules on the port's keys and torch's
layouts: ``nn.Linear.weight`` is (out, in), so JAX's column split of an
(in, out) kernel falls on dim 0 here and its row split on dim 1; a 1x1 conv
weight is (out, in, 1, 1) against JAX's (1, 1, in, out). Anything that
matches no rule is replicated, and so is a leaf whose split does not divide
its dim or whose mesh has one model shard (JAX's any-mesh fallback).

DINOv2 (Megatron): q/k/v and fc1 split their output features over
``'model'`` (heads and hidden units), the attention out-projection and fc2
their input features, so each half needs one all-reduce. The rules are
anchored to encoder blocks: the heads' own linears stay replicated.
``ops/block.shard_attn``/``shard_mlp`` cut the blocks' shards along
:func:`vit_block_dims`, read from this table.

FastViT: the ConvFFN's 1x1 convs (fc1's output channels, fc2's input
channels) and the attention stages' qkv/proj. The table is ported and held
against JAX's, but no FastViT shard runs across ranks yet (JAX's FastViT
split is a layout for XLA's collectives over the same math); ``fit``
trains FastViT data-parallel.
"""

from __future__ import annotations

import re
from typing import Mapping

_BLOCK = r"encoder\.layer\.\d+\.(?:attention\.(?:original_attention\.)?|mlp\.)"

VIT_TP_RULES: list[tuple[str, int]] = [
    (_BLOCK + r"attention\.(query|key|value)\.weight$", 0),
    (_BLOCK + r"attention\.(query|key|value)\.bias$", 0),
    (_BLOCK + r"output\.dense\.weight$", 1),
    (_BLOCK + r"fc1\.weight$", 0),
    (_BLOCK + r"fc1\.bias$", 0),
    (_BLOCK + r"fc2\.weight$", 1),
]

FASTVIT_TP_RULES: list[tuple[str, int]] = [
    (r"mlp\.fc1\.(original_conv\.)?weight$", 0),
    (r"mlp\.fc1\.(original_conv\.)?bias$", 0),
    (r"mlp\.fc2\.(original_conv\.)?weight$", 1),
    (r"token_mixer\.qkv\.weight$", 0),
    (r"token_mixer\.proj\.weight$", 1),
]

_FAMILY_RULES: dict[str, list[tuple[str, int]]] = {
    "dinov2": VIT_TP_RULES,
    "fastvit": FASTVIT_TP_RULES,
}


def tp_rules_for_family(family: str) -> list[tuple[str, int]]:
    """The tensor-parallel rule table of a model family (empty: replicate)."""
    return _FAMILY_RULES.get(family, [])


def rule_dim(rules: list[tuple[str, int]], key: str) -> int | None:
    """The dim the first rule matching ``key`` splits, or None."""
    for pattern, dim in rules:
        if re.search(pattern, key):
            return dim
    return None


def shard_specs(state_dict: Mapping, mesh, rules: list[tuple[str, int]] | None = None
                ) -> dict[str, int | None]:
    """``{key: dim split over 'model' | None}`` for every tensor of
    ``state_dict`` under ``mesh`` (anything with a ``tp``; default rules
    :data:`VIT_TP_RULES`). A 0-d tensor, a key no rule matches, a split
    that does not divide the dim, or a mesh of one model shard: None."""
    rules = VIT_TP_RULES if rules is None else rules
    tp = mesh.tp
    out: dict[str, int | None] = {}
    for key, t in state_dict.items():
        dim = rule_dim(rules, key) if t.ndim else None
        if dim is None or tp == 1 or dim >= t.ndim or t.shape[dim] % tp:
            out[key] = None
        else:
            out[key] = dim
    return out


def vit_block_dims() -> dict[str, int]:
    """The dims, in torch's layouts, along which a dinov2 block's shards are
    cut, as :data:`VIT_TP_RULES` gives them: ``qkv`` (q/k/v weights),
    ``qkv_bias``, ``out`` (the out-projection weight), ``fc1``, ``fc1_bias``,
    ``fc2``."""
    p = "encoder.layer.0."
    keys = {"qkv": "attention.attention.query.weight", "qkv_bias": "attention.attention.query.bias",
            "out": "attention.output.dense.weight", "fc1": "mlp.fc1.weight",
            "fc1_bias": "mlp.fc1.bias", "fc2": "mlp.fc2.weight"}
    return {role: rule_dim(VIT_TP_RULES, p + k) for role, k in keys.items()}
