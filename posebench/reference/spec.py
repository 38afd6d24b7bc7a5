"""The parameter set of a DINOv2 pose model, by name, shape and how the
benchmark seeds it.

The names are those of the reference PyTorch pose model (Hugging Face's
``Dinov2Model`` under ``backbone.``, the LoRA layer's weights under
``attention.original_attention`` beside ``attention.lora_output``, the
spatial-aware heads under ``pose_heads.``), so the same tensors load into
the program under test with ``load_state_dict(strict=True)`` and feed this
package's plain model.

Seeding is the benchmark's own, not the program's initialiser: weights and
biases U(+-1/sqrt(fan_in)), norms and LayerScale drawn away from identity,
LoRA B non-zero, BatchNorm running statistics drawn, so that no path of the
model is an identity and every trainable leaf has a gradient at step 1.
"""

from __future__ import annotations

import dataclasses
import math

# Init kinds: ("u", bound) U(-bound, bound); ("r", lo, hi) U(lo, hi);
# ("n", std) N(0, std^2); ("c", value) a constant.


@dataclasses.dataclass(frozen=True)
class ModelShape:
    """The widths the plain model needs, read from a configuration file."""

    hidden: int
    layers: int
    heads: int
    mlp_ratio: int
    patch: int
    pos_grid: int
    eps: float
    keypoints: int
    heatmap: int
    lora_rank: int
    lora_alpha: float
    lora_dropout: float
    z_dropout: float
    z_hidden: tuple[int, ...]
    head_grid_at_init: int  # the patch grid the heads' upsampling stages are built for

    @classmethod
    def from_config(cls, config: dict) -> "ModelShape":
        hf, pose, lora = config["hf_config"], config["pose"], config["lora"]
        return cls(
            hidden=hf["hidden_size"], layers=hf["num_hidden_layers"],
            heads=hf["num_attention_heads"], mlp_ratio=hf["mlp_ratio"],
            patch=hf["patch_size"], pos_grid=hf["image_size"] // hf["patch_size"],
            eps=hf["layer_norm_eps"], keypoints=pose["num_keypoints"],
            heatmap=pose["heatmap_size"], lora_rank=lora["rank"],
            lora_alpha=float(lora["alpha"]), lora_dropout=float(lora["dropout"]),
            z_dropout=float(pose["z_dropout"]), z_hidden=tuple(pose["z_hidden"]),
            head_grid_at_init=pose["heads_built_for_input"] // hf["patch_size"],
        )


def upsampling_plan(grid: int, heatmap: int) -> list[tuple[int, int]]:
    """(out channels, stride) of each upsampling stage from a grid x grid map:
    the reference heads' loop, whose tracker doubles each stage."""
    plan, current, in_ch = [], grid, 256
    while current < heatmap:
        out_ch = max(128, in_ch // 2)
        plan.append((out_ch, heatmap // current))
        current *= 2
        in_ch = out_ch
    return plan


def _linear(name: str, fan_in: int, out: int) -> list:
    b = 1.0 / math.sqrt(fan_in)
    return [(f"{name}.weight", (out, fan_in), ("u", b)), (f"{name}.bias", (out,), ("u", b))]


def _conv(name: str, cin: int, cout: int, k: int, groups: int = 1) -> list:
    fan_in = cin // groups * k * k
    b = 1.0 / math.sqrt(fan_in)
    return [(f"{name}.weight", (cout, cin // groups, k, k), ("u", b)),
            (f"{name}.bias", (cout,), ("u", b))]


def _deconv(name: str, cin: int, cout: int, k: int) -> list:
    # torch ConvTranspose2d weight (in, out, k, k); fan_in as torch counts it.
    b = 1.0 / math.sqrt(cout * k * k)
    return [(f"{name}.weight", (cin, cout, k, k), ("u", b)), (f"{name}.bias", (cout,), ("u", b))]


def _norm(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), ("r", 0.8, 1.2)), (f"{name}.bias", (c,), ("u", 0.1))]


def _bn(name: str, c: int) -> list:
    return _norm(name, c) + [
        (f"{name}.running_mean", (c,), ("n", 0.1)),
        (f"{name}.running_var", (c,), ("r", 0.5, 1.5)),
        (f"{name}.num_batches_tracked", (), ("c", 0)),
    ]


def lora_layers(shape: ModelShape, finetune: dict) -> tuple[int, ...]:
    """The layers that carry an adapter: the last one under LoRA, as the
    program's registry builds it."""
    return (shape.layers - 1,) if finetune.get("use_lora") else ()


def parameters(shape: ModelShape, finetune: dict) -> list[tuple[str, tuple, tuple]]:
    """Every tensor of the model's state dict: (name, shape, init)."""
    d, hid = shape.hidden, shape.hidden * shape.mlp_ratio
    out = [
        ("backbone.embeddings.cls_token", (1, 1, d), ("n", 1.0)),
        ("backbone.embeddings.mask_token", (1, d), ("c", 0.0)),
        ("backbone.embeddings.position_embeddings", (1, shape.pos_grid ** 2 + 1, d), ("n", 1.0)),
        *_conv("backbone.embeddings.patch_embeddings.projection", 3, d, shape.patch),
    ]
    adapters = lora_layers(shape, finetune)
    for i in range(shape.layers):
        pre = f"backbone.encoder.layer.{i}"
        att = f"{pre}.attention.original_attention" if i in adapters else f"{pre}.attention"
        out += _norm(f"{pre}.norm1", d)
        for proj in ("query", "key", "value"):
            out += _linear(f"{att}.attention.{proj}", d, d)
        out += _linear(f"{att}.output.dense", d, d)
        if i in adapters:
            r = shape.lora_rank
            out += [(f"{pre}.attention.lora_output.lora_A", (d, r), ("u", 1.0 / math.sqrt(r))),
                    (f"{pre}.attention.lora_output.lora_B", (r, d), ("n", 0.02))]
        out += [(f"{pre}.layer_scale1.lambda1", (d,), ("r", 0.1, 1.0))]
        out += _norm(f"{pre}.norm2", d)
        out += _linear(f"{pre}.mlp.fc1", d, hid) + _linear(f"{pre}.mlp.fc2", hid, d)
        out += [(f"{pre}.layer_scale2.lambda1", (d,), ("r", 0.1, 1.0))]
    out += _norm("backbone.layernorm", d)

    h = "pose_heads.heatmap_head"
    fr = f"{h}.feature_refine"
    hg = f"{fr}.3"
    out += _conv(f"{fr}.0", d, 512, 3) + _bn(f"{fr}.1", 512)
    out += _conv(f"{hg}.depthwise_conv.0", 512, 512, 3, groups=512) + _bn(f"{hg}.depthwise_conv.1", 512)
    out += _conv(f"{hg}.depthwise_conv.3", 512, 512, 1) + _bn(f"{hg}.depthwise_conv.4", 512)
    out += _conv(f"{hg}.down1.0", 512, 256, 3) + _bn(f"{hg}.down1.1", 256)
    out += _conv(f"{hg}.down2.0", 256, 128, 3) + _bn(f"{hg}.down2.1", 128)
    out += _conv(f"{hg}.bottleneck.0", 128, 128, 3) + _bn(f"{hg}.bottleneck.1", 128)
    out += _conv(f"{hg}.bottleneck.3", 128, 128, 3) + _bn(f"{hg}.bottleneck.4", 128)
    out += _deconv(f"{hg}.up1.0", 128, 256, 2) + _bn(f"{hg}.up1.1", 256)
    out += _deconv(f"{hg}.up2.0", 256, 512, 2) + _bn(f"{hg}.up2.1", 512)
    out += _conv(f"{hg}.skip.0", 512, 512, 1) + _bn(f"{hg}.skip.1", 512)
    out += _conv(f"{fr}.4", 512, 256, 3) + _bn(f"{fr}.5", 256)
    in_ch = 256
    for j, (out_ch, _) in enumerate(upsampling_plan(shape.head_grid_at_init, shape.heatmap)):
        out += _deconv(f"{h}.upsampling.{j}.0", in_ch, out_ch, 4) + _bn(f"{h}.upsampling.{j}.1", out_ch)
        in_ch = out_ch
    out += _conv(f"{h}.prediction.0", in_ch, 64, 3) + _bn(f"{h}.prediction.1", 64)
    out += _conv(f"{h}.prediction.3", 64, shape.keypoints, 1)
    prev = d
    for j, width in enumerate(shape.z_hidden):
        out += _linear(f"pose_heads.z_head.mlp.{3 * j}", prev, width)
        prev = width
    out += _linear(f"pose_heads.z_head.mlp.{3 * len(shape.z_hidden)}", prev, shape.keypoints)
    return out


def trainable(shape: ModelShape, finetune: dict) -> list[str]:
    """The names that train: the heads, and the adapters under LoRA or every
    parameter of the last ``unfreeze_last_n_layers`` blocks otherwise. The
    final LayerNorm stays frozen."""
    names = [n for n, s, _ in parameters(shape, finetune) if s != ()]
    names = [n for n in names if not n.endswith(("running_mean", "running_var"))]
    heads = [n for n in names if n.startswith("pose_heads.")]
    if finetune.get("use_lora"):
        return [n for n in names if ".lora_output." in n] + heads
    first = shape.layers - int(finetune.get("unfreeze_last_n_layers", 0))
    blocks = [n for n in names if n.startswith("backbone.encoder.layer.")
              and int(n.split(".")[3]) >= first]
    return blocks + heads
