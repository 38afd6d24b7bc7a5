"""The plain DINOv2 pose model: backbone, LoRA adapter, spatial-aware heads.

Written from the published model (Hugging Face ``Dinov2Model``: pre-norm
blocks, q/k/v with biases, exact-erf GELU MLP of ratio 4, LayerScale on both
residual branches, bicubic position-table resize, final LayerNorm) and the
reference pose heads (3x3 conv + BN + ReLU, a three-path hourglass, 4x4
transposed-conv upsampling stages chosen by the reference's doubling
tracker, a 3x3 + 1x1 prediction, a bilinear resize gated on that tracker; a
z head of three ReLU + dropout Linear layers on the global average pool).

It runs on a dict of tensors named as ``spec.parameters`` names them, in the
precision a :class:`Precision` gives: float32 with TF32 off (the
reference), or every product's operands rounded to fp8 (the control, one
step below the program's bfloat16). It imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from posebench.reference.spec import ModelShape, lora_layers, upsampling_plan


def _fake_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / top
    return (x.float() / scale).to(dtype).float() * scale


class _RoundOperand(torch.autograd.Function):
    """Forward: the operand rounded to e4m3 (per-tensor scale). Backward:
    passes the gradient through (the product's result is not rounded)."""

    @staticmethod
    def forward(ctx, x):
        return _fake_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundCotangent(torch.autograd.Function):
    """Forward: identity. Backward: the incoming gradient, an operand of the
    backward products, rounded to e5m2 (per-tensor scale)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _fake_fp8(g, torch.float8_e5m2, 57344.0)


class Precision:
    """The arithmetic of the model. ``"f32"``: float32, TF32 off. ``"fp8"``
    (the control): fp8 wherever the program computes in bfloat16, each
    tensor rounded with a per-tensor scale: every product's operands to e4m3
    (its sum in f32), and the activations the program keeps in bfloat16
    between its layers (the residual stream, each half's output, the
    outputs of the heads) to e4m3; their cotangents to e5m2 in the
    backward."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def _in(self, *xs):
        if self.name == "f32":
            return xs
        return tuple(_RoundOperand.apply(x) for x in xs)

    def _out(self, y):
        return y if self.name == "f32" else _RoundCotangent.apply(y)

    def act(self, x):
        """An activation kept between layers."""
        return x if self.name == "f32" else _RoundCotangent.apply(_RoundOperand.apply(x))

    def matmul(self, a, b):
        a, b = self._in(a, b)
        return self._out(a @ b)

    def linear(self, x, w, b):
        x, w = self._in(x, w)
        return self._out(x @ w.t()) + b

    def conv(self, x, w, b, stride=1, padding=0, groups=1):
        x, w = self._in(x, w)
        return self._out(F.conv2d(x, w, None, stride, padding, 1, groups)) + b.view(1, -1, 1, 1)

    def deconv(self, x, w, b, stride, padding):
        x, w = self._in(x, w)
        return self._out(F.conv_transpose2d(x, w, None, stride, padding)) + b.view(1, -1, 1, 1)


def f32_mode() -> None:
    """Plain float32 products on the card: TF32 off for matmuls and convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def attention(q, k, v, P: Precision):
    """softmax(q k^T / sqrt(dh)) v over (B, H, S, dh), in batch chunks that
    keep the f32 scores near 2 GB."""
    b, h, s, dh = q.shape
    chunk = max(1, int(2e9 // (h * s * s * 4)))
    outs = []
    for i in range(0, b, chunk):
        sc = P.matmul(q[i:i + chunk], k[i:i + chunk].transpose(-1, -2)) * (dh ** -0.5)
        outs.append(P.matmul(torch.softmax(sc, dim=-1), v[i:i + chunk]))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


class PoseModel:
    """The model over ``W`` (name -> f32 tensor). ``finetune`` as a cell
    states it (``use_lora``, ``unfreeze_last_n_layers``)."""

    def __init__(self, W: dict, shape: ModelShape, finetune: dict, precision: Precision):
        self.W, self.s, self.P = W, shape, precision
        self.adapters = lora_layers(shape, finetune)

    # -- backbone ---------------------------------------------------------
    def embed(self, pixels):
        W, s = self.W, self.s
        pre = "backbone.embeddings."
        x = self.P.conv(pixels, W[pre + "patch_embeddings.projection.weight"],
                        W[pre + "patch_embeddings.projection.bias"], stride=s.patch)
        b, d, hp, wp = x.shape
        x = x.flatten(2).transpose(1, 2)
        cls = W[pre + "cls_token"].expand(b, 1, d)
        pos = W[pre + "position_embeddings"]
        if (hp, wp) != (s.pos_grid, s.pos_grid):
            grid = pos[:, 1:].reshape(1, s.pos_grid, s.pos_grid, d).permute(0, 3, 1, 2)
            grid = F.interpolate(grid, size=(hp, wp), mode="bicubic", align_corners=False)
            pos = torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, hp * wp, d)], dim=1)
        return self.P.act(torch.cat([cls, x], dim=1) + pos), (hp, wp)

    def attn_half(self, x, i):
        W, s, P = self.W, self.s, self.P
        pre = f"backbone.encoder.layer.{i}"
        att = f"{pre}.attention.original_attention" if i in self.adapters else f"{pre}.attention"
        h = layer_norm(x, W[f"{pre}.norm1.weight"], W[f"{pre}.norm1.bias"], s.eps)
        b, n, d = h.shape
        heads = [P.linear(h, W[f"{att}.attention.{p}.weight"], W[f"{att}.attention.{p}.bias"])
                 .reshape(b, n, s.heads, d // s.heads).transpose(1, 2)
                 for p in ("query", "key", "value")]
        ctx = attention(*heads, P).transpose(1, 2).reshape(b, n, d)
        return P.act(P.linear(ctx, W[f"{att}.output.dense.weight"], W[f"{att}.output.dense.bias"]))

    def adapter(self, o, i, mask):
        """The LoRA adapter on the attention output: o + dropout(o A B) *
        alpha / r; ``mask`` is the keep mask (None: no dropout)."""
        W, s, P = self.W, self.s, self.P
        pre = f"backbone.encoder.layer.{i}.attention.lora_output"
        h = P.matmul(P.matmul(o, W[f"{pre}.lora_A"]), W[f"{pre}.lora_B"])
        if mask is not None:
            keep = 1.0 - s.lora_dropout
            h = torch.where(mask < keep, h / keep, torch.zeros_like(h))
        return P.act(o + P.act(h) * (s.lora_alpha / s.lora_rank))

    def mlp_half(self, x2, i):
        W, s, P = self.W, self.s, self.P
        pre = f"backbone.encoder.layer.{i}"
        h = layer_norm(x2, W[f"{pre}.norm2.weight"], W[f"{pre}.norm2.bias"], s.eps)
        h = F.gelu(P.linear(h, W[f"{pre}.mlp.fc1.weight"], W[f"{pre}.mlp.fc1.bias"]))
        m = P.linear(h, W[f"{pre}.mlp.fc2.weight"], W[f"{pre}.mlp.fc2.bias"])
        return P.act(x2 + W[f"{pre}.layer_scale2.lambda1"] * P.act(m))

    def block(self, x, i, mask=None):
        o = self.attn_half(x, i)
        if i in self.adapters:
            o = self.adapter(o, i, mask)
        x2 = self.P.act(x + self.W[f"backbone.encoder.layer.{i}.layer_scale1.lambda1"] * o)
        return self.mlp_half(x2, i)

    def backbone(self, pixels, first_grad: int, mask=None):
        """Tokens after the final LayerNorm. Layers below ``first_grad`` run
        without autograd; those from it on are checkpointed, so that their
        backward holds one layer's activations at a time. Under LoRA the
        adapter's layer runs its attention half without autograd."""
        with torch.no_grad():
            x, grid = self.embed(pixels)
            for i in range(min(first_grad, self.s.layers)):
                x = self.block(x, i, mask)
        for i in range(first_grad, self.s.layers):
            if i in self.adapters:
                with torch.no_grad():
                    o = self.attn_half(x, i)
                o = self.adapter(o, i, mask)
                x2 = self.P.act(x + self.W[f"backbone.encoder.layer.{i}.layer_scale1.lambda1"] * o)
                x = checkpoint(self.mlp_half, x2, i, use_reentrant=False)
            else:
                x = checkpoint(self.block, x, i, None, use_reentrant=False)
        x = layer_norm(x, self.W["backbone.layernorm.weight"], self.W["backbone.layernorm.bias"],
                       self.s.eps)
        return self.P.act(x), grid

    # -- heads ------------------------------------------------------------
    def _cbr(self, name, x, train, stride=1, padding=1, groups=1, relu=True, bn=None):
        W = self.W
        y = self.P.conv(x, W[f"{name}.weight"], W[f"{name}.bias"], stride, padding, groups)
        return self._bn(bn, y, train, relu)

    def _bn(self, name, y, train, relu=True):
        W = self.W
        y = F.batch_norm(y, W[f"{name}.running_mean"], W[f"{name}.running_var"],
                         W[f"{name}.weight"], W[f"{name}.bias"], training=False, eps=1e-5) \
            if not train else _bn_batch(y, W[f"{name}.weight"], W[f"{name}.bias"])
        return self.P.act(torch.relu(y) if relu else y)

    def heatmaps(self, fmap, grid: int, train: bool):
        h = "pose_heads.heatmap_head"
        fr, hg = f"{h}.feature_refine", f"{h}.feature_refine.3"
        W, P = self.W, self.P
        x = self._cbr(f"{fr}.0", fmap, train, bn=f"{fr}.1")
        skip = self._cbr(f"{hg}.skip.0", x, train, padding=0, bn=f"{hg}.skip.1")
        dw = self._cbr(f"{hg}.depthwise_conv.0", x, train, groups=x.shape[1],
                       bn=f"{hg}.depthwise_conv.1")
        dw = self._cbr(f"{hg}.depthwise_conv.3", dw, train, padding=0, bn=f"{hg}.depthwise_conv.4")
        d1 = self._cbr(f"{hg}.down1.0", x, train, stride=2, bn=f"{hg}.down1.1")
        d2 = self._cbr(f"{hg}.down2.0", d1, train, stride=2, bn=f"{hg}.down2.1")
        bt = self._cbr(f"{hg}.bottleneck.0", d2, train, bn=f"{hg}.bottleneck.1")
        bt = self._cbr(f"{hg}.bottleneck.3", bt, train, relu=False, bn=f"{hg}.bottleneck.4")
        bt = self.P.act(torch.relu(bt + d2))
        u = self._bn(f"{hg}.up1.1", P.deconv(bt, W[f"{hg}.up1.0.weight"], W[f"{hg}.up1.0.bias"], 2, 0),
                     train)
        u = self._bn(f"{hg}.up2.1", P.deconv(u, W[f"{hg}.up2.0.weight"], W[f"{hg}.up2.0.bias"], 2, 0),
                     train)
        x = self.P.act(u + skip + dw)
        x = self._cbr(f"{fr}.4", x, train, bn=f"{fr}.5")
        tracker = grid
        for j, (_, stride) in enumerate(upsampling_plan(grid, self.s.heatmap)):
            up = f"{h}.upsampling.{j}"
            x = self._bn(f"{up}.1", P.deconv(x, W[f"{up}.0.weight"], W[f"{up}.0.bias"], stride, 1),
                         train)
            tracker *= 2
        x = self._cbr(f"{h}.prediction.0", x, train, bn=f"{h}.prediction.1")
        x = P.conv(x, W[f"{h}.prediction.3.weight"], W[f"{h}.prediction.3.bias"])
        if tracker != self.s.heatmap:
            x = F.interpolate(x, size=(self.s.heatmap, self.s.heatmap), mode="bilinear",
                              align_corners=False)
        return self.P.act(x)

    def z(self, fmap, masks=None):
        x = fmap.mean(dim=(2, 3))
        keep = 1.0 - self.s.z_dropout
        n = len(self.s.z_hidden)
        for j in range(n + 1):
            name = f"pose_heads.z_head.mlp.{3 * j}"
            x = self.P.linear(x, self.W[f"{name}.weight"], self.W[f"{name}.bias"])
            x = self.P.act(x)
            if j < n:
                x = torch.relu(x)
                if masks is not None:
                    x = torch.where(masks[j] < keep, x / keep, torch.zeros_like(x))
        return x

    def forward(self, pixels, *, train: bool = False, first_grad: int | None = None,
                masks: dict | None = None):
        """(heatmaps (B, K, hm, hm), z (B, K)). ``masks``: the dropout keep
        draws, ``{"lora": (B, S, D), "z": [(B, w) ...]}``; None in eval."""
        masks = masks or {}
        first = self.s.layers if first_grad is None else first_grad
        tokens, (hp, wp) = self.backbone(pixels, first, masks.get("lora"))
        b, _, d = tokens.shape
        fmap = tokens[:, 1:].transpose(1, 2).reshape(b, d, hp, wp)
        return self.heatmaps(fmap, hp, train), self.z(fmap, masks.get("z"))


def _bn_batch(y, w, b):
    """Train-mode BatchNorm: batch mean and biased variance over (B, H, W)."""
    mean = y.mean(dim=(0, 2, 3), keepdim=True)
    var = (y - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    return (y - mean) * torch.rsqrt(var + 1e-5) * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


def dropout_draws(generator: torch.Generator, device, b: int, s: int, shape: ModelShape,
                  lora: bool) -> dict:
    """The keep draws of one train step from ``generator``, in the order the
    forward meets the dropouts: the adapter's (B, S, D), then the z head's
    after each hidden layer. U(0, 1) each; an element is kept below 1 - rate."""
    draws = {}
    if lora:
        draws["lora"] = torch.rand((b, s, shape.hidden), generator=generator, device=device)
    draws["z"] = [torch.rand((b, w), generator=generator, device=device) for w in shape.z_hidden]
    return draws


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout stream of train step ``step`` (from 0) of a run seeded
    ``seed``: a device generator seeded (seed * 1000003 + step) mod 2^63."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + int(step)) % 2**63)
