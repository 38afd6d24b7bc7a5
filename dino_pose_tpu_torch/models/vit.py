"""DINOv2 Vision Transformer backbone (counterpart of dino_pose_tpu/models/vit.py).

Modules carry the reference torch key names (HF ``Dinov2Model`` under
``backbone.``; the LoRA layer's weights under
``attention.original_attention`` beside ``attention.lora_output``), so a
reference-schema state dict loads with ``strict=True``.

The blocks run through the fused wrappers of ``ops/block.py`` (with
``kernels=False`` the plain versions of each):

- a block whose weights train (unfreeze-last-N), with grad mode on, by the
  route ``block_route(..., training=True)`` gives: on ``"block"`` and
  ``"math"`` (dinov2-small at 224² and 504², every width at S = 1297)
  through ``block_train`` (``fused_block_train`` with the ``fused_mlp_bwd``
  and ``fused_attn_bwd`` backward), as JAX's ``dispatch_block_train``; on
  ``"stream"`` (dinov2-base and -large at 224²) through
  ``attn_part_stream_train`` (``fused_attn_part_stream``, backward
  ``fused_attn_bwd_stream``) -> ``x + o*ls1`` in the activation dtype under
  plain autograd (JAX's XLA stitch) -> ``mlp_part_stream_train``
  (``fused_mlp_part_stream_train``, backward ``fused_mlp_bwd_stream``), as
  JAX's weight-streamed halves with their streamed backward. Its
  parameters are packed anew on every forward, with autograd (q|k|v
  concatenated, matrices transposed to (in, out)); the cast to the compute
  dtype happens inside, and the weight gradients reach the f32 parameters
  unrounded;
- any other non-LoRA block (frozen, or under ``no_grad``/``inference_mode``)
  on detached packed copies, cached per dtype, device and the parameters'
  versions (an optimizer step or a loaded state dict packs them anew, so no
  forward sees stale weights), by the rounding route ``ops/block.block_route``
  gives, JAX's single-device TPU dispatch (``vit.py:276-342``): on
  ``"block"`` and ``"math"`` (dinov2-small and -base at 224², every size at
  S = 1297) through ``fused_block``; on ``"stream"`` (dinov2-large at 224²)
  through ``fused_attn_part_stream`` -> ``x + o*ls1`` in the activation
  dtype (JAX's XLA stitch) -> ``fused_mlp_part_stream`` (through
  ``mlp_part_frozen``, which builds no graph where nothing requires grad);
- the LoRA layer through ``fused_attn_part`` -> adapter -> ``x + o*ls1`` ->
  ``mlp_part_frozen`` (``fused_mlp_part`` with the ``fused_mlp_dx``
  backward), on ``"stream"`` through ``fused_attn_part_stream`` and
  ``mlp_part_frozen(route="stream")`` (``fused_mlp_part_stream``, the same
  ``fused_mlp_dx`` backward): only the adapter trains there. A LoRA layer
  whose base weights require grad is refused while grad mode is on, since
  that backward gives them no gradient;
- under a mesh whose ``'model'`` axis holds tp > 1 shards
  (``core/mesh.create_mesh``, read at call time from
  ``ops/dispatch.target_mesh``), a frozen block or the LoRA layer on the
  route ``"tp"`` (``block_route(..., tp=)``, JAX's ``_tp_shard_mesh``)
  through the Megatron halves, as JAX's ``vit.py:183`` and ``:384`` compose
  them: ``attn_part_tp`` (each shard's ``fused_attn_part_partial``, the
  mesh's all-reduce, ``+ bo``) -> the LoRA adapter on o -> ``x + o*ls1`` ->
  ``mlp_part_tp`` (each shard's ``mlp_part_partial_frozen``:
  ``fused_mlp_part_partial``, backward ``fused_mlp_partial_dx``). The
  shards are cut from the packed copies and cached beside them, per ``tp``.
  A frozen block goes through the frozen-weight shards too: its detached
  copies take no gradient either way. A block that trains whole takes
  ``"math"`` under a mesh, as in JAX (``block_train``, whose rounding is
  ``block_math``'s).

The final LayerNorm is ``nn/layers.layer_norm``, or with
``DINO_POSE_TPU_LN=pallas`` (JAX's switch, read at call time) the kernel
``ops/layernorm.fused_layernorm``.

Each chain takes any sequence length, its attention step streaming through
the flash kernels once the head's K and V no longer fit shared memory
(S > ~320; at 504², S = 1297, in every layer). Two departures from the JAX
route: at 504² the JAX package runs ``block_math`` around its flash kernel
where the port runs its chains (same rounding points); and where JAX runs a
trainable block's streamed forward but finds no streamed backward plan for
a half (dinov2-large at S ~ 273-625, dinov2-base at S ~ 377-785, between
224² and 504²), it takes the exact unfused vjp of that half, where the port
keeps its streamed backward chain.
"""

from __future__ import annotations

import dataclasses
import os

import torch
from torch import nn

from dino_pose_tpu_torch.nn import layers as L
from dino_pose_tpu_torch.ops.block import (
    AttnParams,
    BlockParams,
    MlpParams,
    attn_params,
    attn_part_math,
    attn_part_stream_math,
    attn_part_stream_train,
    attn_part_tp,
    block_math,
    block_route,
    block_train,
    cast_params,
    fused_attn_part,
    fused_attn_part_stream,
    fused_block,
    mlp_params,
    mlp_part_frozen,
    mlp_part_stream_train,
    mlp_part_tp,
    shard_attn,
    shard_mlp,
)
from dino_pose_tpu_torch.ops.dispatch import target_mesh
from dino_pose_tpu_torch.ops.layernorm import fused_layernorm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    patch_size: int = 14
    # Size of the pre-trained position grid (37 for DINOv2's 518x518).
    pos_grid: int = 37
    layer_norm_eps: float = 1e-6
    layerscale_init: float = 1.0
    num_unfrozen_layers: int = 0
    # LoRA: indices of encoder layers that get a residual output adapter.
    lora_layers: tuple[int, ...] = ()
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_dropout: float = 0.1
    # 'bicubic' matches Dinov2; 'nearest' is the reference's CoreML patch.
    pos_interpolation: str = "bicubic"

    @property
    def num_positions(self) -> int:
        return self.pos_grid * self.pos_grid + 1


# HF Dinov2Config values for the three registry backbones.
VIT_PRESETS: dict[str, ViTConfig] = {
    "facebook/dinov2-small": ViTConfig(hidden_size=384, num_layers=12, num_heads=6),
    "facebook/dinov2-base": ViTConfig(hidden_size=768, num_layers=12, num_heads=12),
    "facebook/dinov2-large": ViTConfig(hidden_size=1024, num_layers=24, num_heads=16),
    # Tiny preset for tests.
    "test/vit-tiny": ViTConfig(hidden_size=64, num_layers=2, num_heads=2, pos_grid=37),
}


class LoRAAdapter(nn.Module):
    """Residual low-rank adapter: ``dropout(x @ A @ B) * (alpha / rank)``;
    A is (in, r), B is (r, in) (reference ``LoRALayer`` layout). In train
    mode the dropout mask comes from ``generator``."""

    def __init__(self, dim: int, rank: int, alpha: float, dropout: float):
        super().__init__()
        self.lora_A = nn.Parameter(torch.empty(dim, rank))
        self.lora_B = nn.Parameter(torch.empty(rank, dim))
        self.scaling = alpha / rank
        self.dropout = dropout

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h = x @ self.lora_A.to(x.dtype)
        h = h @ self.lora_B.to(x.dtype)
        if self.training:
            h = L.dropout(h, self.dropout, generator)
        return h * self.scaling


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)


class _SelfOutput(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.dense = nn.Linear(d, d)


class _Attention(nn.Module):
    """HF ``Dinov2Attention`` parameter tree (attention.* / output.dense.*)."""

    def __init__(self, d: int):
        super().__init__()
        self.attention = _SelfAttention(d)
        self.output = _SelfOutput(d)


class _LoRAAttention(nn.Module):
    """Reference ``LoRAAttention`` tree: original_attention + lora_output."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.original_attention = _Attention(cfg.hidden_size)
        self.lora_output = LoRAAdapter(
            cfg.hidden_size, cfg.lora_rank, cfg.lora_alpha, cfg.lora_dropout
        )


class _LayerScale(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.empty(d))


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class Block(nn.Module):
    """Pre-norm ViT block (HF ``Dinov2Layer`` tree)."""

    def __init__(self, cfg: ViTConfig, use_lora: bool = False):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.use_lora = use_lora
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attention = _LoRAAttention(cfg) if use_lora else _Attention(d)
        self.layer_scale1 = _LayerScale(d)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = _Mlp(d, d * cfg.mlp_ratio)
        self.layer_scale2 = _LayerScale(d)
        self._packed: tuple[tuple, BlockParams] | None = None
        self._shards: tuple[tuple, list] | None = None
        self.register_load_state_dict_post_hook(_drop_packed)

    def _base_attention(self) -> _Attention:
        return self.attention.original_attention if self.use_lora else self.attention

    def _base_weights(self) -> list[torch.Tensor]:
        """The block's own parameters, the LoRA adapter's excluded."""
        att = self._base_attention()
        mods = (self.norm1, att, self.layer_scale1, self.norm2, self.mlp, self.layer_scale2)
        return [p for m in mods for p in m.parameters()]

    def layout(self) -> BlockParams:
        """The parameters in the kernels' layout, built from the module's
        tensors with autograd: q|k|v concatenated, matrices transposed to
        (in, out), dtypes as stored."""
        att = self._base_attention()
        sa = att.attention
        return BlockParams(
            g1=self.norm1.weight, b1=self.norm1.bias,
            wqkv=torch.cat([sa.query.weight, sa.key.weight, sa.value.weight]).t(),
            bqkv=torch.cat([sa.query.bias, sa.key.bias, sa.value.bias]),
            wo=att.output.dense.weight.t(), bo=att.output.dense.bias,
            ls1=self.layer_scale1.lambda1,
            g2=self.norm2.weight, b2=self.norm2.bias,
            w1=self.mlp.fc1.weight.t(), bf1=self.mlp.fc1.bias,
            w2=self.mlp.fc2.weight.t(), bf2=self.mlp.fc2.bias,
            ls2=self.layer_scale2.lambda1,
        )

    def packed(self, dtype: torch.dtype) -> BlockParams:
        """Detached kernel-layout copies (matrices in ``dtype``, vectors f32)
        for the forward-only wrappers, cached per dtype, device and the
        versions of the block's parameters: an in-place update (an optimizer
        step, a loaded state dict) packs them anew. Built as normal tensors
        even when first asked for under ``inference_mode``, so that later
        calls outside it can still use them."""
        weights = self._base_weights()
        key = (dtype, weights[0].device, tuple(w._version for w in weights))
        if self._packed is None or self._packed[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                params = cast_params(BlockParams(*(t.detach() for t in self.layout())), dtype)
            self._packed = (key, params)
        return self._packed[1]

    def shards(self, dtype: torch.dtype, tp: int) -> list[tuple]:
        """Each model shard's (``AttnPartialParams``, ``MlpPartialParams``),
        rank by rank, cut from ``packed(dtype)`` as JAX's ``attn_part_tp`` and
        ``mlp_part_tp`` cut them, made contiguous for the kernels (row slices
        stay views of the packed copies); cached beside them, keyed also on
        ``tp``."""
        p = self.packed(dtype)
        key = (self._packed[0], tp)
        if self._shards is None or self._shards[0] != key:
            ap, mp = attn_params(p), mlp_params(p)
            with torch.inference_mode(False), torch.no_grad():
                cut = [(shard_attn(ap, tp, r), shard_mlp(mp, tp, r)) for r in range(tp)]
                cut = [tuple(type(h)(*(t.contiguous() for t in h)) for h in pair) for pair in cut]
            self._shards = (key, cut)
        return self._shards[1]

    def forward(self, x: torch.Tensor, *, kernels: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.cfg
        h, eps = cfg.num_heads, cfg.layer_norm_eps
        mesh = target_mesh()
        tp = 1 if mesh is None else mesh.tp
        if torch.is_grad_enabled() and any(w.requires_grad for w in self._base_weights()):
            if self.use_lora:
                raise ValueError(
                    "a LoRA layer's base weight requires grad, but the layer's backward "
                    "gives its base weights no gradient (only the adapter trains); "
                    "freeze them or run under torch.no_grad()"
                )
            route = block_route(cfg.hidden_size, x.shape[1], h, self.mlp.fc1.out_features,
                                x.element_size(), lora=False, training=True, tp=tp)
            p = self.layout()
            if route != "stream":
                return block_train(x, p, h, eps, kernels=kernels)
            o = attn_part_stream_train(x, attn_params(p), h, eps, kernels=kernels)
            # JAX's XLA stitch between the halves, in the activation dtype.
            x2 = x + o * p.ls1.to(o.dtype)
            return mlp_part_stream_train(x2, mlp_params(p), eps, kernels=kernels)
        p = self.packed(x.dtype)
        route = block_route(cfg.hidden_size, x.shape[1], h, p.w1.shape[-1], x.element_size(),
                            lora=self.use_lora, training=False, tp=tp)
        if route == "tp":
            return self._tp_forward(x, p, mesh, kernels, generator)
        stream = route == "stream"
        if not (self.use_lora or stream):
            if kernels:
                return fused_block(x, p, h, eps)
            return block_math(x, p, num_heads=h, eps=eps)
        ap = AttnParams(p.g1, p.b1, p.wqkv, p.bqkv, p.wo, p.bo)
        mp = MlpParams(p.g2, p.b2, p.w1, p.bf1, p.w2, p.bf2, p.ls2)
        if kernels:
            o = (fused_attn_part_stream if stream else fused_attn_part)(x, ap, h, eps)
        else:
            o = (attn_part_stream_math if stream else attn_part_math)(x, ap, num_heads=h, eps=eps)
        if self.use_lora:
            o = o + self.attention.lora_output(o, generator)
        # JAX's XLA stitch between the halves, in the activation dtype.
        x2 = x + o * p.ls1.to(o.dtype)
        return mlp_part_frozen(x2, mp, eps, kernels=kernels, route=route)

    def _tp_forward(self, x: torch.Tensor, p: BlockParams, mesh, kernels: bool,
                    generator: torch.Generator | None) -> torch.Tensor:
        """The block over ``mesh``'s model axis: JAX's ``vit.py:183``/``:384``
        with ``attn_part_tp`` and ``mlp_part_tp``."""
        cfg = self.cfg
        shards = self.shards(x.dtype, mesh.tp)
        o = attn_part_tp(x, attn_params(p), cfg.num_heads, cfg.layer_norm_eps, mesh,
                         kernels=kernels, shards=[a for a, _ in shards])
        if self.use_lora:
            o = o + self.attention.lora_output(o, generator)
        # JAX's XLA stitch between the halves, in the activation dtype.
        x2 = x + o * p.ls1.to(o.dtype)
        return mlp_part_tp(x2, mlp_params(p), cfg.layer_norm_eps, mesh, kernels=kernels,
                           shards=[m for _, m in shards])


def _drop_packed(module: Block, incompatible_keys) -> None:
    module._packed = None
    module._shards = None


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        p = cfg.patch_size
        self.projection = nn.Conv2d(3, cfg.hidden_size, kernel_size=p, stride=p)


class _Embeddings(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        # Present for checkpoint compatibility; unused in pose inference.
        self.mask_token = nn.Parameter(torch.empty(1, d))
        self.position_embeddings = nn.Parameter(torch.empty(1, cfg.num_positions, d))
        self.patch_embeddings = _PatchEmbeddings(cfg)


class _Encoder(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            Block(cfg, use_lora=(i in cfg.lora_layers)) for i in range(cfg.num_layers)
        )


class Dinov2Backbone(nn.Module):
    """DINOv2 encoder: NCHW pixels -> (tokens (B, 1+Hp*Wp, D), (Hp, Wp))."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.lora_layers and cfg.num_unfrozen_layers:
            raise ValueError(
                "lora_layers and num_unfrozen_layers are mutually exclusive: "
                "LoRA configs freeze the whole backbone"
            )
        self.config = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor, *, kernels: bool = True,
                generator: torch.Generator | None = None):
        cfg = self.config
        b, _, h, w = pixels.shape
        hp, wp = h // cfg.patch_size, w // cfg.patch_size
        emb = self.embeddings
        x = L.conv2d(pixels, emb.patch_embeddings.projection)   # (B, D, Hp, Wp)
        x = x.flatten(2).transpose(1, 2)                          # (B, Hp*Wp, D)
        cls = emb.cls_token.to(x.dtype).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1)
        x = (x + self.interpolated_pos(hp, wp).to(x.dtype)).contiguous()
        for blk in self.encoder.layer:
            x = blk(x, kernels=kernels, generator=generator)
        norm = self.layernorm
        if kernels and os.environ.get("DINO_POSE_TPU_LN", "").lower() == "pallas":
            x = fused_layernorm(x, norm.weight, norm.bias, cfg.layer_norm_eps)
        else:
            x = L.layer_norm(x, norm.weight, norm.bias, cfg.layer_norm_eps)
        return x, (hp, wp)

    def interpolated_pos(self, hp: int, wp: int) -> torch.Tensor:
        """Position table resized to an (hp, wp) patch grid, in f32."""
        cfg = self.config
        g = cfg.pos_grid
        pos = self.embeddings.position_embeddings
        if hp == g and wp == g:
            return pos
        if cfg.pos_interpolation == "bicubic":
            mh, mw = L.cubic_resize_matrix(g, hp), L.cubic_resize_matrix(g, wp)
        elif cfg.pos_interpolation == "nearest":
            mh, mw = L.nearest_resize_matrix(g, hp), L.nearest_resize_matrix(g, wp)
        else:
            raise ValueError(f"Unknown pos_interpolation: {cfg.pos_interpolation}")
        mh = torch.as_tensor(mh, device=pos.device)
        mw = torch.as_tensor(mw, device=pos.device)
        patch = pos[:, 1:].float().reshape(1, g, g, cfg.hidden_size)
        patch = torch.einsum("oh,bhwd->bowd", mh, patch)
        patch = torch.einsum("pw,bowd->bopd", mw, patch)
        patch = patch.reshape(1, hp * wp, cfg.hidden_size).to(pos.dtype)
        return torch.cat([pos[:, :1], patch], dim=1)
