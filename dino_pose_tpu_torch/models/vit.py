"""DINOv2 Vision Transformer backbone (counterpart of dino_pose_tpu/models/vit.py).

Modules carry the reference torch key names (HF ``Dinov2Model`` under
``backbone.``; the LoRA layer's weights under
``attention.original_attention`` beside ``attention.lora_output``), so a
reference-schema state dict loads with ``strict=True``.

The blocks run through the fused wrappers of ``ops/block.py``: a non-LoRA
layer through ``fused_block``, the LoRA layer through ``fused_attn_part`` ->
adapter -> ``x + o*ls1`` -> ``fused_mlp_part``. Their packed parameters
(q|k|v concatenated, matrices transposed to (in, out) and cast to the
compute dtype) are built once per dtype and device and dropped when a state
dict is loaded. This slice is inference only: the forward refuses training
mode.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from dino_pose_tpu_torch.nn import layers as L
from dino_pose_tpu_torch.ops.block import (
    AttnParams,
    BlockParams,
    MlpParams,
    attn_part_math,
    block_math,
    fused_attn_part,
    fused_block,
    fused_mlp_part,
    mlp_part_math,
)


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
    A is (in, r), B is (r, in) (reference ``LoRALayer`` layout)."""

    def __init__(self, dim: int, rank: int, alpha: float, dropout: float):
        super().__init__()
        self.lora_A = nn.Parameter(torch.empty(dim, rank))
        self.lora_B = nn.Parameter(torch.empty(rank, dim))
        self.scaling = alpha / rank
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.lora_A.to(x.dtype)
        h = h @ self.lora_B.to(x.dtype)
        h = nn.functional.dropout(h, self.dropout, self.training)
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
        self.register_load_state_dict_post_hook(_drop_packed)

    def _base_attention(self) -> _Attention:
        return self.attention.original_attention if self.use_lora else self.attention

    def packed(self, dtype: torch.dtype) -> BlockParams:
        """Kernel-layout parameters, built once per (dtype, device): matrices
        (in, out) in ``dtype``, vectors f32. Built as normal tensors even
        when first asked for under ``inference_mode``, so that later calls
        outside it can still use them."""
        key = (dtype, self.norm1.weight.device)
        if self._packed is None or self._packed[0] != key:
            att = self._base_attention()
            sa = att.attention

            def mat(*ws):
                return torch.cat([w.detach() for w in ws], 0).t().contiguous().to(dtype)

            def vec(*vs):
                return torch.cat([v.detach().float() for v in vs]).contiguous()

            with torch.inference_mode(False), torch.no_grad():
                params = BlockParams(
                    g1=vec(self.norm1.weight), b1=vec(self.norm1.bias),
                    wqkv=mat(sa.query.weight, sa.key.weight, sa.value.weight),
                    bqkv=vec(sa.query.bias, sa.key.bias, sa.value.bias),
                    wo=mat(att.output.dense.weight), bo=vec(att.output.dense.bias),
                    ls1=vec(self.layer_scale1.lambda1),
                    g2=vec(self.norm2.weight), b2=vec(self.norm2.bias),
                    w1=mat(self.mlp.fc1.weight), bf1=vec(self.mlp.fc1.bias),
                    w2=mat(self.mlp.fc2.weight), bf2=vec(self.mlp.fc2.bias),
                    ls2=vec(self.layer_scale2.lambda1),
                )
            self._packed = (key, params)
        return self._packed[1]

    def forward(self, x: torch.Tensor, *, kernels: bool = True) -> torch.Tensor:
        cfg = self.cfg
        h, eps = cfg.num_heads, cfg.layer_norm_eps
        p = self.packed(x.dtype)
        if not self.use_lora:
            if kernels:
                return fused_block(x, p, h, eps)
            return block_math(x, p, num_heads=h, eps=eps)
        ap = AttnParams(p.g1, p.b1, p.wqkv, p.bqkv, p.wo, p.bo)
        mp = MlpParams(p.g2, p.b2, p.w1, p.bf1, p.w2, p.bf2, p.ls2)
        if kernels:
            o = fused_attn_part(x, ap, h, eps)
        else:
            o = attn_part_math(x, ap, num_heads=h, eps=eps)
        o = o + self.attention.lora_output(o)
        x2 = x + o * p.ls1.to(o.dtype)
        if kernels:
            return fused_mlp_part(x2, mp, eps)
        return mlp_part_math(x2, mp, eps=eps)


def _drop_packed(module: Block, incompatible_keys) -> None:
    module._packed = None


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

    def forward(self, pixels: torch.Tensor, *, kernels: bool = True):
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
            x = blk(x, kernels=kernels)
        x = L.layer_norm(x, self.layernorm.weight, self.layernorm.bias, cfg.layer_norm_eps)
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
