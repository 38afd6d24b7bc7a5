"""FastViT backbone, eval forward (counterpart of dino_pose_tpu/models/fastvit.py).

Apple's FastViT as timm builds it: a MobileOne stem, four stages of RepMixer
blocks (in the SA/MA variants, self-attention in the last stage, behind a
RepCPE positional conv) with ConvFFN MLPs, reparameterisable patch
embeddings between stages, and a final SE conv to 2 * dims[-1] channels.
Module attribute names follow timm's state-dict keys (``stem.0.rbr_conv.0.conv``,
``stages.1.downsample.proj.0.lkb_origin``, ``stages.3.blocks.0.token_mixer.qkv``,
``final_conv.se.reduce``, LoRA under ``mlp.fc1.{original_conv,lora_A,lora_B}``),
so reference-schema state dicts load with ``strict=True``.

Eval only, as the JAX package runs eval: every multi-branch block is one
folded conv (``fastvit_fold``), RepMixer is one 3x3 depthwise conv with
K = ls*(Km - Kn) + I, SpatialAttention folds its BatchNorm into qkv, and
every ConvFFN runs its depthwise 7x7 conv then ``ops/convffn.fused_convffn``
on the BatchNorm affine. **The port departs from the JAX route here:** the
JAX package takes its ConvFFN kernel only at 64 <= C <= 256 on a TPU
(convffn.py:586-604, a measured loss of XLA fusions elsewhere) and the
folded XLA chain otherwise; the port runs its kernel in every ConvFFN (10 a
t8 forward, 12 an sa12 forward), as its dinov2 chains do at every size.
SpatialAttention calls ``ops/attention.attention`` (the flash kernel on the
card). ``kernels=False`` runs the plain versions of both.

The backbone runs in ``torch.channels_last``: a conv's NCHW output is then
(B, H, W, C) in memory, and the ConvFFN kernel and the attention read it as
(B, H*W, C) rows without a copy.

LayerScale multiplies in the compute dtype, as the port's ViT does. (The JAX
package multiplies by the f32 parameter, which promotes its bf16 activations
to f32 from the first block on; in f32 the two agree.)

Training (batch statistics, the reuse forms, ConvLoRA dropout and the
ConvFFN backward) is the next slice: the backbone refuses train mode, and a
ConvFFN refuses to run under grad mode when a weight requires grad.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from dino_pose_tpu_torch.models.fastvit_fold import (
    apply_folded,
    bn_affine,
    cached_fold,
    center_identity,
    fold_branch,
)
from dino_pose_tpu_torch.nn import layers as L
from dino_pose_tpu_torch.ops.attention import attention, plain_attention
from dino_pose_tpu_torch.ops.convffn import ConvFFNParams, convffn_math, fused_convffn


@dataclasses.dataclass(frozen=True)
class FastViTConfig:
    embed_dims: tuple[int, ...] = (48, 96, 192, 384)
    depths: tuple[int, ...] = (2, 2, 4, 2)
    mlp_ratios: tuple[float, ...] = (3.0, 3.0, 3.0, 3.0)
    token_mixers: tuple[str, ...] = ("repmixer",) * 4
    pos_embs: tuple[bool, ...] = (False, False, False, False)  # RepCPE per stage
    layer_scale_init: float = 1e-5
    attn_head_dim: int = 32
    final_se: bool = True
    # LoRA over ConvFFN fc1/fc2 (0 = disabled).
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_dropout: float = 0.1

    @property
    def out_channels(self) -> int:
        return 2 * self.embed_dims[-1]


_SA = dict(
    embed_dims=(64, 128, 256, 512),
    mlp_ratios=(4.0,) * 4,
    token_mixers=("repmixer", "repmixer", "repmixer", "attention"),
    pos_embs=(False, False, False, True),
)

FASTVIT_PRESETS: dict[str, FastViTConfig] = {
    "t8": FastViTConfig(),
    "t12": FastViTConfig(embed_dims=(64, 128, 256, 512), depths=(2, 2, 6, 2)),
    "s12": FastViTConfig(
        embed_dims=(64, 128, 256, 512), depths=(2, 2, 6, 2), mlp_ratios=(4.0,) * 4
    ),
    "sa12": FastViTConfig(depths=(2, 2, 6, 2), **_SA),
    "sa24": FastViTConfig(depths=(4, 4, 12, 4), **_SA),
    "sa36": FastViTConfig(depths=(6, 6, 18, 6), **_SA),
    "ma36": FastViTConfig(
        depths=(6, 6, 18, 6),
        embed_dims=(76, 152, 304, 608),
        mlp_ratios=(4.0,) * 4,
        token_mixers=("repmixer", "repmixer", "repmixer", "attention"),
        pos_embs=(False, False, False, True),
    ),
    # Tiny preset for tests.
    "test-tiny": FastViTConfig(
        embed_dims=(8, 16, 32, 64),
        depths=(1, 1, 1, 1),
        token_mixers=("repmixer", "repmixer", "repmixer", "attention"),
        pos_embs=(False, False, False, True),
        attn_head_dim=16,
    ),
}


class ConvBN(nn.Module):
    """timm's conv_bn: a bias-free ``conv`` and its BatchNorm ``bn``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def fold(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        return fold_branch(self.conv.weight, self.bn, k)


class SEBlock(nn.Module):
    """Squeeze-excite, rd_ratio 1/16, conv-parameterised."""

    def __init__(self, c: int, rd_ratio: float = 1.0 / 16):
        super().__init__()
        rd = max(1, int(c * rd_ratio))
        self.reduce = nn.Conv2d(c, rd, 1)
        self.expand = nn.Conv2d(rd, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = L.conv2d(torch.relu(L.conv2d(s, self.reduce)), self.expand)
        return x * torch.sigmoid(s)


class MobileOneBlock(nn.Module):
    """Multi-branch reparameterisable conv block: ``num_conv_branches`` kxk
    (conv, BN) branches, a 1x1 (conv, BN) scale branch when k > 1, an
    identity BN when shapes allow; summed, optionally SE'd and GELU'd. Runs
    as its eval fold (fastvit.py:298-401)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3, stride: int = 1,
                 groups: int = 1, *, use_act: bool = True, use_se: bool = False,
                 use_scale_branch: bool = True, num_conv_branches: int = 1):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.stride, self.groups = k, stride, groups
        self.in_g, self.features, self.use_act = cin // groups, features, use_act
        self.rbr_conv = nn.ModuleList(
            ConvBN(cin, features, k, stride, groups) for _ in range(num_conv_branches)
        )
        self.rbr_scale = (ConvBN(cin, features, 1, stride, groups)
                          if use_scale_branch and k > 1 else None)
        self.rbr_skip = nn.BatchNorm2d(features) if cin == features and stride == 1 else None
        self.se = SEBlock(features) if use_se else None

    def fold_f32(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The linear part as one f32 (kernel, bias): ``_folded`` with
        ``return_fold``."""
        k = self.kernel_size
        dev = next(self.parameters()).device
        kf = torch.zeros((self.features, self.in_g, k, k), device=dev)
        bf = torch.zeros((self.features,), device=dev)
        branches = [*self.rbr_conv] + ([self.rbr_scale] if self.rbr_scale is not None else [])
        for branch in branches:
            kt, bt = branch.fold(k)
            kf, bf = kf + kt, bf + bt
        if self.rbr_skip is not None:
            inv, shift = bn_affine(self.rbr_skip)
            ident = center_identity(k, self.in_g, self.features, dev)
            kf, bf = kf + ident * inv.view(-1, 1, 1, 1), bf + shift
        return kf, bf

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rbr_skip is not None and not self.rbr_conv and self.rbr_scale is None:
            # Pure-affine block (identity BN only): no conv (fastvit.py:387-393).
            inv, shift = bn_affine(self.rbr_skip)
            out = (x.float() * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)).to(x.dtype)
        else:
            kernel, bias = cached_fold(
                self, x.dtype, lambda dt: tuple(t.to(dt) for t in self.fold_f32()))
            out = apply_folded(x, kernel, bias, stride=self.stride,
                               padding=self.kernel_size // 2, groups=self.groups)
        if self.se is not None:
            out = self.se(out)
        return F.gelu(out) if self.use_act else out


class ReparamLargeKernelConv(nn.Module):
    """Large-kernel conv with a parallel small-kernel branch, GELU'd; runs
    as one folded k x k conv (fastvit.py:437-454)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 7, stride: int = 2,
                 groups: int = 1, small_kernel: int = 3):
        super().__init__()
        self.kernel_size, self.stride, self.groups = kernel_size, stride, groups
        self.lkb_origin = ConvBN(cin, features, kernel_size, stride, groups)
        self.small_conv = ConvBN(cin, features, small_kernel, stride, groups)

    def _fold(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        kl, bl = self.lkb_origin.fold(self.kernel_size)
        ks, bs = self.small_conv.fold(self.kernel_size)
        return (kl + ks).to(dtype), (bl + bs).to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = cached_fold(self, x.dtype, self._fold)
        out = apply_folded(x, kernel, bias, stride=self.stride,
                           padding=self.kernel_size // 2, groups=self.groups)
        return F.gelu(out)


class PatchEmbed(nn.Module):
    """Between-stage downsample: a 7x7 reparam depthwise(-multiplier) conv at
    stride 2, then a 1x1 MobileOne block."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.proj = nn.Sequential(
            ReparamLargeKernelConv(cin, features, 7, 2, groups=cin, small_kernel=3),
            MobileOneBlock(features, features, kernel_size=1, stride=1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class RepCPE(nn.Module):
    """Conditional positional encoding: x + depthwise 7x7 conv(x)."""

    def __init__(self, c: int):
        super().__init__()
        self.pe = nn.Conv2d(c, c, 7, padding=3, groups=c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + L.conv2d(x, self.pe)


class RepMixer(nn.Module):
    """Token mixing x + ls*(mixer(x) - norm(x)) as ONE 3x3 depthwise conv,
    K = ls*(Km - Kn) + I, b = ls*(bm - bn) (fastvit.py:781-802)."""

    def __init__(self, c: int, layer_scale_init: float):
        super().__init__()
        self.layer_scale_init = layer_scale_init
        self.mixer = MobileOneBlock(c, c, 3, 1, groups=c, use_act=False)
        self.norm = MobileOneBlock(c, c, 3, 1, groups=c, use_act=False,
                                   use_scale_branch=False, num_conv_branches=0)
        self.layer_scale = nn.Parameter(torch.empty(c, 1, 1))

    def _fold(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        km, bm = self.mixer.fold_f32()
        kn, bn_ = self.norm.fold_f32()
        ls = self.layer_scale.float().view(-1)
        ident = center_identity(3, 1, ls.shape[0], ls.device)
        kernel = ls.view(-1, 1, 1, 1) * (km - kn) + ident
        return kernel.to(dtype), (ls * (bm - bn_)).to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = cached_fold(self, x.dtype, self._fold)
        return apply_folded(x, kernel, bias, stride=1, padding=1, groups=x.shape[1])


class ConvLoRA(nn.Module):
    """A 1x1 conv with its LoRA pair (the reference's ConvLoRA tree):
    ``original_conv``, ``lora_A`` (in -> rank) and ``lora_B`` (rank -> out),
    both bias-free."""

    def __init__(self, cin: int, cout: int, rank: int):
        super().__init__()
        self.original_conv = nn.Conv2d(cin, cout, 1)
        self.lora_A = nn.Conv2d(cin, rank, 1, bias=False)
        self.lora_B = nn.Conv2d(rank, cout, 1, bias=False)


def _matrix(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A 1x1 conv's weight (out, in, 1, 1) as the (in, out) matrix."""
    return conv.weight[:, :, 0, 0].t().to(dtype).contiguous()


class ConvFFN(nn.Module):
    """Depthwise 7x7 conv (``conv``: conv + BN), then 1x1 fc1 -> GELU -> 1x1
    fc2, each 1x1 with ConvLoRA when ``lora_rank`` > 0. The depthwise conv
    runs on its own (JAX's ``dw_branch_conv``, stride 1, fastvit_fold.py:442);
    the rest is ``fused_convffn`` on the BatchNorm's eval affine
    (fastvit.py:658-674)."""

    def __init__(self, c: int, hidden: int, lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.c, self.lora_rank = c, lora_rank
        self.s_lora = lora_alpha / lora_rank if lora_rank else 1.0
        self.conv = ConvBN(c, c, 7, 1, groups=c)
        if lora_rank:
            self.fc1 = ConvLoRA(c, hidden, lora_rank)
            self.fc2 = ConvLoRA(hidden, c, lora_rank)
        else:
            self.fc1 = nn.Conv2d(c, hidden, 1)
            self.fc2 = nn.Conv2d(hidden, c, 1)

    def _fold(self, dtype: torch.dtype) -> tuple[torch.Tensor, ConvFFNParams]:
        """The depthwise kernel in ``dtype`` and the kernel's parameters
        without the masks (matrices in ``dtype``, vectors f32). Rank 0 is
        rank-1 zero adapters (fastvit.py:596-603)."""
        inv, shift = bn_affine(self.conv.bn)
        if self.lora_rank:
            fc1, fc2 = self.fc1.original_conv, self.fc2.original_conv
            a1, b1l = _matrix(self.fc1.lora_A, dtype), _matrix(self.fc1.lora_B, dtype)
            a2, b2l = _matrix(self.fc2.lora_A, dtype), _matrix(self.fc2.lora_B, dtype)
        else:
            fc1, fc2 = self.fc1, self.fc2
            dev, hidden = inv.device, fc1.weight.shape[0]
            a1, b1l = (torch.zeros(s, dtype=dtype, device=dev) for s in ((self.c, 1), (1, hidden)))
            a2, b2l = (torch.zeros(s, dtype=dtype, device=dev) for s in ((hidden, 1), (1, self.c)))
        p = ConvFFNParams(
            inv=inv.contiguous(), shift=shift.contiguous(),
            w1=_matrix(fc1, dtype), b1=fc1.bias.float().contiguous(),
            w2=_matrix(fc2, dtype), b2=fc2.bias.float().contiguous(),
            a1=a1, b1l=b1l, a2=a2, b2l=b2l, m1=None, m2=None,
        )
        return self.conv.conv.weight.to(dtype), p

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *self.parameters())):
            raise ValueError(
                "the FastViT ConvFFN has no backward yet (the FastViT training slice), and an "
                "input or weight requires grad; run the forward under torch.no_grad() or "
                "torch.inference_mode()"
            )
        dw, p = cached_fold(self, x.dtype, self._fold)
        y = F.conv2d(x, dw, None, 1, 3, 1, self.c)
        b, c, hh, ww = y.shape
        rows = y.permute(0, 2, 3, 1).reshape(b, hh * ww, c)  # a view under channels_last
        ones = torch.ones((b, p.a1.shape[1]), dtype=torch.float32, device=x.device)
        p = p._replace(m1=ones, m2=ones)  # eval: no ConvLoRA dropout
        if kernels:
            out = fused_convffn(rows.contiguous(), p, self.s_lora)
        else:
            out = convffn_math(rows, p, self.s_lora)
        return out.view(b, hh, ww, c).permute(0, 3, 1, 2)


class SpatialAttention(nn.Module):
    """Multi-head self-attention over the flattened grid (timm's Attention:
    ``qkv`` without bias, ``proj``). The pre-norm BatchNorm, which timm keeps
    on the block (``blocks.j.norm``), is folded into qkv: BN(x) @ W =
    x @ (inv * W) + shift @ W (fastvit.py:825-853)."""

    def __init__(self, c: int, head_dim: int):
        super().__init__()
        self.head_dim = head_dim
        self.num_heads = max(1, c // head_dim)
        self.qkv = nn.Linear(c, 3 * c, bias=False)
        self.proj = nn.Linear(c, c)

    def _fold(self, norm: nn.BatchNorm2d, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
        inv, shift = bn_affine(norm)
        wq = self.qkv.weight.float().t()  # (in, out)
        return ((inv[:, None] * wq).to(dtype).contiguous(), (shift @ wq).to(dtype),
                self.proj.weight.t().to(dtype).contiguous(), self.proj.bias.to(dtype))

    def forward(self, x: torch.Tensor, norm: nn.BatchNorm2d, kernels: bool = True) -> torch.Tensor:
        wqkv, bqkv, wproj, bproj = cached_fold(self, x.dtype, lambda dt: self._fold(norm, dt), norm)
        b, c, hh, ww = x.shape
        s, nh = hh * ww, self.num_heads
        qkv = x.permute(0, 2, 3, 1).reshape(b, s, c) @ wqkv + bqkv
        q, k, v = (t.reshape(b, s, nh, c // nh).transpose(1, 2).contiguous()
                   for t in qkv.split(c, dim=-1))
        scale = self.head_dim ** -0.5
        o = attention(q, k, v, scale) if kernels else plain_attention(q, k, v, scale)
        o = o.transpose(1, 2).reshape(b, s, c) @ wproj + bproj
        return o.view(b, hh, ww, c).permute(0, 3, 1, 2)


class FastViTBlock(nn.Module):
    """RepMixer block (``token_mixer``, ``layer_scale``) or attention block
    (``norm``, ``token_mixer``, ``layer_scale_1``, ``layer_scale_2``), each
    with its ConvFFN ``mlp`` (fastvit.py:856-913; the default-off pair path
    is not ported)."""

    def __init__(self, c: int, mixer: str, mlp_ratio: float, cfg: FastViTConfig):
        super().__init__()
        self.mixer = mixer
        if mixer == "repmixer":
            self.token_mixer = RepMixer(c, cfg.layer_scale_init)
            self.layer_scale = nn.Parameter(torch.empty(c, 1, 1))
        else:
            self.norm = nn.BatchNorm2d(c)
            self.token_mixer = SpatialAttention(c, cfg.attn_head_dim)
            self.layer_scale_1 = nn.Parameter(torch.empty(c, 1, 1))
            self.layer_scale_2 = nn.Parameter(torch.empty(c, 1, 1))
        self.mlp = ConvFFN(c, int(c * mlp_ratio), cfg.lora_rank, cfg.lora_alpha)

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        if self.mixer == "repmixer":
            x = self.token_mixer(x)
            ls2 = self.layer_scale
        else:
            x = x + self.token_mixer(x, self.norm, kernels) * self.layer_scale_1.to(x.dtype)
            ls2 = self.layer_scale_2
        return x + self.mlp(x, kernels) * ls2.to(x.dtype)


class FastViTStage(nn.Module):
    def __init__(self, cin: int, dim: int, depth: int, index: int, cfg: FastViTConfig):
        super().__init__()
        self.downsample = PatchEmbed(cin, dim) if index > 0 else None
        self.pos_emb = RepCPE(dim) if cfg.pos_embs[index] else None
        self.blocks = nn.ModuleList(
            FastViTBlock(dim, cfg.token_mixers[index], cfg.mlp_ratios[index], cfg)
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        if self.pos_emb is not None:
            x = self.pos_emb(x)
        for blk in self.blocks:
            x = blk(x, kernels)
        return x


class FastViTBackbone(nn.Module):
    """stem -> 4 stages -> final SE conv: NCHW pixels -> the (B, 2*dims[-1],
    H/32, W/32) feature map (fastvit.py:916-947), in channels_last memory."""

    def __init__(self, cfg: FastViTConfig):
        super().__init__()
        self.cfg = cfg
        d0 = cfg.embed_dims[0]
        self.stem = nn.Sequential(
            MobileOneBlock(3, d0, 3, 2),
            MobileOneBlock(d0, d0, 3, 2, groups=d0),
            MobileOneBlock(d0, d0, 1, 1),
        )
        dims = (d0, *cfg.embed_dims)
        self.stages = nn.ModuleList(
            FastViTStage(dims[i], dims[i + 1], cfg.depths[i], i, cfg)
            for i in range(len(cfg.embed_dims))
        )
        c = cfg.embed_dims[-1]
        self.final_conv = MobileOneBlock(c, cfg.out_channels, 3, 1, groups=c,
                                         use_se=cfg.final_se)

    def forward(self, pixels: torch.Tensor, *, kernels: bool = True) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "FastViT runs eval only in the port so far: its train-mode blocks (batch "
                "statistics, the ConvFFN backward) are the FastViT training slice; call .eval()"
            )
        x = self.stem(pixels.contiguous(memory_format=torch.channels_last))
        for stage in self.stages:
            x = stage(x, kernels)
        return self.final_conv(x)
