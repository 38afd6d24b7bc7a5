"""FastViT backbone (counterpart of dino_pose_tpu/models/fastvit.py).

Apple's FastViT as timm builds it: a MobileOne stem, four stages of RepMixer
blocks (in the SA/MA variants, self-attention in the last stage, behind a
RepCPE positional conv) with ConvFFN MLPs, reparameterisable patch
embeddings between stages, and a final SE conv to 2 * dims[-1] channels.
Module attribute names follow timm's state-dict keys (``stem.0.rbr_conv.0.conv``,
``stages.1.downsample.proj.0.lkb_origin``, ``stages.3.blocks.0.token_mixer.qkv``,
``final_conv.se.reduce``, LoRA under ``mlp.fc1.{original_conv,lora_A,lora_B}``),
so reference-schema state dicts load with ``strict=True``.

Eval, as the JAX package runs it: every multi-branch block is one folded
conv (``fastvit_fold``), RepMixer is one 3x3 depthwise conv with K =
ls*(Km - Kn) + I, SpatialAttention folds its BatchNorm into qkv, and every
ConvFFN runs its depthwise 7x7 conv then ``ops/convffn.fused_convffn`` on
the BatchNorm affine.

Train (``.train()``), as JAX's default train mode (``reuse``,
fastvit_fold.py:72-130): each materialised branch output feeds its own
batch-statistics BatchNorm affine elementwise, in f32; branches whose
statistics are functions of x (the depthwise 1x1 scale branch, the identity
BN, stem0's 1x1 over 3 channels) become per-channel coefficients on x from
its moments; RepMixer is one 3x3 depthwise conv and one elementwise map;
SpatialAttention normalises with ``nn/layers.batch_norm_train``; every
ConvFFN runs ``ops/convffn.convffn_train`` (the forward kernel, and the
backward kernel for the LoRA, BatchNorm and input gradients) with its
ConvLoRA Dropout2d masks drawn from the step's generator, m1 then m2, block
by block. Nothing in train mode comes from the fold cache but the frozen
fc1/fc2 matrices. The backbone is frozen in every FastViT training mode
(train/partition.py): with LoRA, gradients reach the adapters through the
ConvFFN backward; without, no backbone tensor requires grad and autograd
builds no graph below the heads.

**The port departs from the JAX route here:** the JAX package takes its
ConvFFN kernel only at 64 <= C <= 256 on a TPU (convffn.py:586-604, a
measured loss of XLA fusions elsewhere), and in training only with LoRA;
the port runs its kernels in every ConvFFN (10 a t8 forward, 12 an sa12
forward, and as many backward launches a LoRA step), as its dinov2 chains
do at every size. SpatialAttention calls ``ops/attention.attention`` (the
flash kernels on the card). ``kernels=False`` runs the plain versions of
both.

The backbone runs in ``torch.channels_last``: a conv's NCHW output is then
(B, H, W, C) in memory, and the ConvFFN kernels and the attention read it as
(B, H*W, C) rows without a copy.

LayerScale multiplies in the compute dtype, as the port's ViT does, in eval
and train. (The JAX package multiplies by the f32 parameter, which promotes
its bf16 activations to f32 from the first block on; in f32 the two agree.)

JAX's two opt-in kernel arms are its own switches, read at call time (off
when unset; ``ops/dwconv.py`` for ``on`` and ``force``):

- ``DINO_POSE_TPU_DWCONV``: every stride-1, multiplier-1 depthwise conv in
  the window (the RepMixer mixer's 3x3 branch in training, each ConvFFN's
  7x7 in eval and training, at C < 128) runs ``ops/dwconv.dw_conv_frozen``
  with f32 taps, where the conv route casts them to the compute dtype;
- ``DINO_POSE_TPU_STAGE_PAIR``: in training, a RepMixer + ConvFFN block
  whose shapes pass ``pair_enabled`` and ``convffn_res_enabled`` (JAX's
  gate, fastvit.py:870-898) runs as two segment kernels around its two
  batch-statistics barriers: the RepMixer as per-channel (a, b, bias) on x
  and its 3x3 branch y0 (``RepMixer.combine_terms``), then
  ``combine_dw_frozen`` (x2 = a*x + b*y0 + bias, y7 = dw7(x2)), y7's batch
  statistics, and ``convffn_res_train`` on (y7, x2) with LayerScale folded
  into w2, b2 and b2l in f32 before the cast (``ConvFFN.pair_forward``).
  The parameter tree is the same on either route.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from dino_pose_tpu_torch.core import distributed
from dino_pose_tpu_torch.models.fastvit_fold import (
    apply_folded,
    bn_affine,
    bn_train_affine,
    branch_stats,
    cached_fold,
    center_identity,
    channel_moments,
    dw_arm_conv,
    dw_branch_conv,
    dw_route,
    fold_branch,
    stats_branch_reuse,
)
from dino_pose_tpu_torch.nn import layers as L
from dino_pose_tpu_torch.ops.attention import attention, plain_attention
from dino_pose_tpu_torch.ops.convffn import (
    ConvFFNParams,
    convffn_math,
    convffn_res_enabled,
    convffn_res_train,
    convffn_train,
    fused_convffn,
)
from dino_pose_tpu_torch.ops.dwconv import combine_dw_frozen, pair_enabled

_VIEW = (1, -1, 1, 1)  # a per-channel vector against NCHW


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
    as its eval fold (fastvit.py:298-401), in train mode as its reuse form
    (``_reuse``, fastvit.py:176-296)."""

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

    def train_terms(self, x: torch.Tensor, kernels: bool = True):
        """The train-mode linear part unapplied (``_reuse``'s terms):
        ``(terms, xc, xc_rep, bias)``, ``terms`` a list of (f32 inv,
        materialised branch output), ``xc`` the f32 per-channel coefficient on
        the stride-sampled x (or None), ``xc_rep`` the same on x repeated to
        the features of a depthwise-multiplier block, ``bias`` f32. Every
        BatchNorm of the block takes its batch statistics here, once.
        ``kernels`` picks the depthwise-conv arm's kernel or plain version."""
        s, groups, cin = self.stride, self.groups, self.in_g * self.groups
        mult = self.features // groups
        terms, xc, xc_rep = [], None, None
        bias = torch.zeros(self.features, device=x.device)
        for branch in self.rbr_conv:
            y, inv, shift = stats_branch_reuse(x, branch.conv.weight, branch.bn,
                                               stride=s, groups=groups, kernels=kernels)
            terms.append((inv, y))
            bias = bias + shift
        if self.rbr_scale is not None:
            w, bn = self.rbr_scale.conv.weight, self.rbr_scale.bn
            if self.in_g == 1:
                # Depthwise(-multiplier) 1x1: a per-channel scalar on x, whose
                # statistics and output are functions of x's moments.
                mx, m2x, n = channel_moments(x, s)
                svec = w[:, 0, 0, 0].float()
                mean = svec * mx.repeat_interleave(mult)
                var = svec.square() * m2x.repeat_interleave(mult) - mean.square()
                inv, shift = bn_train_affine(bn, mean, var, n)
                coeff = inv * svec
                if mult == 1:
                    xc = coeff if xc is None else xc + coeff
                else:
                    xc_rep = coeff if xc_rep is None else xc_rep + coeff
            elif groups == 1 and cin <= 8:
                # Dense 1x1 over few channels (stem0): gram-matrix moments on
                # the strided grid, the output as cin per-channel FMAs.
                # Under a data axis across ranks: the global batch's moments.
                xs = x[:, :, ::s, ::s].float()
                flat = xs.permute(0, 2, 3, 1).reshape(-1, cin)
                n = distributed.data_count(flat.shape[0])
                gram = distributed.data_matmul_mean(flat.t(), flat)
                wm = w[:, :, 0, 0].t().float()  # (cin, features)
                mean = distributed.data_mean(flat, (0,)) @ wm
                var = torch.einsum("co,do,cd->o", wm, wm, gram) - mean.square()
                inv, shift = bn_train_affine(bn, mean, var, n)
                y_scale = xs[:, 0:1] * wm[0].view(_VIEW)
                for ci in range(1, cin):
                    y_scale = y_scale + xs[:, ci:ci + 1] * wm[ci].view(_VIEW)
                terms.append((inv, y_scale))
            else:
                y, inv, shift = stats_branch_reuse(x, w, bn, stride=s, groups=groups,
                                                   kernels=kernels)
                terms.append((inv, y))
            bias = bias + shift
        if self.rbr_skip is not None:
            mx, m2x, n = channel_moments(x)
            inv, shift = bn_train_affine(self.rbr_skip, mx, m2x - mx.square(), n)
            xc = inv if xc is None else xc + inv
            bias = bias + shift
        return terms, xc, xc_rep, bias

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """``_reuse`` applied: sum the terms in f32, cast, then SE and GELU."""
        terms, xc, xc_rep, bias = self.train_terms(x)
        out = bias.view(_VIEW)
        for inv, y in terms:
            out = y.float() * inv.view(_VIEW) + out
        x_s = x[:, :, ::self.stride, ::self.stride] if self.stride != 1 else x
        if xc is not None:
            out = out + x_s.float() * xc.view(_VIEW)
        if xc_rep is not None:
            mult = self.features // self.groups
            out = out + x_s.repeat_interleave(mult, dim=1).float() * xc_rep.view(_VIEW)
        out = out.to(x.dtype)
        if self.se is not None:
            out = self.se(out)
        return F.gelu(out) if self.use_act else out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
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
    as one folded k x k conv (fastvit.py:437-454), in train mode as both
    branch outputs through their batch-statistics affines, summed in f32
    (fastvit.py:418-436)."""

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
        if self.training:
            acc = None
            for branch in (self.lkb_origin, self.small_conv):
                y, inv, shift = stats_branch_reuse(x, branch.conv.weight, branch.bn,
                                                   stride=self.stride, groups=self.groups)
                t = y.float() * inv.view(_VIEW) + shift.view(_VIEW)
                acc = t if acc is None else acc + t
            return F.gelu(acc.to(x.dtype))
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
    K = ls*(Km - Kn) + I, b = ls*(bm - bn) (fastvit.py:781-802). In train
    mode the reuse form (fastvit.py:756-780): the mixer's materialised 3x3
    branch y0 and per-channel coefficients on x, one f32 map
    x*(1 + ls*(xc_m - xc_n)) + ls*inv0*y0 + ls*(b_m - b_n)."""

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

    def _coefficients(self, x: torch.Tensor, kernels: bool):
        """The train-mode terms: (mixer terms, norm terms, f32 ls, f32 a, f32
        bias), out = a*x + bias + sum ls*inv*y over the mixer's terms minus
        the norm's."""
        terms_m, xc_m, _, bias_m = self.mixer.train_terms(x, kernels)
        terms_n, xc_n, _, bias_n = self.norm.train_terms(x, kernels)
        zero = torch.zeros_like(bias_m)
        xc_m = zero if xc_m is None else xc_m
        xc_n = zero if xc_n is None else xc_n
        ls = self.layer_scale.float().view(-1)
        return terms_m, terms_n, ls, 1.0 + ls * (xc_m - xc_n), ls * (bias_m - bias_n)

    def _train_forward(self, x: torch.Tensor, kernels: bool) -> torch.Tensor:
        terms_m, terms_n, ls, a, bias = self._coefficients(x, kernels)
        out = x.float() * a.view(_VIEW) + bias.view(_VIEW)
        for inv, y in terms_m:
            out = out + y.float() * (ls * inv).view(_VIEW)
        for inv, y in terms_n:
            out = out - y.float() * (ls * inv).view(_VIEW)
        return out.to(x.dtype)

    def combine_terms(self, x: torch.Tensor, kernels: bool = True):
        """The train-mode mixer unapplied, for the stage-pair arm (JAX's
        ``return_combine``, fastvit.py:727-755): f32 (C,) ``a``, ``b``,
        ``bias`` and the mixer's 3x3 branch output ``y0``, with out = a*x +
        b*y0 + bias."""
        terms_m, terms_n, ls, a, bias = self._coefficients(x, kernels)
        if len(terms_m) != 1 or terms_n:
            raise ValueError("combine_terms expects exactly one materialised mixer branch "
                             "and a stats-only norm")
        inv0, y0 = terms_m[0]
        return a, ls * inv0, bias, y0

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        if self.training:
            return self._train_forward(x, kernels)
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
    runs on its own (JAX's ``dw_branch_conv``, stride 1, fastvit_fold.py:442;
    the depthwise-conv arm where ``dw_route`` passes, in eval as in
    training, as JAX's eval takes it, fastvit.py:656); the rest is the
    ConvFFN kernel on the BatchNorm affine (fastvit.py: 658-674): in eval
    without grad ``fused_convffn`` on the cached eval affine; in train mode
    ``convffn_train`` on the batch-statistics affine (``branch_stats``,
    two-pass) with the ConvLoRA Dropout2d masks bernoulli(keep)/keep per
    (sample, rank) (fastvit.py:585-595). Eval under grad with a trainable
    adapter is refused by the eval cache. ``pair_forward`` is the
    stage-pair arm's block (fastvit.py:626-655)."""

    def __init__(self, c: int, hidden: int, lora_rank: int = 0, lora_alpha: float = 16.0,
                 lora_dropout: float = 0.0):
        super().__init__()
        self.c, self.hidden = c, hidden
        self.lora_rank, self.lora_dropout = lora_rank, lora_dropout
        self.s_lora = lora_alpha / lora_rank if lora_rank else 1.0
        self.conv = ConvBN(c, c, 7, 1, groups=c)
        if lora_rank:
            self.fc1 = ConvLoRA(c, hidden, lora_rank)
            self.fc2 = ConvLoRA(hidden, c, lora_rank)
        else:
            self.fc1 = nn.Conv2d(c, hidden, 1)
            self.fc2 = nn.Conv2d(hidden, c, 1)

    def _base(self, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
        """The frozen fc1/fc2 in the kernels' layout: (w1, b1, w2, b2)."""
        fc1, fc2 = ((self.fc1.original_conv, self.fc2.original_conv) if self.lora_rank
                    else (self.fc1, self.fc2))
        return (_matrix(fc1, dtype), fc1.bias.float().contiguous(),
                _matrix(fc2, dtype), fc2.bias.float().contiguous())

    def _adapters(self, dtype: torch.dtype) -> list[torch.Tensor]:
        """(A1, B1, A2, B2) as (in, out) views of the f32 LoRA weights, with
        their graphs; rank 0 as rank-1 zeros in ``dtype`` (fastvit.py:596-603)."""
        if self.lora_rank:
            return [m.weight[:, :, 0, 0].t() for m in (self.fc1.lora_A, self.fc1.lora_B,
                                                      self.fc2.lora_A, self.fc2.lora_B)]
        hidden, dev = self.fc1.weight.shape[0], self.fc1.weight.device
        return [torch.zeros(shape, dtype=dtype, device=dev)
                for shape in ((self.c, 1), (1, hidden), (hidden, 1), (1, self.c))]

    def _fold(self, dtype: torch.dtype) -> tuple[torch.Tensor, ConvFFNParams]:
        """The eval cache: the depthwise kernel in ``dtype`` and the kernel's
        parameters without the masks (matrices in ``dtype``, vectors f32)."""
        inv, shift = bn_affine(self.conv.bn)
        p = ConvFFNParams(inv.contiguous(), shift.contiguous(), *self._base(dtype),
                          *(t.to(dtype).contiguous() for t in self._adapters(dtype)), None, None)
        return self.conv.conv.weight.to(dtype), p

    def _live_params(self, inv: torch.Tensor, shift: torch.Tensor, b: int, dtype: torch.dtype,
                     generator: torch.Generator | None,
                     ls2: torch.Tensor | None = None) -> ConvFFNParams:
        """The parameters as they train: the BatchNorm affine and the LoRA
        matrices with their graphs, the frozen fc1/fc2 cached per version,
        and the masks: in train mode with dropout, bernoulli(keep)/keep per
        (sample, rank) from ``generator``, m1 then m2; ones otherwise. With
        ``ls2`` (the stage-pair arm) LayerScale is folded into w2, b2 and
        b2l in f32 (fastvit.py:646-652), cast to ``dtype`` in the kernel's
        layout later; b2l keeps its graph."""
        fc1, fc2 = ((self.fc1.original_conv, self.fc2.original_conv) if self.lora_rank
                    else (self.fc1, self.fc2))
        base = cached_fold(fc1, dtype, self._base, fc2)
        adapters = self._adapters(dtype)
        if ls2 is not None:
            lsf = ls2.float().view(-1)
            base = (*base[:2], fc2.weight[:, :, 0, 0].t().float() * lsf, fc2.bias.float() * lsf)
            adapters[3] = adapters[3] * lsf
        dev, r = inv.device, max(self.lora_rank, 1)
        if self.training and self.lora_rank and self.lora_dropout > 0.0:
            keep = 1.0 - self.lora_dropout
            # Under a data axis across ranks: this rank's rows of the global
            # batch's masks (core/distributed.batch_rand).
            m1, m2 = ((distributed.batch_rand((b, r), generator, dev) < keep).float() / keep
                      for _ in range(2))
        else:
            m1 = m2 = torch.ones((b, r), dtype=torch.float32, device=dev)
        return ConvFFNParams(inv, shift, *base, *adapters, m1, m2)

    def forward(self, x: torch.Tensor, kernels: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.training:
            y = dw_branch_conv(x, self.conv.conv.weight, 1, self.c, kernels)
            mean, var, n = branch_stats(y)
            inv, shift = bn_train_affine(self.conv.bn, mean, var, n)
            p = self._live_params(inv, shift, y.shape[0], x.dtype, generator)
        else:
            dw, p = cached_fold(self, x.dtype, self._fold)
            if dw_route(x, self.conv.conv.weight, 1, self.c):
                y = dw_arm_conv(x, self.conv.conv.weight, kernels)
            else:
                y = F.conv2d(x, dw, None, 1, 3, 1, self.c)
            ones = torch.ones((y.shape[0], p.a1.shape[1]), dtype=torch.float32, device=x.device)
            p = p._replace(m1=ones, m2=ones)  # eval: no ConvLoRA dropout
        b, c, hh, ww = y.shape
        rows = y.permute(0, 2, 3, 1).reshape(b, hh * ww, c)  # a view under channels_last
        if self.training:
            out = convffn_train(rows, p, self.s_lora, kernels=kernels)
        elif kernels:
            out = fused_convffn(rows.contiguous(), p, self.s_lora)
        else:
            out = convffn_math(rows, p, self.s_lora)
        return out.view(b, hh, ww, c).permute(0, 3, 1, 2)

    def pair_forward(self, x: torch.Tensor, combine: tuple, ls2: torch.Tensor,
                     kernels: bool = True,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """The stage-pair arm (JAX's ``ConvFFN`` with ``pair``, fastvit.py:
        626-655): the BLOCK output x2 + ls2 * ConvFFN(x2) from the block input
        ``x`` and the RepMixer's ``combine`` = (a, b, bias, y0):
        ``combine_dw_frozen`` gives x2 and y7 = dw7(x2) (f32 taps), y7's batch
        statistics give the BatchNorm affine, and ``convffn_res_train`` adds
        the residual x2 to the ConvFFN with LayerScale folded into w2, b2
        and b2l."""
        a, bvec, bias, y0 = combine
        x2, y7 = combine_dw_frozen(x.permute(0, 2, 3, 1), y0.permute(0, 2, 3, 1), a, bvec, bias,
                                   self.conv.conv.weight.permute(2, 3, 1, 0), kernels=kernels)
        b, hh, ww, c = y7.shape
        mean, var, n = branch_stats(y7.permute(0, 3, 1, 2))
        inv, shift = bn_train_affine(self.conv.bn, mean, var, n)
        p = self._live_params(inv, shift, b, x.dtype, generator, ls2=ls2)
        out = convffn_res_train(y7.reshape(b, hh * ww, c), x2.reshape(b, hh * ww, c), p,
                                self.s_lora, kernels=kernels)
        # The block output in its input's layout: the train-mode reuse forms
        # leave NCHW-contiguous tensors, and a channels_last one would send
        # every depthwise conv after it to cuDNN's grouped kernels.
        layout = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
                  else torch.contiguous_format)
        return out.view(b, hh, ww, c).permute(0, 3, 1, 2).contiguous(memory_format=layout)


class SpatialAttention(nn.Module):
    """Multi-head self-attention over the flattened grid (timm's Attention:
    ``qkv`` without bias, ``proj``). The pre-norm BatchNorm, which timm keeps
    on the block (``blocks.j.norm``), is folded into qkv in eval: BN(x) @ W =
    x @ (inv * W) + shift @ W (fastvit.py:825-853). In train mode it
    normalises with its batch statistics first, then qkv, attention and proj
    run as layers (fastvit.py:841-853, JAX's train default)."""

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
        b, c, hh, ww = x.shape
        s, nh = hh * ww, self.num_heads
        if self.training:
            t = L.batch_norm_train(x, norm).permute(0, 2, 3, 1).reshape(b, s, c)
            qkv = L.dense(t, self.qkv)
        else:
            wqkv, bqkv, wproj, bproj = cached_fold(
                self, x.dtype, lambda dt: self._fold(norm, dt), norm)
            qkv = x.permute(0, 2, 3, 1).reshape(b, s, c) @ wqkv + bqkv
        q, k, v = (t.reshape(b, s, nh, c // nh).transpose(1, 2).contiguous()
                   for t in qkv.split(c, dim=-1))
        scale = self.head_dim ** -0.5
        o = attention(q, k, v, scale) if kernels else plain_attention(q, k, v, scale)
        o = o.transpose(1, 2).reshape(b, s, c)
        o = L.dense(o, self.proj) if self.training else o @ wproj + bproj
        return o.view(b, hh, ww, c).permute(0, 3, 1, 2)


class FastViTBlock(nn.Module):
    """RepMixer block (``token_mixer``, ``layer_scale``) or attention block
    (``norm``, ``token_mixer``, ``layer_scale_1``, ``layer_scale_2``), each
    with its ConvFFN ``mlp`` (fastvit.py:856-913). A RepMixer block in
    training takes the default-off stage-pair arm where JAX's gate passes
    (``pair``)."""

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
        self.mlp = ConvFFN(c, int(c * mlp_ratio), cfg.lora_rank, cfg.lora_alpha,
                           cfg.lora_dropout)

    def pair(self, x: torch.Tensor) -> bool:
        """JAX's stage-pair gate (fastvit.py:870-884): a RepMixer block in
        training (the reuse form, the port's only train form) whose shapes
        pass ``pair_enabled`` (k = 7) and ``convffn_res_enabled``."""
        b, c, hh, ww = x.shape
        return (self.training and self.mixer == "repmixer"
                and pair_enabled(c, hh, ww, 7, x.element_size(), batch=b)
                and convffn_res_enabled(c, self.mlp.hidden, hh * ww, x.element_size(), True,
                                        self.mlp.lora_rank, batch=b))

    def forward(self, x: torch.Tensor, kernels: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.pair(x):
            return self.mlp.pair_forward(x, self.token_mixer.combine_terms(x, kernels),
                                         self.layer_scale, kernels, generator)
        if self.mixer == "repmixer":
            x = self.token_mixer(x, kernels)
            ls2 = self.layer_scale
        else:
            x = x + self.token_mixer(x, self.norm, kernels) * self.layer_scale_1.to(x.dtype)
            ls2 = self.layer_scale_2
        return x + self.mlp(x, kernels, generator) * ls2.to(x.dtype)


class FastViTStage(nn.Module):
    def __init__(self, cin: int, dim: int, depth: int, index: int, cfg: FastViTConfig):
        super().__init__()
        self.downsample = PatchEmbed(cin, dim) if index > 0 else None
        self.pos_emb = RepCPE(dim) if cfg.pos_embs[index] else None
        self.blocks = nn.ModuleList(
            FastViTBlock(dim, cfg.token_mixers[index], cfg.mlp_ratios[index], cfg)
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor, kernels: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        if self.pos_emb is not None:
            x = self.pos_emb(x)
        for blk in self.blocks:
            x = blk(x, kernels, generator)
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

    def forward(self, pixels: torch.Tensor, *, kernels: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """In train mode (``.train()``) every BatchNorm takes batch statistics
        and updates its running ones, and the ConvLoRA dropout draws from
        ``generator``."""
        x = self.stem(pixels.contiguous(memory_format=torch.channels_last))
        for stage in self.stages:
            x = stage(x, kernels, generator)
        return self.final_conv(x)
