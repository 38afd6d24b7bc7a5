"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card. The file
imports no JAX, so that it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: bf16, 3e-2 abs/rel — the JAX suite's own bf16 tolerance for the
fused block (tests/test_block_kernel.py); kernel and plain version round
every product to bf16, in another summation order, so single roundings flip
by one ulp. The backward's weight gradients are f32 sums over all B*S rows
of such bf16 terms: each is held elementwise to 2e-3 of its largest
magnitude (an H100 measured at most 8.3e-4, chip_smoke.py's GRAD_TOL).
The attention alone (flash_attention's o, dq, dk, dv; fused_attn_part's
output, which adds no residual) is held to chip_smoke.py's attention
tolerance: 4e-3 + 2e-2*|ref| elementwise, since its values are ~0.04 at
long S, and in relative Frobenius norm 5e-4 (flash) and 3e-3
(fused_attn_part, two GEMMs more), about three and two times the largest
an H100 measured. ``fused_convffn`` (FastViT's ConvFFN) is held to 3e-2
abs/rel at every fastvit_t8, fastvit_sa12 and fastvit_ma36 stage shape
(ma36's C = 76 and 152 zero-padded to multiples of 16); its backward
``fused_convffn_bwd`` holds dy to the same and each parameter gradient (f32
sums over all rows) to 2e-3 of its largest magnitude, as the block
backward's. dinov2-large's weight-streamed halves (``fused_attn_part_stream``,
``fused_mlp_part_stream``, D = 1024, 16 heads) and ``fused_mlp_dx`` at that
width are held as their resident twins: the attention half at the attention
tolerance, the rest at 3e-2 abs/rel. The trainable streamed halves of
dinov2-base and -large (``fused_mlp_part_stream_train``,
``fused_mlp_bwd_stream``, ``fused_attn_bwd_stream``) as the resident
backward: outputs with a residual at 3e-2 abs/rel, those with none (h2, the
attention backward's dx) at the attention tolerance, weight gradients
within 2e-3 of their largest magnitude. FastViT's opt-in arms
(``fused_dw_conv``, ``fused_combine_dw``, ``fused_combine_dw_bwd``,
``fused_convffn_res``) at 3e-2 abs/rel on their activations at every t8 and
sa12 stage shape, at ragged H = 24 and 56 and at C = 76 and 20, k = 3 and 7;
the backward's f32 sums da, db, dbias within 2e-3 of their largest
magnitude; the segment's x2 bit-equal to the plain combine's and its
kernels' second calls bit-equal to the first. A launch that is a fresh host
thread's first CUDA work is held bit-equal to the same call on the main
thread (the TMA encoders bind a context there), and the five CLIs beside
``cli.train`` run on the card with exact launch counts.
"""

import copy
import json
import warnings

import numpy as np
import pytest
import torch

from dino_pose_tpu_torch.models import registry
from dino_pose_tpu_torch.ops import attention, block, convffn
from dino_pose_tpu_torch.train.state import create_train_state
from dino_pose_tpu_torch.train.step import make_train_step, prepare_batch

EPS = 1e-6
NAMES = ("fused_block", "fused_attn_part", "fused_mlp_part")
D, HIDDEN, HEADS = 384, 1536, 6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def _params(device, d=D, hidden=HIDDEN) -> block.BlockParams:
    rng = np.random.default_rng(1)

    def n(*s, std=1.0, mean=0.0):
        return (rng.standard_normal(s) * std + mean).astype(np.float32)

    p = dict(
        g1=n(d, std=0.1, mean=1), b1=n(d, std=0.05), wqkv=n(d, 3 * d, std=d**-0.5),
        bqkv=n(3 * d, std=0.05), wo=n(d, d, std=d**-0.5), bo=n(d, std=0.05),
        ls1=rng.uniform(0.1, 1, d).astype(np.float32), g2=n(d, std=0.1, mean=1),
        b2=n(d, std=0.05), w1=n(d, hidden, std=d**-0.5), bf1=n(hidden, std=0.05),
        w2=n(hidden, d, std=hidden**-0.5), bf2=n(d, std=0.05),
        ls2=rng.uniform(0.1, 1, d).astype(np.float32),
    )
    return block.BlockParams(**{
        k: torch.from_numpy(v).to(device, torch.bfloat16 if v.ndim == 2 else torch.float32)
        for k, v in p.items()
    })


def _call(name, x, p, kernel):
    ap, mp = block.attn_params(p), block.mlp_params(p)
    if name == "fused_block":
        return block.fused_block(x, p, HEADS, EPS) if kernel else \
            block.block_math(x, p, num_heads=HEADS, eps=EPS)
    if name == "fused_attn_part":
        return block.fused_attn_part(x, ap, HEADS, EPS) if kernel else \
            block.attn_part_math(x, ap, num_heads=HEADS, eps=EPS)
    return block.fused_mlp_part(x, mp, EPS) if kernel else block.mlp_part_math(x, mp, eps=EPS)


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [257, 57])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain(cuda_device, name, batch, seq):
    p = _params(cuda_device)
    x = torch.from_numpy(
        np.random.default_rng(batch).standard_normal((batch, seq, D)).astype(np.float32)
    ).to(cuda_device, torch.bfloat16)
    block.reset_launches()
    got = _call(name, x, p, kernel=True).float()
    want = _call(name, x, p, kernel=False).float()
    torch.cuda.synchronize()
    assert block.LAUNCHES[name] == 1
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
def test_wrappers_refuse_what_they_do_not_take(cuda_device):
    p = _params(cuda_device)
    x = torch.zeros((1, 257, D), device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        block.fused_block(x, p, HEADS, EPS)                     # f32 on CUDA
    with pytest.raises(ValueError, match="head width"):
        block.fused_block(x.to(torch.bfloat16), p, 4, EPS)      # dh = 96
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.zeros((1, 514, D), device=cuda_device, dtype=torch.bfloat16)[:, ::2]
        block.fused_mlp_part(strided, block.mlp_params(p), EPS)
    with pytest.raises(TypeError, match="wqkv"):
        bad = p._replace(wqkv=p.wqkv.float())
        block.fused_attn_part(x.to(torch.bfloat16), block.attn_params(bad), HEADS, EPS)


@pytest.mark.cuda
def test_tiny_model_kernels_match_plain(cuda_device):
    """test/vit-tiny (D = 64, head width 32) through the kernels on the card."""
    model = registry.create_model_from_config(
        {"model_name": "test/vit-tiny", "use_lora": True}, device=cuda_device
    )
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 3, 224, 224)).astype(np.float32)
    ).to(cuda_device, torch.bfloat16)
    block.reset_launches()
    with torch.inference_mode():
        hm, z = model(x)
        hm_p, z_p = model(x, kernels=False)
    torch.cuda.synchronize()
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "fused_block": 1,
                              "fused_attn_part": 1, "fused_mlp_part": 1, "attn_fwd": 2}
    for got, want in ((hm, hm_p), (z, z_p)):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 5e-2 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("batch, seq", [(1, 257), (8, 257), (2, 57)])
def test_mlp_dx_matches_plain(cuda_device, batch, seq):
    mp = block.mlp_params(_params(cuda_device))
    rng = np.random.default_rng(batch + seq)
    x2, dy = (torch.from_numpy(rng.standard_normal((batch, seq, D)).astype(np.float32))
              .to(cuda_device, torch.bfloat16) for _ in range(2))
    block.reset_launches()
    got = block.fused_mlp_dx(x2, dy, mp, EPS).float()
    want = block.mlp_dx_math(x2, dy, mp, eps=EPS).float()
    torch.cuda.synchronize()
    assert block.LAUNCHES["fused_mlp_dx"] == 1
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
def test_mlp_dx_refuses_what_it_does_not_take(cuda_device):
    mp = block.mlp_params(_params(cuda_device))
    x2 = torch.zeros((1, 257, D), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        block.fused_mlp_dx(x2.float(), x2, mp, EPS)
    with pytest.raises(ValueError, match="differ"):
        block.fused_mlp_dx(x2, x2[:, :57].contiguous(), mp, EPS)
    trainable = mp._replace(w2=mp.w2.clone().requires_grad_())
    with pytest.raises(ValueError, match="requires grad"):
        block.mlp_part_frozen(x2.clone().requires_grad_(), trainable, EPS)


@pytest.mark.cuda
def test_tiny_model_train_step_kernels_match_plain(cuda_device):
    """One test/vit-tiny + LoRA train step at batch 2, kernels vs plain in
    bf16 and plain in f32, the same dropout masks. Losses agree to 1e-3; the
    bf16 gradients are held to the plain path's bf16 noise as in
    chip_smoke.py: the kernel path's error vs f32, and its distance from the
    plain path, are at most twice the plain bf16 path's error vs f32 plus
    1e-2 (these gradients are sums that the BatchNorm after them nearly
    cancels, so bf16 rounding alone moves them far from f32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = {"model_name": "test/vit-tiny", "use_lora": True}
    model = registry.create_model_from_config(config, device=cuda_device)
    with torch.no_grad():
        lora = model.backbone.encoder.layer[1].attention.lora_output
        lora.lora_B.copy_(torch.randn(lora.lora_B.shape, generator=torch.Generator().manual_seed(0)) * 0.05)
    rng = np.random.default_rng(0)
    kps = rng.uniform(20, 200, (2, 24, 3)).astype(np.float32)
    kps[..., 2] = 2.0
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 3, 224, 224)).astype(np.float32)),
             "2d_keypoints": torch.from_numpy(kps),
             "z_coords": torch.from_numpy(rng.standard_normal((2, 24)).astype(np.float32))}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    names = ("backbone.encoder.layer.1.attention.lora_output.lora_A",
             "backbone.encoder.layer.1.attention.lora_output.lora_B",
             "pose_heads.heatmap_head.prediction.3.weight")
    out = {}
    for name, kernels, dtype in (("kernels", True, torch.bfloat16), ("plain", False, torch.bfloat16),
                                 ("f32", False, torch.float32)):
        m = copy.deepcopy(model)
        state, opt, part = create_train_state(m, config)
        step = prepare_batch(make_train_step(m, opt, part, kernels=kernels), (224, 48), dtype)
        block.reset_launches()
        _, stats = step(state, batch, 3e-5, 0)
        torch.cuda.synchronize()
        want = 1 if kernels else 0
        assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "fused_block": want,
                                  "fused_attn_part": want, "fused_mlp_part": want,
                                  "fused_mlp_dx": want, "attn_fwd": 2 * want}
        params = dict(m.named_parameters())
        out[name] = (stats, {n: params[n].grad.float() for n in names})
    (ks, kg), (ps, pg), (_, rg) = out["kernels"], out["plain"], out["f32"]
    for k in ("loss", "kp_loss", "z_loss", "weight"):
        assert abs(ks[k].item() - ps[k].item()) <= 1e-3 * abs(ps[k].item()), k

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    for n in names:
        assert torch.isfinite(kg[n]).all(), n
        tol = 2 * rel(pg[n], rg[n]) + 1e-2
        assert max(rel(kg[n], rg[n]), rel(kg[n], pg[n])) <= tol, n


TRAIN_NAMES = ("fused_block_train", "fused_mlp_bwd", "fused_attn_bwd")


def _train_call(name, x, dy, p, kernel):
    """The wrapper or its plain version: a flat tuple of its outputs."""
    if name == "fused_block_train":
        if kernel:
            return block.fused_block_train(x, p, HEADS, EPS)
        return block.block_train_math(x, p, num_heads=HEADS, eps=EPS)
    if name == "fused_mlp_bwd":
        mp = block.mlp_params(p)
        dx, g = (block.fused_mlp_bwd(x, dy, mp, EPS) if kernel
                 else block.mlp_bwd_math(x, dy, mp, eps=EPS))
    else:
        atp = block.attn_train_params(p)
        dx, g = (block.fused_attn_bwd(x, dy, atp, HEADS, EPS) if kernel
                 else block.attn_bwd_math(x, dy, atp, num_heads=HEADS, eps=EPS))
    return (dx, *g)


@pytest.mark.cuda
@pytest.mark.parametrize("batch, seq", [(1, 257), (8, 257), (128, 257), (2, 57)])
@pytest.mark.parametrize("name", TRAIN_NAMES)
def test_train_kernel_matches_plain(cuda_device, name, batch, seq):
    """Every output: y and x2, or dx and each weight gradient, with a
    unit-scale seeded cotangent."""
    p = _params(cuda_device)
    rng = np.random.default_rng(batch + seq)
    x, dy = (torch.from_numpy(rng.standard_normal((batch, seq, D)).astype(np.float32))
             .to(cuda_device, torch.bfloat16) for _ in range(2))
    block.reset_launches()
    got = _train_call(name, x, dy, p, kernel=True)
    want = _train_call(name, x, dy, p, kernel=False)
    torch.cuda.synchronize()
    attention = {"fused_block_train": {"attn_fwd": 1},
                 "fused_attn_bwd": {"attn_fwd": 1, "attn_bwd": 1}}.get(name, {})
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), name: 1, **attention}
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        assert g.shape == w.shape and torch.isfinite(g).all(), i
        if g.dim() == 3:      # activations and dx
            torch.testing.assert_close(g, w, atol=3e-2, rtol=3e-2)
        else:                 # f32 weight gradients
            err = (g - w).abs().max().item()
            assert err <= 2e-3 * w.abs().max().item(), (i, err, w.abs().max().item())


@pytest.mark.cuda
def test_train_wrappers_refuse_f32_on_cuda(cuda_device):
    """A CUDA tensor launches the kernel or raises; f32 is not taken."""
    p = _params(cuda_device)
    x = torch.zeros((1, 257, D), device=cuda_device)
    block.reset_launches()
    with pytest.raises(TypeError, match="bf16"):
        block.fused_block_train(x, p, HEADS, EPS)
    with pytest.raises(TypeError, match="bf16"):
        block.fused_mlp_bwd(x, x, block.mlp_params(p), EPS)
    with pytest.raises(TypeError, match="bf16"):
        block.fused_attn_bwd(x, x, block.attn_train_params(p), HEADS, EPS)
    assert sum(block.LAUNCHES.values()) == 0


@pytest.mark.cuda
def test_tiny_model_unfreeze_train_step_kernels_match_plain(cuda_device):
    """One test/vit-tiny unfreeze-2 train step at batch 2 (both blocks train
    whole), kernels vs plain in bf16 and plain in f32. Launches per step: two
    fused_block_train, fused_mlp_bwd and fused_attn_bwd, and their resident
    attention kernels (four forwards, two backward pairs), nothing else. Losses
    agree to 1e-3; each block gradient's error vs f32, and its distance from
    the plain path, are at most twice the plain bf16 path's error vs f32
    plus 1e-2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = {"model_name": "test/vit-tiny", "use_lora": False, "unfreeze_last_n_layers": 2}
    model = registry.create_model_from_config(config, device=cuda_device)
    rng = np.random.default_rng(1)
    kps = rng.uniform(20, 200, (2, 24, 3)).astype(np.float32)
    kps[..., 2] = 2.0
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 3, 224, 224)).astype(np.float32)),
             "2d_keypoints": torch.from_numpy(kps),
             "z_coords": torch.from_numpy(rng.standard_normal((2, 24)).astype(np.float32))}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    names = [f"backbone.encoder.layer.{i}.{leaf}" for i in (0, 1) for leaf in (
        "attention.attention.query.weight", "attention.output.dense.bias",
        "layer_scale1.lambda1", "norm1.weight", "mlp.fc1.weight", "mlp.fc2.bias",
        "layer_scale2.lambda1", "norm2.weight")]
    out = {}
    for name, kernels, dtype in (("kernels", True, torch.bfloat16), ("plain", False, torch.bfloat16),
                                 ("f32", False, torch.float32)):
        m = copy.deepcopy(model)
        state, opt, part = create_train_state(m, config)
        step = prepare_batch(make_train_step(m, opt, part, kernels=kernels), (224, 48), dtype)
        block.reset_launches()
        _, stats = step(state, batch, 3e-5, 0)
        torch.cuda.synchronize()
        want = 2 if kernels else 0
        assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "fused_block_train": want,
                                  "fused_mlp_bwd": want, "fused_attn_bwd": want,
                                  "attn_fwd": 2 * want, "attn_bwd": want}
        params = dict(m.named_parameters())
        out[name] = (stats, {n: params[n].grad.float() for n in names})
    (ks, kg), (ps, pg), (_, rg) = out["kernels"], out["plain"], out["f32"]
    for k in ("loss", "kp_loss", "z_loss", "weight"):
        assert abs(ks[k].item() - ps[k].item()) <= 1e-3 * abs(ps[k].item()), k

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    for n in names:
        assert torch.isfinite(kg[n]).all(), n
        tol = 2 * rel(pg[n], rg[n]) + 1e-2
        assert max(rel(kg[n], rg[n]), rel(kg[n], pg[n])) <= tol, n


def _bf16(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, torch.bfloat16)


def _assert_attention_close(got, want, fro_tol):
    """The attention tolerance: elementwise and in relative Frobenius norm."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=4e-3, rtol=2e-2)
    fro = ((got - want).norm() / want.norm()).item()
    assert fro <= fro_tol, fro


# (B, H, S, dh): dinov2-small at 504² (S = 1297, ragged: 20*64 + 17 rows) at
# batch 1, 4 and 8, head width 32, S = 577, and a single short tile; S = 1296
# (whole tiles) and 65 (one key over). fastvit_sa12's SpatialAttention at
# 256² (16 heads of 32 over an 8x8 grid: one query tile, no ragged edge) at
# batch 1, 8 and its train batch 32, and fastvit_ma36's 19 heads of 32.
FLASH_CASES = [(1, 6, 1297, 64), (4, 6, 1297, 64), (2, 2, 1297, 32), (2, 6, 577, 64),
               (1, 2, 100, 32), (1, 16, 64, 32), (8, 16, 64, 32),
               (1, 6, 1296, 64), (8, 6, 1297, 64), (2, 6, 65, 64), (32, 16, 64, 32),
               (2, 19, 64, 32), (32, 19, 64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_CASES)
def test_flash_attention_matches_plain(cuda_device, shape):
    """flash_attention's kernels (one forward, one backward pair) against
    flash_math / flash_bwd_math on o, dq, dk and dv, unit-scale cotangent."""
    rng = np.random.default_rng(sum(shape))
    q, k, v, g = (_bf16(rng, shape, cuda_device) for _ in range(4))
    scale = shape[-1] ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    block.reset_launches()
    o = attention.flash_attention(*leaves, scale)
    o.backward(g)
    torch.cuda.synchronize()
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "flash_fwd": 1, "flash_bwd": 1}
    want = (attention.flash_math(q, k, v, scale), *attention.flash_bwd_math(q, k, v, g, scale))
    for got, w in zip((o.detach(), *(t.grad for t in leaves)), want):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        _assert_attention_close(got, w, 5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 128])
def test_flash_attention_is_deterministic(cuda_device, rows):
    """No atomics: two launches give the same bits, at both of the forward's
    row tiles (64 and 128 rows a block; the backward pair has one), and
    agree with the plain versions."""
    gen = torch.Generator().manual_seed(rows)
    q, k, v, g = (torch.randn((2, 6, 1297, 64), generator=gen).to(cuda_device, torch.bfloat16)
                  for _ in range(4))
    lib = attention._ext.lib()
    prev = lib.dp_flash_fwd_rows(rows)
    try:
        runs = []
        for _ in range(2):
            o, stats = attention.flash_fwd(q, k, v, 0.125)
            runs.append((o, stats, *attention.flash_bwd(q, k, v, g, stats, 0.125)))
    finally:
        lib.dp_flash_fwd_rows(prev)
    torch.cuda.synchronize()
    # stats' third row is the backward's (written into flash_bwd's copy).
    (o0, st0, *g0), (o1, st1, *g1) = runs
    assert torch.equal(st0[:, :, :2], st1[:, :, :2])
    assert all(torch.equal(a, b) for a, b in zip((o0, *g0), (o1, *g1)))
    want = (attention.flash_math(q, k, v, 0.125), *attention.flash_bwd_math(q, k, v, g, 0.125))
    for got, w in zip((o0, *g0), want):
        _assert_attention_close(got, w, 5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("heads, dh", [(6, 64), (12, 32)])
def test_flash_pair_on_the_packed_layout_at_ragged_s(cuda_device, heads, dh):
    """The chains' packed qkv (B, S, 3D) at S = 1300 (20 * 64 + 20 rows):
    the streamed forward and backward against the plain versions."""
    rng = np.random.default_rng(heads)
    qkv, dctx = _bf16(rng, (2, 1300, 3 * heads * dh), cuda_device), _bf16(
        rng, (2, 1300, heads * dh), cuda_device)
    with torch.inference_mode():
        ctx = block.packed_attention(qkv, heads, streamed=True)
        dqkv = block.packed_attention_bwd(qkv, dctx, heads, streamed=True)
        want_ctx = block._heads_attention(qkv, heads)
        want_dqkv = block.packed_attention_bwd_math(qkv, dctx, heads)
    torch.cuda.synchronize()
    _assert_attention_close(ctx, want_ctx, 5e-4)
    for got, w in zip(dqkv.chunk(3, -1), want_dqkv.chunk(3, -1)):
        _assert_attention_close(got, w, 5e-4)


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 2, 300, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        attention.flash_attention(q.float(), q.float(), q.float(), 0.125)
    with pytest.raises(ValueError, match="head width"):
        attention.flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                                  q[..., :48].contiguous(), 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention(q.transpose(1, 2), q, q, 0.125)


# The block wrappers with an attention step; at S = 401 and 1297 the head's
# K and V do not fit shared memory and the chains stream them.
LONG_NAMES = ("fused_block", "fused_attn_part", "fused_block_train", "fused_attn_bwd")


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [401, 1297])
@pytest.mark.parametrize("name", LONG_NAMES)
def test_chains_stream_attention_at_long_sequences(cuda_device, name, seq):
    """Each chain at batch 2 against its plain version on every output
    (fused_attn_part's at the attention tolerance), and its launches: one
    of the wrapper, one flash forward, and for fused_attn_bwd (which
    recomputes the forward) one flash backward pair."""
    p = _params(cuda_device)
    rng = np.random.default_rng(seq)
    x, dy = (_bf16(rng, (2, seq, D), cuda_device) for _ in range(2))
    block.reset_launches()
    if name in NAMES:
        got, want = (_call(name, x, p, kernel=True),), (_call(name, x, p, kernel=False),)
    else:
        got, want = _train_call(name, x, dy, p, kernel=True), _train_call(name, x, dy, p, kernel=False)
    torch.cuda.synchronize()
    flash_bwd = int(name == "fused_attn_bwd")
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), name: 1, "flash_fwd": 1,
                              "flash_bwd": flash_bwd}
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        assert g.shape == w.shape and torch.isfinite(g).all(), i
        if name == "fused_attn_part":
            _assert_attention_close(g, w, 3e-3)
        elif g.dim() == 3:
            torch.testing.assert_close(g, w, atol=3e-2, rtol=3e-2)
        else:
            err = (g - w).abs().max().item()
            assert err <= 2e-3 * w.abs().max().item(), (i, err, w.abs().max().item())


@pytest.mark.cuda
def test_tiny_model_at_504_kernels_match_plain(cuda_device):
    """test/vit-tiny + LoRA at 504² (head width 32, S = 1297): both layers
    stream their attention (two flash forwards), and the heads run their
    one-stage plan."""
    model = registry.create_model_from_config(
        {"model_name": "test/vit-tiny", "use_lora": True}, device=cuda_device
    )
    x = _bf16(np.random.default_rng(2), (2, 3, 504, 504), cuda_device)
    block.reset_launches()
    with torch.inference_mode():
        hm, z = model(x)
        hm_p, z_p = model(x, kernels=False)
    torch.cuda.synchronize()
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "fused_block": 1,
                              "fused_attn_part": 1, "fused_mlp_part": 1, "flash_fwd": 2}
    assert hm.shape == (2, 24, 48, 48)
    for got, want in ((hm, hm_p), (z, z_p)):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 5e-2 * want.float().abs().max().item()


@pytest.mark.cuda
def test_attn_bwd_streams_where_only_the_resident_forward_fits(cuda_device):
    """At S = 316 (head width 64) the resident attention forward fits shared
    memory and the resident backward does not: fused_block keeps K and V
    resident, while fused_attn_bwd streams both its recomputed forward (for
    the row statistics) and its backward."""
    p = _params(cuda_device)
    rng = np.random.default_rng(316)
    x, dy = (_bf16(rng, (2, 316, D), cuda_device) for _ in range(2))
    zero = dict.fromkeys(block.LAUNCHES, 0)
    block.reset_launches()
    got = _call("fused_block", x, p, kernel=True)
    torch.cuda.synchronize()
    assert block.LAUNCHES == {**zero, "fused_block": 1, "attn_fwd": 1}
    torch.testing.assert_close(got.float(), _call("fused_block", x, p, kernel=False).float(),
                               atol=3e-2, rtol=3e-2)
    block.reset_launches()
    got = _train_call("fused_attn_bwd", x, dy, p, kernel=True)
    want = _train_call("fused_attn_bwd", x, dy, p, kernel=False)
    torch.cuda.synchronize()
    assert block.LAUNCHES == {**zero, "fused_attn_bwd": 1, "flash_fwd": 1, "flash_bwd": 1}
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=3e-2, rtol=3e-2)
    for g, w in zip(got[1:], want[1:]):
        assert (g - w).abs().max().item() <= 2e-3 * w.abs().max().item()


# (C, H, S) of each stage at 256² input: fastvit_t8 (mlp ratio 3), then
# fastvit_sa12 (mlp ratio 4); S = the stage's grid, 64x64 down to 8x8.
CONVFFN_STAGES = [(48, 144, 4096), (96, 288, 1024), (192, 576, 256), (384, 1152, 64),
                  (64, 256, 4096), (128, 512, 1024), (256, 1024, 256), (512, 2048, 64)]


def _convffn_inputs(b, s, c, h, r, device, seed=0):
    """bf16 y and matrices, f32 vectors; masks of zeros and 1/keep (rank
    r), or rank 0 as rank-1 zero adapters with ones masks."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    rank = max(r, 1)
    if r:
        lora = dict(a1=n(c, r, std=c**-0.5), b1l=n(r, h, std=0.1),
                    a2=n(h, r, std=h**-0.5), b2l=n(r, c, std=0.1))
        m1, m2 = (torch.from_numpy((rng.random((b, r)) > 0.3).astype(np.float32) / 0.7)
                  for _ in range(2))
    else:
        lora = dict(a1=torch.zeros(c, 1), b1l=torch.zeros(1, h), a2=torch.zeros(h, 1),
                    b2l=torch.zeros(1, c))
        m1 = m2 = torch.ones(b, rank)
    p = dict(inv=torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
             shift=n(c, std=0.1), w1=n(c, h, std=c**-0.5), b1=n(h, std=0.1),
             w2=n(h, c, std=h**-0.5), b2=n(c, std=0.1), **lora, m1=m1, m2=m2)
    p = convffn.ConvFFNParams(**{
        k: v.to(device, torch.bfloat16 if v.dim() == 2 and k not in ("m1", "m2") else torch.float32)
        for k, v in p.items()})
    return n(b, s, c).to(device, torch.bfloat16), p


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("stage", CONVFFN_STAGES, ids=lambda t: f"C{t[0]}-H{t[1]}-S{t[2]}")
def test_convffn_matches_plain(cuda_device, stage, batch):
    c, h, s = stage
    y, p = _convffn_inputs(batch, s, c, h, 8, cuda_device, seed=c + batch)
    block.reset_launches()
    got = convffn.fused_convffn(y, p, 2.0).float()
    want = convffn.convffn_math(y, p, 2.0).float()
    torch.cuda.synchronize()
    assert block.LAUNCHES["fused_convffn"] == 1
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [8, 0])
@pytest.mark.parametrize("batch, seq", [(3, 50), (1, 17)])
def test_convffn_ragged_rows_and_ranks(cuda_device, batch, seq, rank):
    """Row counts that are not a multiple of the 32-row tile (150, 17), and
    rank 0 (rank-1 zeros, s = 1) beside rank 8 with real masks, at t8's
    stage-0 widths (C = 48, H = 144: not multiples of 32 or 64)."""
    y, p = _convffn_inputs(batch, seq, 48, 144, rank, cuda_device, seed=seq + rank)
    s_lora = 2.0 if rank else 1.0
    got = convffn.fused_convffn(y, p, s_lora).float()
    want = convffn.convffn_math(y, p, s_lora).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
def test_convffn_refuses_what_it_does_not_take(cuda_device):
    y, p = _convffn_inputs(1, 64, 48, 144, 8, cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        convffn.fused_convffn(y.float(), p, 2.0)
    with pytest.raises(ValueError, match="no backward"):
        convffn.fused_convffn(y, p._replace(a1=p.a1.clone().requires_grad_()), 2.0)
    with torch.no_grad():
        convffn.fused_convffn(y, p._replace(a1=p.a1.clone().requires_grad_()), 2.0)
    with pytest.raises(ValueError, match="rank"):
        y16, p16 = _convffn_inputs(1, 64, 48, 144, 16, cuda_device)
        convffn.fused_convffn(y16, p16, 2.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name, launches", [("timm/fastvit_t8.apple_in1k", {"fused_convffn": 10}),
                                            ("timm/fastvit_sa12.apple_in1k",
                                             {"fused_convffn": 12, "flash_fwd": 2})])
def test_fastvit_kernels_match_plain(cuda_device, name, launches):
    """t8 + LoRA and sa12 at 256², batch 2, through the kernels and the plain
    versions: launches per forward and agreement within 5% of the largest
    output (chip_smoke.py's MODEL_REL_TOL)."""
    _fastvit_forward_matches_plain(cuda_device, name, launches, 2)


@pytest.mark.cuda
def test_fastvit_sa24_forward_at_batch_1(cuda_device):
    """fastvit_sa24 at 256², batch 1: 24 ConvFFN launches and 4 flash
    forwards (its attention stage's four blocks), agreeing with the plain
    versions as test_fastvit_kernels_match_plain holds them."""
    _fastvit_forward_matches_plain(cuda_device, "timm/fastvit_sa24.apple_in1k",
                                   {"fused_convffn": 24, "flash_fwd": 4}, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name, launches", [
    ("timm/fastvit_t8.apple_in1k", {"fused_convffn": 20}),
    ("timm/fastvit_sa12.apple_in1k", {"fused_convffn": 24, "flash_fwd": 4})])
def test_fastvit_tp2_forward_launches_two_a_layer(cuda_device, name, launches):
    """t8 + LoRA and sa12 at 256², batch 2, under a (1, 2) mesh on the card:
    every ConvFFN as two shards of H/2 (t8's 72 zero-padded to 80) and each
    attention block as two shards of 8 heads, two launches a layer; the
    outputs against the plain versions under the same mesh as
    test_fastvit_kernels_match_plain holds them."""
    from dino_pose_tpu_torch.core.mesh import MeshSpec, create_mesh
    from dino_pose_tpu_torch.ops import dispatch

    with dispatch.scoped():
        create_mesh(MeshSpec(1, 2), device=cuda_device)
        _fastvit_forward_matches_plain(cuda_device, name, launches, 2)


def _fastvit_forward_matches_plain(cuda_device, name, launches, batch):
    model = registry.create_model_from_config(
        {"model_name": name, "use_lora": "t8" in name}, device=cuda_device, pretrained=False)
    with torch.no_grad():
        for n, prm in model.named_parameters():
            if "lora_B" in n:
                prm.copy_(torch.randn_like(prm) * 0.02)
            elif n.rsplit(".", 1)[-1].startswith("layer_scale"):
                prm.uniform_(0.1, 1.0)
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((batch, 3, 256, 256)).astype(np.float32)
    ).to(cuda_device, torch.bfloat16)
    block.reset_launches()
    with torch.inference_mode():
        hm, z = model(x)
        torch.cuda.synchronize()
        assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), **launches}
        hm_p, z_p = model(x, kernels=False)
    for got, want in ((hm, hm_p), (z, z_p)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 5e-2 * want.float().abs().max().item(), err


def _flat_bwd(out):
    dy, g = out
    return (dy, *g)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("stage", CONVFFN_STAGES, ids=lambda t: f"C{t[0]}-H{t[1]}-S{t[2]}")
def test_convffn_bwd_matches_plain(cuda_device, stage, batch):
    """dy at 3e-2 abs/rel (unit-scale cotangent), each parameter gradient
    within 2e-3 of its largest magnitude (chip_smoke.py's GRAD_TOL)."""
    c, h, s = stage
    y, p = _convffn_inputs(batch, s, c, h, 8, cuda_device, seed=c + batch)
    df = torch.from_numpy(np.random.default_rng(c).standard_normal((batch, s, c))
                          .astype(np.float32)).to(cuda_device, torch.bfloat16)
    block.reset_launches()
    got = _flat_bwd(convffn.fused_convffn_bwd(y, df, p, 2.0))
    want = _flat_bwd(convffn.convffn_bwd_math(y, df, p, 2.0))
    torch.cuda.synchronize()
    assert block.LAUNCHES["fused_convffn_bwd"] == 1 and sum(block.LAUNCHES.values()) == 1
    _assert_bwd_close(got, want)


def _assert_bwd_close(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        assert g.shape == w.shape and torch.isfinite(g).all(), i
        if i == 0:
            torch.testing.assert_close(g, w, atol=3e-2, rtol=3e-2)
        else:
            err = (g - w).abs().max().item()
            assert err <= 2e-3 * w.abs().max().item(), (i, err, w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [1, 3, 8, 0])
@pytest.mark.parametrize("batch, seq", [(3, 50), (1, 17), (5, 64)])
def test_convffn_bwd_ragged_rows_and_ranks(cuda_device, batch, seq, rank):
    """Ragged row counts (150, 17: not a multiple of the 32-row tile, masks
    changing inside a tile), ranks 1..8 and rank 0 (rank-1 zeros, s = 1),
    at t8's stage-0 widths and the backward's fixed grid."""
    y, p = _convffn_inputs(batch, seq, 48, 144, rank, cuda_device, seed=seq + rank)
    df = torch.from_numpy(np.random.default_rng(rank).standard_normal((batch, seq, 48))
                          .astype(np.float32)).to(cuda_device, torch.bfloat16)
    s_lora = 2.0 if rank else 1.0
    got = _flat_bwd(convffn.fused_convffn_bwd(y, df, p, s_lora))
    want = _flat_bwd(convffn.convffn_bwd_math(y, df, p, s_lora))
    torch.cuda.synchronize()
    if rank:
        _assert_bwd_close(got, want)
    else:
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=3e-2, rtol=3e-2)
        assert not any(t.any() for t in got[3:]) and not any(t.any() for t in want[3:])
    again = _flat_bwd(convffn.fused_convffn_bwd(y, df, p, s_lora))
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


# fastvit_ma36's stages at 256² (C, H, S): C = 76 and 152 are not multiples
# of 16, the kernels' width; the wrappers zero-pad C and slice back.
MA36_STAGES = [(76, 304, 4096), (152, 608, 1024), (304, 1216, 256), (608, 2432, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "res", "bwd"])
@pytest.mark.parametrize("stage", MA36_STAGES, ids=lambda t: f"C{t[0]}-H{t[1]}-S{t[2]}")
def test_convffn_kernels_at_ma36_stages(cuda_device, stage, kind):
    """fused_convffn, fused_convffn_res and fused_convffn_bwd launch once at
    every fastvit_ma36 stage shape (batch 2, rank 8) and agree with their
    plain versions at the tolerances above; outputs and gradients come back
    at the caller's C and H."""
    c, h, s = stage
    y, p = _convffn_inputs(2, s, c, h, 8, cuda_device, seed=c)
    other = torch.from_numpy(np.random.default_rng(c + 1).standard_normal((2, s, c))
                             .astype(np.float32)).to(cuda_device, torch.bfloat16)
    block.reset_launches()
    if kind == "bwd":
        got = _flat_bwd(convffn.fused_convffn_bwd(y, other, p, 2.0))
        want = _flat_bwd(convffn.convffn_bwd_math(y, other, p, 2.0))
    elif kind == "res":
        got = (convffn.fused_convffn_res(y, other, p, 2.0),)
        want = (convffn.convffn_res_math(y, other, p, 2.0),)
    else:
        got, want = (convffn.fused_convffn(y, p, 2.0),), (convffn.convffn_math(y, p, 2.0),)
    torch.cuda.synchronize()
    name = {"fwd": "fused_convffn", "res": "fused_convffn_res", "bwd": "fused_convffn_bwd"}[kind]
    assert block.LAUNCHES[name] == 1 and sum(block.LAUNCHES.values()) == 1
    assert got[0].shape == (2, s, c)
    if kind == "bwd":
        assert got[4].shape == (8, h) and got[6].shape == (8, c)  # dB1, dB2
        _assert_bwd_close(got, want)
    else:
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
def test_convffn_bwd_refuses_what_it_does_not_take(cuda_device):
    y, p = _convffn_inputs(1, 64, 48, 144, 8, cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        convffn.fused_convffn_bwd(y.float(), y.float(), p, 2.0)
    with pytest.raises(ValueError, match="df must be"):
        convffn.fused_convffn_bwd(y, y[:, :32], p, 2.0)
    with pytest.raises(ValueError, match="rank"):
        y16, p16 = _convffn_inputs(1, 64, 48, 144, 16, cuda_device)
        convffn.fused_convffn_bwd(y16, y16, p16, 2.0)
    leaves = p._replace(w1=p.w1.clone().requires_grad_())
    with pytest.raises(ValueError, match="requires grad"):
        convffn.convffn_train(y, leaves, 2.0)


# Every fastvit_t8, fastvit_sa12 and fastvit_ma36 stage (ma36 at its own C,
# which the wrappers pad) with the model's train batch (t8 128; sa12 32; ma36,
# which has no training phase, at sa12's).
CONVFFN_EVERY_STAGE = ([("t8", *st, 128) for st in CONVFFN_STAGES[:4]]
                       + [("sa12", *st, 32) for st in CONVFFN_STAGES[4:]]
                       + [("ma36", *st, 32) for st in MA36_STAGES])


def _convffn_kind(kind, y, other, p, s_lora):
    """(kernel, plain) outputs of one wrapper and its LAUNCHES key."""
    if kind == "bwd":
        return (_flat_bwd(convffn.fused_convffn_bwd(y, other, p, s_lora)),
                _flat_bwd(convffn.convffn_bwd_math(y, other, p, s_lora)), "fused_convffn_bwd")
    if kind == "res":
        return ((convffn.fused_convffn_res(y, other, p, s_lora),),
                (convffn.convffn_res_math(y, other, p, s_lora),), "fused_convffn_res")
    return ((convffn.fused_convffn(y, p, s_lora),), (convffn.convffn_math(y, p, s_lora),),
            "fused_convffn")


def _assert_kind_close(kind, got, want):
    if kind == "bwd":
        _assert_bwd_close(got, want)
    else:
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "res", "bwd"])
@pytest.mark.parametrize("batch", ["1", "8", "train"])
@pytest.mark.parametrize("stage", CONVFFN_EVERY_STAGE, ids=lambda t: f"{t[0]}-C{t[1]}")
def test_convffn_wgmma_kernels_at_every_stage(cuda_device, stage, batch, kind):
    """The wgmma ConvFFN kernels (every launch plan: the row split, one
    warpgroup, the column split in one and two passes, df through the ring;
    weights resident or ringed, partial sets on chip or a set a tile) against
    their plain versions at each stage, batch 1, 8 and the train batch, rank
    8 with Dropout2d masks, at the tolerances above; one launch each."""
    _, c, h, s, train = stage
    b = train if batch == "train" else int(batch)
    y, p = _convffn_inputs(b, s, c, h, 8, cuda_device, seed=c + b)
    other = torch.from_numpy(np.random.default_rng(c + b).standard_normal((b, s, c))
                             .astype(np.float32)).to(cuda_device, torch.bfloat16)
    block.reset_launches()
    got, want, name = _convffn_kind(kind, y, other, p, 2.0)
    torch.cuda.synchronize()
    assert block.LAUNCHES[name] == 1 and sum(block.LAUNCHES.values()) == 1
    _assert_kind_close(kind, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "res", "bwd"])
@pytest.mark.parametrize("rank", [1, 2, 5, 8, 0])
@pytest.mark.parametrize("width", [(48, 144), (96, 288), (192, 576), (384, 1152), (512, 2048),
                                   (608, 2432)], ids=lambda t: f"C{t[0]}")
def test_convffn_wgmma_ragged_rows_and_ranks(cuda_device, width, rank, kind):
    """147 rows (B = 3, S = 49: the last 64-row tile ragged, the sample and
    its masks changing inside tiles), ranks 1-8 and rank 0 (rank-1 zeros,
    ones masks, s = 1), at a width of each launch plan."""
    c, h = width
    y, p = _convffn_inputs(3, 49, c, h, rank, cuda_device, seed=c + rank)
    other = torch.from_numpy(np.random.default_rng(rank).standard_normal((3, 49, c))
                             .astype(np.float32)).to(cuda_device, torch.bfloat16)
    got, want, _ = _convffn_kind(kind, y, other, p, 2.0 if rank else 1.0)
    torch.cuda.synchronize()
    if kind == "bwd" and not rank:
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=3e-2, rtol=3e-2)
        assert not any(t.any() for t in got[3:])
    else:
        _assert_kind_close(kind, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 4096, 48, 144), (128, 64, 384, 1152), (8, 64, 512, 2048),
                                   (2, 1024, 96, 288)],
                         ids=["on-chip-sets", "a-set-a-tile", "df-ring", "row-lanes"])
def test_convffn_wgmma_bwd_same_bits_twice(cuda_device, shape):
    """Two backward calls on the same inputs give the same bits (fixed-order
    partial sums, no atomics) in each way of keeping the partial sets."""
    b, s, c, h = shape
    y, p = _convffn_inputs(b, s, c, h, 8, cuda_device, seed=s)
    df = torch.from_numpy(np.random.default_rng(s).standard_normal((b, s, c))
                          .astype(np.float32)).to(cuda_device, torch.bfloat16)
    first = _flat_bwd(convffn.fused_convffn_bwd(y, df, p, 2.0))
    again = _flat_bwd(convffn.fused_convffn_bwd(y, df, p, 2.0))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "res"])
@pytest.mark.parametrize("stage", [CONVFFN_STAGES[3], CONVFFN_STAGES[7], MA36_STAGES[3]],
                         ids=["t8", "sa12", "ma36"])
def test_convffn_h_split_forward_at_late_stage(cuda_device, stage, kind):
    """At a late stage and batch 1 the forward's row tiles would leave the
    card idle: H is split over blocks (the plan says so), each writing f32
    partial products, and the finishing kernel sums them in split order
    before the epilogue. Against the plain version, one counted launch."""
    c, h, s = stage
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = convffn.convffn_plan(False, s, -(-c // 16) * 16, h, 8, sms)
    assert plan.splits > 1 and plan.blocks == plan.splits
    y, p = _convffn_inputs(1, s, c, h, 8, cuda_device, seed=c + 1)
    other = torch.from_numpy(np.random.default_rng(c).standard_normal((1, s, c))
                             .astype(np.float32)).to(cuda_device, torch.bfloat16)
    block.reset_launches()
    got, want, name = _convffn_kind(kind, y, other, p, 2.0)
    torch.cuda.synchronize()
    assert block.LAUNCHES[name] == 1 and sum(block.LAUNCHES.values()) == 1
    _assert_kind_close(kind, got, want)


@pytest.mark.cuda
def test_convffn_plan_smem_matches_the_kernel_layout(cuda_device):
    """convffn_smem (the host's plan) counts the bytes the kernel lays out
    (dp_convffn_smem) for the plan of every stage, batch and direction."""
    from dino_pose_tpu_torch.ops import _ext

    lib = _ext.lib()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for _, c, h, s, _ in CONVFFN_EVERY_STAGE:
        cp, hp = -(-c // 16) * 16, -(-h // 16) * 16
        for b in (1, 8, 32, 128):
            for bwd in (False, True):
                plan = convffn.convffn_plan(bwd, b * s, cp, hp, 8, sms)
                assert plan.smem == lib.dp_convffn_smem(
                    int(bwd), cp, hp, 8, plan.nwg, plan.lanes, plan.tb, plan.rs, int(plan.dfr),
                    int(plan.lres), int(plan.persist)), (c, b, bwd)


@pytest.mark.cuda
def test_fastvit_train_step_kernels_match_plain(cuda_device):
    """One fastvit_t8 + LoRA train step at 256², batch 2, kernels vs plain
    in bf16 and plain in f32, the same dropout masks: 10 forward and 10
    backward ConvFFN launches, nothing else; losses agree to 1e-3; each
    checked gradient's error vs f32, and its distance from the plain path,
    at most twice the plain bf16 path's error vs f32 plus 1e-2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = {"model_name": "timm/fastvit_t8.apple_in1k", "use_lora": True}
    model = registry.create_model_from_config(config, device=cuda_device, pretrained=False)
    with torch.no_grad():
        for n, prm in model.named_parameters():
            if "lora_B" in n:
                prm.copy_(torch.randn_like(prm) * 0.02)
            elif n.rsplit(".", 1)[-1].startswith("layer_scale"):
                prm.uniform_(0.1, 1.0)
    rng = np.random.default_rng(2)
    kps = rng.uniform(20, 230, (2, 24, 3)).astype(np.float32)
    kps[..., 2] = 2.0
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 3, 256, 256)).astype(np.float32)),
             "2d_keypoints": torch.from_numpy(kps),
             "z_coords": torch.from_numpy(rng.standard_normal((2, 24)).astype(np.float32))}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    names = ("backbone.stages.0.blocks.0.mlp.fc1.lora_A.weight",
             "backbone.stages.3.blocks.1.mlp.fc2.lora_B.weight",
             "backbone.head.heatmap_head.prediction.3.weight")
    out = {}
    for name, kernels, dtype in (("kernels", True, torch.bfloat16), ("plain", False, torch.bfloat16),
                                 ("f32", False, torch.float32)):
        m = copy.deepcopy(model)
        state, opt, part = create_train_state(m, config)
        step = prepare_batch(make_train_step(m, opt, part, kernels=kernels), (256, 48), dtype)
        block.reset_launches()
        _, stats = step(state, batch, 3e-5, 0)
        torch.cuda.synchronize()
        want = 10 if kernels else 0
        assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "fused_convffn": want,
                                  "fused_convffn_bwd": want}
        params = dict(m.named_parameters())
        out[name] = (stats, {n: params[n].grad.float() for n in names})
    (ks, kg), (ps, pg), (_, rg) = out["kernels"], out["plain"], out["f32"]
    for k in ("loss", "kp_loss", "z_loss", "weight"):
        assert abs(ks[k].item() - ps[k].item()) <= 1e-3 * abs(ps[k].item()), k

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    for n in names:
        assert torch.isfinite(kg[n]).all() and kg[n].abs().max() > 0, n
        tol = 2 * rel(pg[n], rg[n]) + 1e-2
        assert max(rel(kg[n], rg[n]), rel(kg[n], pg[n])) <= tol, n


# dinov2-large's width: D = 1024, 16 heads of 64, MLP 4096.
LARGE_D, LARGE_HIDDEN, LARGE_HEADS = 1024, 4096, 16
STREAM_NAMES = ("fused_attn_part_stream", "fused_mlp_part_stream")


def _stream_call(name, x, p, kernel):
    if name == "fused_attn_part_stream":
        ap = block.attn_params(p)
        return block.fused_attn_part_stream(x, ap, LARGE_HEADS, EPS) if kernel else \
            block.attn_part_stream_math(x, ap, num_heads=LARGE_HEADS, eps=EPS)
    mp = block.mlp_params(p)
    return block.fused_mlp_part_stream(x, mp, EPS) if kernel else \
        block.mlp_part_stream_math(x, mp, eps=EPS)


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [257, 57])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name", STREAM_NAMES)
def test_stream_kernel_matches_plain(cuda_device, name, batch, seq):
    """The weight-streamed halves at dinov2-large's width against their
    plain versions: one launch each, the attention half at the attention
    tolerance (relative Frobenius 3e-3, as fused_attn_part)."""
    p = _params(cuda_device, LARGE_D, LARGE_HIDDEN)
    x = _bf16(np.random.default_rng(batch + seq), (batch, seq, LARGE_D), cuda_device)
    block.reset_launches()
    got = _stream_call(name, x, p, kernel=True).float()
    want = _stream_call(name, x, p, kernel=False).float()
    torch.cuda.synchronize()
    attention = {"attn_fwd": 1} if name == "fused_attn_part_stream" else {}
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), name: 1, **attention}
    assert torch.isfinite(got).all()
    if name == "fused_attn_part_stream":
        _assert_attention_close(got, want, 3e-3)
    else:
        torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_mlp_dx_matches_plain_at_dinov2_large(cuda_device, batch):
    """fused_mlp_dx at D = 1024, MLP 4096: the LoRA layer's backward on
    dinov2-large (JAX's _mlp_stream_dx_kernel computes the same function)."""
    mp = block.mlp_params(_params(cuda_device, LARGE_D, LARGE_HIDDEN))
    rng = np.random.default_rng(batch)
    x2, dy = (_bf16(rng, (batch, 257, LARGE_D), cuda_device) for _ in range(2))
    block.reset_launches()
    got = block.fused_mlp_dx(x2, dy, mp, EPS).float()
    want = block.mlp_dx_math(x2, dy, mp, eps=EPS).float()
    torch.cuda.synchronize()
    assert block.LAUNCHES["fused_mlp_dx"] == 1
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
def test_stream_wrappers_refuse_what_they_do_not_take(cuda_device):
    p = _params(cuda_device, LARGE_D, LARGE_HIDDEN)
    x = torch.zeros((1, 257, LARGE_D), device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        block.fused_mlp_part_stream(x, block.mlp_params(p), EPS)        # f32 on CUDA
    with pytest.raises(ValueError, match="head width"):
        block.fused_attn_part_stream(x.to(torch.bfloat16), block.attn_params(p), 8, EPS)
    with pytest.raises(TypeError, match="w2"):
        bad = block.mlp_params(p)._replace(w2=p.w2.float())
        block.fused_mlp_part_stream(x.to(torch.bfloat16), bad, EPS)


@pytest.mark.cuda
def test_tiny_model_on_the_stream_route_kernels_match_plain(cuda_device, monkeypatch):
    """test/vit-tiny + LoRA with every block on the streamed route (forced):
    a forward launches each streamed half twice, a LoRA train step also
    fused_mlp_dx once; outputs and losses against the plain path."""
    from dino_pose_tpu_torch.models import vit

    monkeypatch.setattr(vit, "block_route", lambda *a, **k: "stream")
    config = {"model_name": "test/vit-tiny", "use_lora": True}
    model = registry.create_model_from_config(config, device=cuda_device)
    rng = np.random.default_rng(2)
    x = _bf16(rng, (2, 3, 224, 224), cuda_device)
    block.reset_launches()
    with torch.inference_mode():
        hm, z = model(x)
        hm_p, z_p = model(x, kernels=False)
    torch.cuda.synchronize()
    stream = {"fused_attn_part_stream": 2, "fused_mlp_part_stream": 2, "attn_fwd": 2}
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), **stream}
    for got, want in ((hm, hm_p), (z, z_p)):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 5e-2 * want.float().abs().max().item()
    kps = rng.uniform(20, 200, (2, 24, 3)).astype(np.float32)
    kps[..., 2] = 2.0
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 3, 224, 224)).astype(np.float32)),
             "2d_keypoints": torch.from_numpy(kps),
             "z_coords": torch.from_numpy(rng.standard_normal((2, 24)).astype(np.float32))}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    losses = {}
    for kernels in (True, False):
        m = copy.deepcopy(model)
        state, opt, part = create_train_state(m, config)
        step = prepare_batch(make_train_step(m, opt, part, kernels=kernels), (224, 48),
                             torch.bfloat16)
        block.reset_launches()
        _, losses[kernels] = step(state, batch, 3e-5, 0)
        torch.cuda.synchronize()
        want = {**stream, "fused_mlp_dx": 1} if kernels else {}
        assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), **want}
    for k in ("loss", "kp_loss", "z_loss"):
        got, want = losses[True][k].item(), losses[False][k].item()
        assert abs(got - want) <= 1e-3 * abs(want), k


# The trainable streamed halves of dinov2-base and -large: (D, heads, MLP).
STREAM_TRAIN_WIDTHS = {"dinov2-base": (768, 12, 3072), "dinov2-large": (1024, 16, 4096)}
STREAM_TRAIN_NAMES = ("fused_mlp_part_stream_train", "fused_mlp_bwd_stream",
                      "fused_attn_bwd_stream")


def _stream_train_call(name, x, dy, p, heads, kernel):
    """The wrapper or its plain version: a flat tuple of its outputs; the
    MLP backward reads the h2 of the plain forward."""
    ap, mp = block.attn_params(p), block.mlp_params(p)
    if name == "fused_mlp_part_stream_train":
        return (block.fused_mlp_part_stream_train(x, mp, EPS) if kernel
                else block.mlp_part_stream_train_math(x, mp, eps=EPS))
    if name == "fused_mlp_bwd_stream":
        h2 = block.mlp_part_stream_train_math(x, mp, eps=EPS)[1]
        dx, g = (block.fused_mlp_bwd_stream(x, dy, h2, mp, EPS) if kernel
                 else block.mlp_stream_bwd_math(x, dy, h2, mp, eps=EPS))
    else:
        dx, g = (block.fused_attn_bwd_stream(x, dy, ap, heads, EPS) if kernel
                 else block.attn_stream_bwd_math(x, dy, ap, num_heads=heads, eps=EPS))
    return (dx, *g)


@pytest.mark.cuda
@pytest.mark.parametrize("batch, seq", [(2, 257), (8, 257), (2, 57), (2, 401)])
@pytest.mark.parametrize("model", list(STREAM_TRAIN_WIDTHS))
@pytest.mark.parametrize("name", STREAM_TRAIN_NAMES)
def test_stream_train_kernel_matches_plain(cuda_device, name, model, batch, seq):
    """Every output of the trainable streamed halves at dinov2-base's and
    dinov2-large's widths, with a unit-scale seeded cotangent (at S = 401
    the attention backward takes the streamed flash pair): y and each
    backward's dx with a residual at 3e-2 abs/rel; the outputs with none
    (h2, the attention backward's dx) at the attention tolerance with
    relative Frobenius 3e-3; each f32 weight gradient within 2e-3 of its
    largest magnitude. One launch each, and no other."""
    d, heads, hidden = STREAM_TRAIN_WIDTHS[model]
    p = _params(cuda_device, d, hidden)
    rng = np.random.default_rng(batch + seq + d)
    x, dy = (_bf16(rng, (batch, seq, d), cuda_device) for _ in range(2))
    block.reset_launches()
    got = _stream_train_call(name, x, dy, p, heads, kernel=True)
    want = _stream_train_call(name, x, dy, p, heads, kernel=False)
    torch.cuda.synchronize()
    attention = {}
    if name == "fused_attn_bwd_stream":
        flash = block._ext.lib().dp_flash_backward(seq, d // heads)
        attention = {"flash_fwd": flash, "flash_bwd": flash, "attn_fwd": 1 - flash,
                     "attn_bwd": 1 - flash}
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), name: 1, **attention}
    no_residual = {"fused_mlp_part_stream_train": 1, "fused_attn_bwd_stream": 0}.get(name)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        assert g.shape == w.shape and torch.isfinite(g).all(), i
        if i == no_residual:
            _assert_attention_close(g, w, 3e-3)
        elif g.dim() == 3:
            torch.testing.assert_close(g, w, atol=3e-2, rtol=3e-2)
        else:
            err = (g - w).abs().max().item()
            assert err <= 2e-3 * w.abs().max().item(), (i, err, w.abs().max().item())


@pytest.mark.cuda
def test_stream_train_wrappers_refuse_what_they_do_not_take(cuda_device):
    """On a CUDA tensor the trainable streamed halves launch or raise: f32
    activations, an h2 of another shape and a head width the kernels do not
    take are refused, and nothing is launched."""
    d, heads, hidden = STREAM_TRAIN_WIDTHS["dinov2-large"]
    p = _params(cuda_device, d, hidden)
    ap, mp = block.attn_params(p), block.mlp_params(p)
    x = torch.zeros((1, 257, d), device=cuda_device)
    xb = x.to(torch.bfloat16)
    block.reset_launches()
    with pytest.raises(TypeError, match="bf16"):
        block.fused_mlp_part_stream_train(x, mp, EPS)
    with pytest.raises(TypeError, match="bf16"):
        block.fused_mlp_bwd_stream(x, x, x, mp, EPS)
    with pytest.raises(TypeError, match="bf16"):
        block.fused_attn_bwd_stream(x, x, ap, heads, EPS)
    with pytest.raises(ValueError, match="differ"):
        block.fused_mlp_bwd_stream(xb, xb, xb[:, :200].contiguous(), mp, EPS)
    with pytest.raises(ValueError, match="head width"):
        block.fused_attn_bwd_stream(xb, xb, ap, 8, EPS)
    with pytest.raises(TypeError, match="ls2"):
        block.fused_mlp_bwd_stream(xb, xb, xb, mp._replace(ls2=p.ls2.to(torch.bfloat16)), EPS)
    assert sum(block.LAUNCHES.values()) == 0


@pytest.mark.cuda
def test_tiny_model_unfreeze_on_the_stream_route_kernels_match_plain(cuda_device, monkeypatch):
    """test/vit-tiny unfreeze-2 with both blocks on the streamed training
    route (forced), one train step at batch 2: the kernels path launches
    two of each streamed training wrapper and nothing else, and never calls
    a plain version (they are made to raise); losses agree with the plain
    path to 1e-3, and each block gradient's error vs f32 is at most twice
    the plain bf16 path's plus 1e-2."""
    from dino_pose_tpu_torch.models import vit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    monkeypatch.setattr(vit, "block_route", lambda *a, **k: "stream")
    config = {"model_name": "test/vit-tiny", "use_lora": False, "unfreeze_last_n_layers": 2}
    model = registry.create_model_from_config(config, device=cuda_device)
    rng = np.random.default_rng(3)
    kps = rng.uniform(20, 200, (2, 24, 3)).astype(np.float32)
    kps[..., 2] = 2.0
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 3, 224, 224)).astype(np.float32)),
             "2d_keypoints": torch.from_numpy(kps),
             "z_coords": torch.from_numpy(rng.standard_normal((2, 24)).astype(np.float32))}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    names = [f"backbone.encoder.layer.{i}.{leaf}" for i in (0, 1) for leaf in (
        "attention.attention.query.weight", "attention.output.dense.bias",
        "layer_scale1.lambda1", "norm1.weight", "mlp.fc1.weight", "mlp.fc2.bias",
        "layer_scale2.lambda1", "norm2.weight")]
    plain = ("attn_part_stream_math", "mlp_part_stream_train_math", "mlp_stream_bwd_math",
             "attn_stream_bwd_math")
    out = {}
    for name, kernels, dtype in (("kernels", True, torch.bfloat16),
                                 ("plain", False, torch.bfloat16), ("f32", False, torch.float32)):
        m = copy.deepcopy(model)
        state, opt, part = create_train_state(m, config)
        step = prepare_batch(make_train_step(m, opt, part, kernels=kernels), (224, 48), dtype)
        with monkeypatch.context() as mp:
            if kernels:
                for fn in plain:
                    mp.setattr(block, fn, lambda *a, _fn=fn, **k: pytest.fail(f"{_fn} on the card"))
            block.reset_launches()
            _, stats = step(state, batch, 3e-5, 0)
            torch.cuda.synchronize()
        want = 2 if kernels else 0
        assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0),
                                  "fused_attn_part_stream": want,
                                  **dict.fromkeys(STREAM_TRAIN_NAMES, want),
                                  "attn_fwd": 2 * want, "attn_bwd": want}
        params = dict(m.named_parameters())
        out[name] = (stats, {n: params[n].grad.float() for n in names})
    (ks, kg), (ps, pg), (_, rg) = out["kernels"], out["plain"], out["f32"]
    for k in ("loss", "kp_loss", "z_loss", "weight"):
        assert abs(ks[k].item() - ps[k].item()) <= 1e-3 * abs(ps[k].item()), k

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    for n in names:
        assert torch.isfinite(kg[n]).all(), n
        tol = 2 * rel(pg[n], rg[n]) + 1e-2
        assert max(rel(kg[n], rg[n]), rel(kg[n], pg[n])) <= tol, n


# ---------------------------------------------------------------------------
# FastViT's opt-in arms: the depthwise conv, the combine + conv segment and
# the ConvFFN with the block residual.

# (C, H = W) of every fastvit_t8 and fastvit_sa12 stage at 256², ragged row
# counts (H = 24 and 56: not a multiple of the 8-row strip or of the TPU
# kernel's 16-row chunk) at stage 0's and stage 1's widths, and fastvit_ma36's
# C = 76 and a C = 20, whose tiles are staged a channel at a time (C not a
# multiple of 8).
DW_SHAPES = [(48, 64), (96, 32), (192, 16), (384, 8), (64, 64), (128, 32), (256, 16), (512, 8),
             (48, 24), (96, 56), (76, 16), (20, 24)]


def _dw_inputs(b, h, c, kk, device, seed=0):
    """bf16 x, y0, dx2bar, dy7bar (B, H, H, C); f32 a, b, bias and the HWIO
    conv kernel (kk, kk, 1, C)."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(
            device, dtype)

    acts = [n(b, h, h, c) for _ in range(4)]
    vecs = [torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32)).to(device)
            for lo, hi in ((0.8, 1.2), (-0.5, 0.5), (-0.1, 0.1))]
    return acts, vecs, n(kk, kk, 1, c, std=0.3, dtype=torch.float32)


def _assert_dw_close(got, want):
    """Activations at 3e-2 abs/rel; the f32 (C,) sums within 2e-3 of their
    largest magnitude (chip_smoke.py's GRAD_TOL)."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        assert g.shape == w.shape and torch.isfinite(g).all(), i
        if g.dim() == 4:
            torch.testing.assert_close(g, w, atol=3e-2, rtol=3e-2)
        else:
            err = (g - w).abs().max().item()
            assert err <= 2e-3 * w.abs().max().item(), (i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [3, 7])
@pytest.mark.parametrize("shape", DW_SHAPES, ids=lambda t: f"C{t[0]}-H{t[1]}")
def test_dwconv_kernels_match_plain(cuda_device, shape, kk):
    """fused_dw_conv, fused_combine_dw and fused_combine_dw_bwd at batch 2
    against their plain versions, one launch each; the backward twice gives
    the same bits (no atomics)."""
    from dino_pose_tpu_torch.ops import dwconv

    c, h = shape
    (x, y0, dx2, dy7), (a, b, bias), kern = _dw_inputs(2, h, c, kk, cuda_device, seed=c + h)
    block.reset_launches()
    got = (dwconv.fused_dw_conv(x, kern), *dwconv.fused_combine_dw(x, y0, a, b, bias, kern))
    bwd = dwconv.fused_combine_dw_bwd(x, y0, dx2, dy7, a, b, kern)
    torch.cuda.synchronize()
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "fused_dw_conv": 1,
                              "fused_combine_dw": 1, "fused_combine_dw_bwd": 1}
    want = (dwconv.dw_conv_math(x, kern), *dwconv.combine_dw_math(x, y0, a, b, bias, kern))
    _assert_dw_close(got, want)
    _assert_dw_close(bwd, dwconv.combine_dw_bwd_math(x, y0, dx2, dy7, a, b, kern))
    again = dwconv.fused_combine_dw_bwd(x, y0, dx2, dy7, a, b, kern)
    assert all(torch.equal(p, q) for p, q in zip(bwd, again))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_dwconv_kernels_at_t8_stage0_batches(cuda_device, batch):
    """The 7x7 conv and the segment at t8's stage 0 (C = 48, 64²) at the
    serving batches, where the wrapper's strips shrink to fill the card."""
    from dino_pose_tpu_torch.ops import dwconv

    (x, y0, dx2, dy7), (a, b, bias), kern = _dw_inputs(batch, 64, 48, 7, cuda_device, seed=batch)
    _assert_dw_close((dwconv.fused_dw_conv(x, kern),
                      *dwconv.fused_combine_dw(x, y0, a, b, bias, kern),
                      *dwconv.fused_combine_dw_bwd(x, y0, dx2, dy7, a, b, kern)),
                     (dwconv.dw_conv_math(x, kern),
                      *dwconv.combine_dw_math(x, y0, a, b, bias, kern),
                      *dwconv.combine_dw_bwd_math(x, y0, dx2, dy7, a, b, kern)))


# (C, H = W) of the plan's tilings: t8's stage 0 and 1 (at batch 1 tiled in
# columns as well as rows), W not a multiple of the column tile (24, 56, 20),
# C not a multiple of 8 (76, 20: staged a pair at a time), C > 64 (192:
# three channel groups).
TILING_SHAPES = [(48, 64), (96, 32), (48, 24), (96, 56), (76, 20), (20, 20), (192, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [3, 7])
@pytest.mark.parametrize("shape", TILING_SHAPES, ids=lambda t: f"C{t[0]}-H{t[1]}")
@pytest.mark.parametrize("batch", [1, 8])
def test_dwconv_tilings_match_plain(cuda_device, batch, shape, kk):
    """The three modes at the plan's batch-1 and batch-8 tilings against
    their plain versions, the conv also with ``flip=True`` (the taps read
    mirrored) against the conv on flipped taps; COMBINE_BWD twice gives the
    same bits."""
    from dino_pose_tpu_torch.ops import dwconv

    c, h = shape
    (x, y0, dx2, dy7), (a, b, bias), kern = _dw_inputs(batch, h, c, kk, cuda_device,
                                                       seed=batch + c + h + kk)
    block.reset_launches()
    got = (dwconv.fused_dw_conv(x, kern), dwconv.fused_dw_conv(x, kern, flip=True),
           *dwconv.fused_combine_dw(x, y0, a, b, bias, kern))
    bwd = dwconv.fused_combine_dw_bwd(x, y0, dx2, dy7, a, b, kern)
    torch.cuda.synchronize()
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "fused_dw_conv": 2,
                              "fused_combine_dw": 1, "fused_combine_dw_bwd": 1}
    _assert_dw_close(got, (dwconv.dw_conv_math(x, kern), dwconv.dw_conv_math(x, kern.flip(0, 1)),
                           *dwconv.combine_dw_math(x, y0, a, b, bias, kern)))
    _assert_dw_close(bwd, dwconv.combine_dw_bwd_math(x, y0, dx2, dy7, a, b, kern))
    again = dwconv.fused_combine_dw_bwd(x, y0, dx2, dy7, a, b, kern)
    assert all(torch.equal(p, q) for p, q in zip(bwd, again))


# The segment's pair_kernel<K, BWD> (TMA ring, f32 conv ring, the
# backward's sums reduced in the same launch) at t8's stage 0 and 1 shapes,
# the ragged H = 24 and 56, and C = 76 and 20 (zero-padded to a multiple of
# 8 by the wrappers), at every batch its plan treats differently.
PAIR_SHAPES = [(48, 64), (96, 32), (48, 24), (96, 56), (76, 16), (20, 24)]


def _pair_check(got, want, bwd_got, bwd_want, again):
    """x2 bit-equal to the plain combine's, the rest as _assert_dw_close, and
    a second backward call the same bits."""
    assert torch.equal(got[0], want[0])
    _assert_dw_close(got, want)
    _assert_dw_close(bwd_got, bwd_want)
    assert all(torch.equal(p, q) for p, q in zip(bwd_got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [3, 7])
@pytest.mark.parametrize("batch", [1, 8, 32, 128])
@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=lambda t: f"C{t[0]}-H{t[1]}")
def test_pair_kernels_match_plain(cuda_device, shape, batch, kk):
    """fused_combine_dw and fused_combine_dw_bwd against their plain versions,
    one launch each; x2 bit-equal, and the forward's second call and the
    backward's the same bits."""
    from dino_pose_tpu_torch.ops import dwconv

    c, h = shape
    (x, y0, dx2, dy7), (a, b, bias), kern = _dw_inputs(batch, h, c, kk, cuda_device,
                                                       seed=c + h + batch + kk)
    block.reset_launches()
    got = dwconv.fused_combine_dw(x, y0, a, b, bias, kern)
    bwd = dwconv.fused_combine_dw_bwd(x, y0, dx2, dy7, a, b, kern)
    torch.cuda.synchronize()
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "fused_combine_dw": 1,
                              "fused_combine_dw_bwd": 1}
    assert all(torch.equal(p, q) for p, q in zip(got, dwconv.fused_combine_dw(x, y0, a, b, bias,
                                                                              kern)))
    _pair_check(got, dwconv.combine_dw_math(x, y0, a, b, bias, kern), bwd,
                dwconv.combine_dw_bwd_math(x, y0, dx2, dy7, a, b, kern),
                dwconv.fused_combine_dw_bwd(x, y0, dx2, dy7, a, b, kern))


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [3, 7])
@pytest.mark.parametrize("batch", [1, 8, 128])
@pytest.mark.parametrize("shape", PAIR_SHAPES, ids=lambda t: f"C{t[0]}-H{t[1]}")
def test_pair_padding_is_x2s(cuda_device, shape, batch, kk):
    """With bias = 4 and a = b = 1 the combine of the zero-filled boxes
    outside the image would be 4, not x2's zero padding: x2 bit-equal and
    y7, its border rows and columns too, at the kernel tolerance
    (tests/test_torch_dwconv_plan.py shows such a leak moves them)."""
    from dino_pose_tpu_torch.ops import dwconv

    c, h = shape
    (x, y0, _, _), _, kern = _dw_inputs(batch, h, c, kk, cuda_device, seed=3 * c + h + kk)
    ones = torch.ones(c, device=cuda_device)
    x2, y7 = dwconv.fused_combine_dw(x, y0, ones, ones, 4 * ones, kern)
    wx2, wy7 = dwconv.combine_dw_math(x, y0, ones, ones, 4 * ones, kern)
    assert torch.equal(x2, wx2)
    _assert_dw_close((y7,), (wy7,))
    p = kk // 2
    border = torch.ones(h, h, dtype=torch.bool, device=cuda_device)
    border[p:h - p, p:h - p] = False
    torch.testing.assert_close(y7.float()[:, border], wy7.float()[:, border], atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
def test_pair_smem_matches_the_kernels(cuda_device):
    """_pair_smem (the plan's) equals the kernel's PairLayout (dp_pair_smem)
    at every plan the wrappers make here and around them."""
    from dino_pose_tpu_torch.ops import _ext, dwconv

    lib = _ext.lib()
    for kk in (3, 7):
        for bwd in (0, 1):
            for cg in (8, 24, 40, 48, 64):
                for twc in (8, 16, 24, 32, 64):
                    for stages in (2, 3, 4):
                        for c in (cg, 2 * cg, 96):
                            assert dwconv._pair_smem(kk, bool(bwd), cg, twc, stages, c) == \
                                lib.dp_pair_smem(kk, bwd, cg, twc, stages, c)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8, 128])
def test_dw_conv_unchanged_beside_the_pair(cuda_device, batch):
    """#24's kernel (dw_kernel<K, RB>, no longer sharing its template with
    the segment) at t8's stage shapes, k = 3 and 7, both ways, against its
    plain version, twice the same bits."""
    from dino_pose_tpu_torch.ops import dwconv

    for c, h in PAIR_SHAPES[:2]:
        for kk in (3, 7):
            (x, _, _, _), _, kern = _dw_inputs(batch, h, c, kk, cuda_device, seed=c + kk)
            for flip in (False, True):
                got = dwconv.fused_dw_conv(x, kern, flip)
                _assert_dw_close((got,), (dwconv.dw_conv_math(x, kern, flip),))
                assert torch.equal(got, dwconv.fused_dw_conv(x, kern, flip))


@pytest.mark.cuda
def test_dwconv_autograd_gives_the_conv_kernel_zero(cuda_device):
    """dw_conv_frozen and combine_dw_frozen on the card: dx (and dy0, da,
    db, dbias) through the kernels equal the plain path's within the
    tolerance, and the conv kernel's gradient is exactly zero."""
    from dino_pose_tpu_torch.ops import dwconv

    (x, y0, dx2, dy7), (a, b, bias), kern = _dw_inputs(2, 32, 96, 7, cuda_device, seed=5)
    grads = {}
    for kernels in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, y0, a, b, bias, kern)]
        y = dwconv.dw_conv_frozen(leaves[0], leaves[5], kernels=kernels)
        x2, y7 = dwconv.combine_dw_frozen(*leaves, kernels=kernels)
        torch.autograd.backward((y, x2, y7), (dy7, dx2, dy7))
        assert not leaves[5].grad.any()
        grads[kernels] = [t.grad for t in leaves[:5]]
    _assert_dw_close(grads[True], grads[False])


@pytest.mark.cuda
def test_dwconv_wrappers_refuse_what_they_do_not_take(cuda_device):
    from dino_pose_tpu_torch.ops import dwconv

    (x, y0, _, _), (a, b, bias), kern = _dw_inputs(1, 16, 48, 7, cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        dwconv.fused_dw_conv(x.float(), kern)
    with pytest.raises(ValueError, match="HWIO"):
        dwconv.fused_dw_conv(x, torch.zeros(5, 5, 1, 48, device=cuda_device))
    with pytest.raises(ValueError, match="vectors"):
        dwconv.fused_combine_dw(x, y0, a.double(), b, bias, kern)
    with pytest.raises(ValueError, match="no backward"):
        dwconv.fused_dw_conv(x.clone().requires_grad_(), kern)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("stage", CONVFFN_STAGES, ids=lambda t: f"C{t[0]}-H{t[1]}-S{t[2]}")
def test_convffn_res_matches_plain(cuda_device, stage, batch):
    c, h, s = stage
    y, p = _convffn_inputs(batch, s, c, h, 8, cuda_device, seed=c + batch + 1)
    res = torch.from_numpy(np.random.default_rng(c).standard_normal((batch, s, c))
                           .astype(np.float32)).to(cuda_device, torch.bfloat16)
    block.reset_launches()
    got = convffn.fused_convffn_res(y, res, p, 2.0).float()
    want = convffn.convffn_res_math(y, res, p, 2.0).float()
    torch.cuda.synchronize()
    assert block.LAUNCHES["fused_convffn_res"] == 1 and sum(block.LAUNCHES.values()) == 1
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
def test_fastvit_arms_train_step_kernels_match_plain(cuda_device, monkeypatch):
    """One fastvit_t8 + LoRA train step at 256², batch 8, with both arms on
    (``on``: t8's stages 0-1 take the pair and the conv arm): the launches
    of the arms' path (7 fused_dw_conv: the four mixers' 3x3 and the dx of
    the three whose input carries a gradient; 4 fused_combine_dw and 4
    fused_convffn_res; 3 fused_combine_dw_bwd; 6 fused_convffn in stages
    2-3; 10 fused_convffn_bwd), and the kernels against the plain path as
    test_fastvit_train_step_kernels_match_plain holds them. (At batch 2,
    with weights from the unseeded global generator, the heads' train-mode
    BatchNorms over two images moved kp_loss 1.07e-3 between the paths in
    one H100 run, past the 1e-3; at batch 8, over three seeds, an H100
    measured at most 1.5e-4 with both arms and 4.0e-4 on the default
    route. The weights are now seeded.)"""
    monkeypatch.setenv("DINO_POSE_TPU_DWCONV", "on")
    monkeypatch.setenv("DINO_POSE_TPU_STAGE_PAIR", "on")
    _t8_step_matches_plain(cuda_device, {
        "fused_dw_conv": 7, "fused_combine_dw": 4, "fused_convffn_res": 4,
        "fused_combine_dw_bwd": 3, "fused_convffn": 6, "fused_convffn_bwd": 10})


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fold", "branch"])
def test_fastvit_block_mode_train_step_kernels_match_plain(cuda_device, monkeypatch, mode):
    """One fastvit_t8 + LoRA train step at 256², batch 8, under JAX's
    ``DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS`` (``fold``: each MobileOne block,
    ReparamLargeKernelConv and RepMixer one conv folded from its batch
    statistics; ``branch``: the reference's branch math): every ConvFFN's
    forward and backward kernel and nothing else, and the kernels against
    the plain path as test_fastvit_arms_train_step_kernels_match_plain
    holds them."""
    monkeypatch.setenv("DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS", mode)
    _t8_step_matches_plain(cuda_device, {"fused_convffn": 10, "fused_convffn_bwd": 10})


def _t8_step_matches_plain(cuda_device, launches):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = {"model_name": "timm/fastvit_t8.apple_in1k", "use_lora": True}
    model = registry.create_model_from_config(config, device=cuda_device, pretrained=False)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    with torch.no_grad():
        for n, prm in model.named_parameters():
            if "lora_B" in n:
                prm.copy_(torch.randn(prm.shape, generator=gen, device=cuda_device) * 0.02)
            elif n.rsplit(".", 1)[-1].startswith("layer_scale"):
                prm.uniform_(0.1, 1.0, generator=gen)
    rng = np.random.default_rng(4)
    kps = rng.uniform(20, 230, (8, 24, 3)).astype(np.float32)
    kps[..., 2] = 2.0
    batch = {"image": torch.from_numpy(rng.standard_normal((8, 3, 256, 256)).astype(np.float32)),
             "2d_keypoints": torch.from_numpy(kps),
             "z_coords": torch.from_numpy(rng.standard_normal((8, 24)).astype(np.float32))}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    names = ("backbone.stages.0.blocks.0.mlp.fc1.lora_A.weight",
             "backbone.stages.1.blocks.1.mlp.fc2.lora_B.weight",
             "backbone.stages.3.blocks.1.mlp.fc2.lora_B.weight",
             "backbone.head.heatmap_head.prediction.3.weight")
    out = {}
    for name, kernels, dtype in (("kernels", True, torch.bfloat16), ("plain", False, torch.bfloat16),
                                 ("f32", False, torch.float32)):
        m = copy.deepcopy(model)
        state, opt, part = create_train_state(m, config)
        step = prepare_batch(make_train_step(m, opt, part, kernels=kernels), (256, 48), dtype)
        block.reset_launches()
        _, stats = step(state, batch, 3e-5, 0)
        torch.cuda.synchronize()
        want = launches if kernels else {}
        assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), **want}
        params = dict(m.named_parameters())
        out[name] = (stats, {n: params[n].grad.float() for n in names})
    (ks, kg), (ps, pg), (_, rg) = out["kernels"], out["plain"], out["f32"]
    for k in ("loss", "kp_loss", "z_loss", "weight"):
        assert abs(ks[k].item() - ps[k].item()) <= 1e-3 * abs(ps[k].item()), k

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    for n in names:
        assert torch.isfinite(kg[n]).all() and kg[n].abs().max() > 0, n
        tol = 2 * rel(pg[n], rg[n]) + 1e-2
        assert max(rel(kg[n], rg[n]), rel(kg[n], pg[n])) <= tol, n


# ---------------------------------------------------------------------------
# Tensor-parallel shards (one card) and the gated LayerNorm
# ---------------------------------------------------------------------------

# (D, heads, MLP width, tp): dinov2-base at tp = 2 (the slice's path),
# dinov2-large at tp = 2 and 4, dinov2-small at tp = 2.
TP_WIDTHS = {"base-tp2": (768, 12, 3072, 2), "large-tp2": (1024, 16, 4096, 2),
             "large-tp4": (1024, 16, 4096, 4), "small-tp2": (384, 6, 1536, 2)}


def _tp_inputs(key, batch, seq, device):
    d, heads, hidden, tp = TP_WIDTHS[key]
    p = _params(device, d, hidden)
    rng = np.random.default_rng(batch + seq + d + tp)
    x, dp = (_bf16(rng, (batch, seq, d), device) for _ in range(2))
    return x, dp, p, heads, tp


def _f32_params(pp):
    """A shard's (or a half's) parameters in f32, the matrices as the kernels
    read them (bf16-rounded): the plain f32 yardstick's weights."""
    return type(pp)(*(t.float() for t in pp))


def _assert_shard_close(got, want, want_f32, attention: bool):
    """A shard's output, which adds no bias or residual, against its plain
    version: elementwise at the attention tolerance (the attention half) or
    3e-2 abs/rel, and in relative Frobenius norm within the plain bf16
    path's own distance from the same function in f32 on the same inputs.
    The fixed 3e-3 of the attention halves does not carry over: without
    the bias the partials are smaller (the dinov2-base shard's o is 0.67 of
    the whole half's norm), and an H100 measured 3.04e-3 for the base
    shard's attention at batch 1, where the plain bf16 version itself sits
    6.0e-3 from f32 (CPU)."""
    got, want, want_f32 = got.float(), want.float(), want_f32.float()
    if attention:
        torch.testing.assert_close(got, want, atol=4e-3, rtol=2e-2)
    else:
        torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)
    fro = ((got - want).norm() / want.norm()).item()
    noise = ((want - want_f32).norm() / want_f32.norm()).item()
    assert fro <= noise, (fro, noise)


@pytest.mark.cuda
@pytest.mark.parametrize("batch, seq", [(1, 257), (8, 257), (2, 57)])
@pytest.mark.parametrize("key", list(TP_WIDTHS))
def test_tp_shard_kernels_match_plain(cuda_device, key, batch, seq):
    """Each shard's three kernels against their plain versions
    (``_assert_shard_close``), one launch each a shard, and the shards'
    all-reduce plus the bias against the whole half's plain version, within
    the whole half's own bf16 distance from f32."""
    from dino_pose_tpu_torch.core.mesh import MeshSpec, create_mesh
    from dino_pose_tpu_torch.ops import dispatch

    x, dp, p, heads, tp = _tp_inputs(key, batch, seq, cuda_device)
    ap, mp = block.attn_params(p), block.mlp_params(p)
    xf, dpf = x.float(), dp.float()
    with dispatch.scoped():
        mesh = create_mesh(MeshSpec(1, tp), device=cuda_device)
    attn, mlp = [], []
    for r in range(tp):
        pa = block.AttnPartialParams(*(t.contiguous() for t in block.shard_attn(ap, tp, r)))
        pm = block.MlpPartialParams(*(t.contiguous() for t in block.shard_mlp(mp, tp, r)))
        block.reset_launches()
        got = block.fused_attn_part_partial(x, pa, heads // tp, EPS)
        got_m = block.fused_mlp_part_partial(x, pm, EPS)
        got_dx = block.fused_mlp_partial_dx(x, dp, pm, EPS)
        torch.cuda.synchronize()
        assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "fused_attn_part_partial": 1,
                                  "fused_mlp_part_partial": 1, "fused_mlp_partial_dx": 1,
                                  "attn_fwd": 1}
        h = heads // tp
        _assert_shard_close(got, block.attn_part_math_partial(x, pa, num_heads=h, eps=EPS),
                            block.attn_part_math_partial(xf, _f32_params(pa), num_heads=h,
                                                         eps=EPS), attention=True)
        _assert_shard_close(got_m, block.mlp_part_math_partial(x, pm, eps=EPS),
                            block.mlp_part_math_partial(xf, _f32_params(pm), eps=EPS),
                            attention=False)
        _assert_shard_close(got_dx, block.mlp_partial_dx_math(x, dp, pm, eps=EPS),
                            block.mlp_partial_dx_math(xf, dpf, _f32_params(pm), eps=EPS),
                            attention=False)
        attn.append(got)
        mlp.append(got_m)
    o = mesh.all_reduce(attn) + ap.bo.to(torch.bfloat16)
    _assert_shard_close(o, block.attn_part_math(x, ap, num_heads=heads, eps=EPS),
                        block.attn_part_math(xf, _f32_params(ap), num_heads=heads, eps=EPS),
                        attention=True)
    h2 = mesh.all_reduce(mlp) + mp.bf2.to(torch.bfloat16)
    y = x + h2 * mp.ls2.to(torch.bfloat16)
    torch.testing.assert_close(y.float(), block.mlp_part_math(x, mp, eps=EPS).float(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["base-tp2", "large-tp2"])
def test_mlp_part_partial_frozen_autograd_on_card(cuda_device, key):
    """The shard's autograd function: forward fused_mlp_part_partial, x2's
    gradient fused_mlp_partial_dx's, also for dinov2-large at tp = 2, where
    JAX's backward takes its unfused vjp; a shard weight that requires grad
    is refused."""
    x, dp, p, _, tp = _tp_inputs(key, 2, 257, cuda_device)
    pm = block.MlpPartialParams(*(t.contiguous() for t in block.shard_mlp(block.mlp_params(p),
                                                                           tp, 1)))
    xg = x.clone().requires_grad_()
    block.reset_launches()
    y = block.mlp_part_partial_frozen(xg, pm, EPS)
    y.backward(dp)
    torch.cuda.synchronize()
    assert block.LAUNCHES["fused_mlp_part_partial"] == 1
    assert block.LAUNCHES["fused_mlp_partial_dx"] == 1
    with torch.no_grad():
        want = block.mlp_partial_dx_math(x, dp, pm, eps=EPS)
        want_f32 = block.mlp_partial_dx_math(x.float(), dp.float(), _f32_params(pm), eps=EPS)
    _assert_shard_close(xg.grad, want, want_f32, attention=False)
    with pytest.raises(ValueError, match="requires grad"):
        block.mlp_part_partial_frozen(xg, pm._replace(w1=pm.w1.clone().requires_grad_()), EPS)


@pytest.mark.cuda
def test_tp_wrappers_refuse_what_they_do_not_take(cuda_device):
    x, dp, p, heads, tp = _tp_inputs("small-tp2", 1, 57, cuda_device)
    ap, mp = block.attn_params(p), block.mlp_params(p)
    pa2, pm2 = block.shard_attn(ap, 2, 0), block.shard_mlp(mp, 2, 0)
    pa2 = block.AttnPartialParams(*(t.contiguous() for t in pa2))
    pm2 = block.MlpPartialParams(*(t.contiguous() for t in pm2))
    with pytest.raises(TypeError, match="bf16"):
        block.fused_attn_part_partial(x.float(), pa2, 3, EPS)
    with pytest.raises(TypeError, match="bf16"):
        block.fused_mlp_partial_dx(x.float(), dp.float(), pm2, EPS)
    with pytest.raises(ValueError, match="head width"):
        block.fused_attn_part_partial(x, pa2, 2, EPS)            # 192 / 2 = 96
    pa4 = block.AttnPartialParams(*(t.contiguous() for t in block.shard_attn(ap, 4, 0)))
    with pytest.raises(ValueError, match="multiples of 64 and 32"):
        block.fused_attn_part_partial(x, pa4, 1, EPS)            # 3 * 96 = 288 wide
    pm_bad = block.MlpPartialParams(*(t.contiguous() for t in block.shard_mlp(mp, 64, 0)))
    with pytest.raises(ValueError, match="multiples of 64 and 32"):
        block.fused_mlp_part_partial(x, pm_bad, EPS)             # 1536 / 64 = 24 wide
    with pytest.raises(ValueError, match="differ"):
        block.fused_mlp_partial_dx(x, dp[:, :8].contiguous(), pm2, EPS)


@pytest.mark.cuda
def test_dinov2_base_tp2_serving_launches(cuda_device):
    """dinov2-base + LoRA at 224², batch 2, under a tp = 2 mesh on the card:
    24 fused_attn_part_partial and 24 fused_mlp_part_partial launches a
    forward, each attention half's resident attention kernel, and nothing
    else, and the outputs within 5% of their largest
    magnitude of the plain path (chip_smoke.py's MODEL_REL_TOL)."""
    from dino_pose_tpu_torch.core.mesh import MeshSpec, create_mesh
    from dino_pose_tpu_torch.ops import dispatch

    model = registry.create_model_from_config(
        {"model_name": "facebook/dinov2-base", "use_lora": True}, seed=0, device=cuda_device,
        pretrained=False)
    x = _bf16(np.random.default_rng(0), (2, 3, 224, 224), cuda_device)
    with dispatch.scoped(), torch.inference_mode():
        create_mesh(MeshSpec(1, 2), device=cuda_device)
        block.reset_launches()
        hm, z = model(x)
        torch.cuda.synchronize()
        assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0),
                                  "fused_attn_part_partial": 24, "fused_mlp_part_partial": 24,
                                  "attn_fwd": 24}
        hm_p, z_p = model(x, kernels=False)
    for got, want in ((hm, hm_p), (z, z_p)):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 5e-2 * want.float().abs().max().item()


@pytest.mark.cuda
def test_tp2_lora_train_step_kernels_match_plain(cuda_device, monkeypatch):
    """A LoRA train step of test/vit-tiny widened to D = 128 (2 heads of 64,
    2 layers: each shard 64 wide at tp = 2, the smallest the kernels take)
    under a tp = 2 mesh, batch 4: 4 + 4 partial launches and 2 partial dx
    (the LoRA layer's two shards), and the losses against the plain path's
    to 1e-3 relative."""
    from dino_pose_tpu_torch.core.mesh import MeshSpec, create_mesh
    from dino_pose_tpu_torch.models import vit
    from dino_pose_tpu_torch.ops import dispatch

    monkeypatch.setitem(vit.VIT_PRESETS, "test/vit-tiny",
                        vit.ViTConfig(hidden_size=128, num_layers=2, num_heads=2, pos_grid=37))
    config = {"model_name": "test/vit-tiny", "use_lora": True, "lora_dropout": 0.0}
    model = registry.create_model_from_config(config, seed=0, device=cuda_device)
    rng = np.random.default_rng(5)
    kps = rng.uniform(20, 200, (4, 24, 3)).astype(np.float32)
    kps[..., 2] = 2.0
    batch = {"image": torch.from_numpy(rng.standard_normal((4, 3, 224, 224)).astype(np.float32)),
             "2d_keypoints": torch.from_numpy(kps),
             "z_coords": torch.from_numpy(rng.standard_normal((4, 24)).astype(np.float32))}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    stats = {}
    with dispatch.scoped():
        create_mesh(MeshSpec(1, 2), device=cuda_device)
        for kernels in (True, False):
            m = copy.deepcopy(model)
            state, opt, part = create_train_state(m, config)
            step = prepare_batch(make_train_step(m, opt, part, kernels=kernels), (224, 48),
                                 torch.bfloat16)
            block.reset_launches()
            _, stats[kernels] = step(state, batch, 3e-5, 0)
            torch.cuda.synchronize()
            want = ({"fused_attn_part_partial": 4, "fused_mlp_part_partial": 4,
                     "fused_mlp_partial_dx": 2, "attn_fwd": 4} if kernels else {})
            assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), **want}
    for k in ("loss", "kp_loss", "z_loss"):
        got, want = stats[True][k].item(), stats[False][k].item()
        assert abs(got - want) <= 1e-3 * abs(want), k


# (rows, D): dinov2-small's serving and train-step final norms, base's and
# large's widths, ragged row counts (1, 3, 65, 258: grids of one, two and
# four rows a block), and the block-a-row path (D > 1024).
LN_CASES = [(257, 384), (128 * 257, 384), (8 * 257, 768), (8 * 257, 1024), (1, 384), (3, 8),
            (1000, 1536), (5, 4096), (65, 384), (258, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows, d", LN_CASES)
def test_layernorm_kernel_matches_plain(cuda_device, rows, d, dtype):
    """fused_layernorm against layernorm_reference on the same card: f32 to
    1e-5 abs/rel (the f32 sums in another order, rsqrt's last bits); bf16
    within one ulp of the larger magnitude plus that 1e-5 elementwise (one
    rounding of f32 values that differ in their last bits, which is more
    than an ulp of a result that the bias cancels to near zero)."""
    from dino_pose_tpu_torch.ops import layernorm

    rng = np.random.default_rng(rows + d)
    x = torch.from_numpy((rng.standard_normal((rows, d)) * 3 + 1).astype(np.float32))
    x = x.to(cuda_device, getattr(torch, dtype))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32)).to(cuda_device)
    bias = torch.from_numpy(rng.uniform(-1, 1, d).astype(np.float32)).to(cuda_device)
    block.reset_launches()
    got = layernorm.fused_layernorm(x, scale, bias, EPS)
    want = layernorm.layernorm_reference(x, scale, bias, EPS)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and block.LAUNCHES["fused_layernorm"] == 1
    got, want = got.float(), want.float()
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert bool(((got - want).abs() <= ulp + 1e-5).all())


@pytest.mark.cuda
def test_layernorm_backward_and_refusals(cuda_device):
    """The backward is autograd of the plain formula (JAX's contract): the
    same gradients as layernorm_reference's; and the wrapper refuses widths
    and dtypes the kernel does not take."""
    from dino_pose_tpu_torch.ops import layernorm

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 70, 128)).astype(np.float32)).to(cuda_device)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 128).astype(np.float32)).to(cuda_device)
    bias = torch.zeros(128, device=cuda_device)
    grads = []
    for fn in (layernorm.fused_layernorm, layernorm.layernorm_reference):
        args = [t.clone().requires_grad_() for t in (x, scale, bias)]
        (fn(*args, EPS) ** 2).sum().backward()
        grads.append([a.grad for a in args])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="multiple of 8"):
        layernorm.fused_layernorm(torch.zeros(4, 100, device=cuda_device), scale[:100],
                                  bias[:100], EPS)
    with pytest.raises(ValueError, match="multiple of 8"):
        layernorm.fused_layernorm(torch.zeros(4, 8192, device=cuda_device),
                                  torch.ones(8192, device=cuda_device),
                                  torch.zeros(8192, device=cuda_device), EPS)
    with pytest.raises(TypeError, match="bf16 or f32"):
        layernorm.fused_layernorm(x.half(), scale, bias, EPS)


# The chains' GEMM alone (block.fused_gemm, wgmma fed by TMA): (M, K, N) at
# dinov2-small's qkv at batch 1 (the 64 x 64 plan), a ragged M = 2*57 at
# N = 576 (N % 128 != 0: 64 x 64), dinov2-large's tp = 4 out-projection at
# batch 128 (K = 256, 128 x 128), dinov2-small's fc1 at 128 (128 x 128), a
# batch-8 product of dinov2-base's width (64 x 128), dinov2-large's fc1 at
# batch 1, and K = 96 (a K tail of 32: test/vit-tiny's shard depth, widened).
GEMM_CASES = [(257, 384, 1152), (114, 768, 576), (128 * 257, 256, 1024), (128 * 257, 384, 1536),
              (8 * 257, 768, 768), (257, 1024, 4096), (114, 96, 128)]


def _gemm_operands(device, m, k, n, seed=3):
    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(
            device, dtype)

    return (t(m, k), t(k, n, std=k**-0.5),
            {"bias": t(n, std=0.05, dtype=torch.float32),
             "ls": torch.from_numpy(rng.uniform(0.1, 1, n).astype(np.float32)).to(device),
             "res": t(m, n)})


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEMM_CASES, ids=lambda s: "M{}-K{}-N{}".format(*s))
@pytest.mark.parametrize("epi", block.EPILOGUES)
def test_gemm_matches_plain(cuda_device, epi, shape):
    """fused_gemm against gemm_math for every epilogue: elementwise at 3e-2
    abs/rel and within 3e-3 in relative Frobenius norm (one-ulp flips from
    the f32 summation order; a wrong tile or a dropped K tail moves the
    whole tensor), and two runs give the same bits (no split K)."""
    m, k, n = shape
    a, w, kw = _gemm_operands(cuda_device, m, k, n)
    block.reset_launches()
    got = block.fused_gemm(a, w, epi, **kw)
    again = block.fused_gemm(a, w, epi, **kw)
    want = block.gemm_math(a, w, epi, **kw)
    torch.cuda.synchronize()
    assert block.LAUNCHES["fused_gemm"] == 2
    got, again, want = ((t,) if torch.is_tensor(t) else t for t in (got, again, want))
    assert len(got) == len(want) == (2 if epi in block.PAIRED else 1)
    for g, h, r in zip(got, again, want):
        assert torch.equal(g, h)
        g, r = g.float(), r.float()
        torch.testing.assert_close(g, r, atol=3e-2, rtol=3e-2)
        assert ((g - r).norm() / r.norm()).item() <= 3e-3


@pytest.mark.cuda
def test_gemm_reaches_every_tile_plan(cuda_device):
    """The plan by block count on the card's SMs: 128 x 128 where those
    tiles fill the card, 64 x 128 where only 64-row ones do, 64 x 64 at
    batch 1 and where N % 128 != 0; GEMM_CASES reach all three."""
    plans = {block._ext.lib().dp_gemm_plan(m, n) for m, _, n in GEMM_CASES}
    assert plans == {0, 1, 2}
    assert block._ext.lib().dp_gemm_plan(128 * 257, 576) == 2


@pytest.mark.cuda
def test_gemm_refuses_what_it_does_not_take(cuda_device):
    a, w, kw = _gemm_operands(cuda_device, 64, 128, 128)
    with pytest.raises(ValueError, match="multiple of 64"):
        block.fused_gemm(a, w[:, :96].contiguous(), "none")
    with pytest.raises(ValueError, match="needs bias"):
        block.fused_gemm(a, w, "bias")
    with pytest.raises(TypeError, match="bf16"):
        block.fused_gemm(a.float(), w, "none")
    with pytest.raises(ValueError, match="unknown epilogue"):
        block.fused_gemm(a, w, "gelu")


# The chains' backward products alone (block.fused_gemm_nt, fused_gemm_tn,
# wgmma fed by TMA). gemm_nt (M, K, N): dinov2-small's dh1b at batch 1 (the
# 64 x 64 plan), a ragged M = 2*57 at N = 576 (N % 128 != 0), dinov2-base's
# dctx at batch 8 (64 x 128), dinov2-small's dm and dinov2-large's da at
# batch 128 (128 x 128), K = 96 (a K tail of 32).
GEMM_NT_CASES = [(257, 384, 1536), (114, 768, 576), (8 * 257, 768, 768), (128 * 257, 1536, 384),
                 (128 * 257, 3072, 1024), (114, 96, 128)]
# gemm_tn (M, K_in, N): dinov2-small's dW1 at batch 1 (one split), dWo at
# batch 128 (many splits, 128 x 128 tiles), dinov2-base's dWo at batch 8,
# dinov2-large's dWqkv at batch 128, K_in = 192 with N = 576 (64 x 64
# tiles) and K_in = 64 (64 x 128) at ragged M.
GEMM_TN_CASES = [(257, 384, 1536), (128 * 257, 384, 384), (8 * 257, 768, 768),
                 (128 * 257, 1024, 3072), (114, 192, 576), (2 * 57 + 1000, 64, 256)]


def _check_bwd_product(got, again, want, sums):
    """Two runs with the same bits; bf16 and f32 products at 3e-2 abs/rel
    and 3e-3 relative Frobenius (test_gemm_matches_plain), f32 sums over
    the rows (weight gradients, column sums) within 2e-3 of their largest
    magnitude (the block backward's weight-gradient tolerance)."""
    got, again, want = ((t,) if torch.is_tensor(t) else t for t in (got, again, want))
    assert len(got) == len(want)
    for i, (g, h, r) in enumerate(zip(got, again, want)):
        assert torch.equal(g, h)
        assert g.dtype == r.dtype and g.shape == r.shape
        g, r = g.float(), r.float()
        if i in sums:
            assert (g - r).abs().max().item() <= 2e-3 * r.abs().max().item()
        else:
            torch.testing.assert_close(g, r, atol=3e-2, rtol=3e-2)
            assert ((g - r).norm() / r.norm()).item() <= 3e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEMM_NT_CASES, ids=lambda s: "M{}-K{}-N{}".format(*s))
@pytest.mark.parametrize("epi", block.EPILOGUES_NT)
def test_gemm_nt_matches_plain(cuda_device, epi, shape):
    """fused_gemm_nt against gemm_nt_math for every epilogue, bare, with the
    scaled operand (scale_rows first) and with the column sums."""
    m, k, n = shape
    a, wt, kw = _gemm_operands(cuda_device, m, k, n)
    w = wt.t().contiguous()  # (N, K): the forward weight as stored
    aux = kw["res"]
    scale = torch.from_numpy(np.random.default_rng(4).uniform(0.5, 1.5, k).astype(np.float32))
    scale = scale.to(cuda_device)
    for extra in ({}, {"scale": scale}, {"colsum": True}, {"scale": scale, "colsum": True}):
        block.reset_launches()
        got = block.fused_gemm_nt(a, w, epi, aux=aux, **extra)
        again = block.fused_gemm_nt(a, w, epi, aux=aux, **extra)
        want = block.gemm_nt_math(a, w, epi, aux=aux, **extra)
        torch.cuda.synchronize()
        assert block.LAUNCHES["fused_gemm_nt"] == 2
        _check_bwd_product(got, again, want, sums=(1,))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEMM_TN_CASES, ids=lambda s: "M{}-Kin{}-N{}".format(*s))
def test_gemm_tn_matches_plain(cuda_device, shape):
    """fused_gemm_tn against gemm_tn_math, bare, with the scaled cotangent
    and with its column sums; the weight gradient and the sums are f32 sums
    over every row, fixed-order across the row splits."""
    m, k_in, n = shape
    a, _, kw = _gemm_operands(cuda_device, m, k_in, n)
    g = kw["res"]
    scale = kw["ls"]
    for extra in ({}, {"scale": scale}, {"gsum": True}, {"scale": scale, "gsum": True}):
        block.reset_launches()
        got = block.fused_gemm_tn(a, g, **extra)
        again = block.fused_gemm_tn(a, g, **extra)
        want = block.gemm_tn_math(a, g, **extra)
        torch.cuda.synchronize()
        assert block.LAUNCHES["fused_gemm_tn"] == 2
        _check_bwd_product(got, again, want, sums=(0, 1))


@pytest.mark.cuda
def test_gemm_tn_reaches_every_plan_and_split(cuda_device):
    """GEMM_TN_CASES reach one split and many, and all three tile plans, and
    the wrapper's split policy sizes its tiles as the kernel's tn_plan."""
    splits = {block._splits(m, k, n) for m, k, n in GEMM_TN_CASES}
    assert 1 in splits and max(splits) > 4
    plans = {block._ext.lib().dp_gemm_tn_plan(k, n) for _, k, n in GEMM_TN_CASES}
    assert plans == {0, 1, 2}
    for _, k, n in GEMM_TN_CASES:
        tm, tn = block._tn_tile(k, n)
        assert block._ext.lib().dp_gemm_tn_plan(k, n) == {(128, 128): 0, (64, 128): 1,
                                                          (64, 64): 2}[(tm, tn)]
    nt_plans = {block._ext.lib().dp_gemm_plan(m, n) for m, _, n in GEMM_NT_CASES}
    assert nt_plans == {0, 1, 2}


@pytest.mark.cuda
def test_gemm_bwd_refuses_what_it_does_not_take(cuda_device):
    a, wt, kw = _gemm_operands(cuda_device, 64, 128, 128)
    w = wt.t().contiguous()
    with pytest.raises(ValueError, match="multiple of 64"):
        block.fused_gemm_nt(a, w[:96].contiguous(), "bf16")
    with pytest.raises(ValueError, match="needs aux"):
        block.fused_gemm_nt(a, w, "gelu_grad")
    with pytest.raises(TypeError, match="bf16"):
        block.fused_gemm_nt(a.float(), w, "bf16")
    with pytest.raises(ValueError, match="unknown epilogue"):
        block.fused_gemm_nt(a, w, "f16")
    with pytest.raises(ValueError, match="scale"):
        block.fused_gemm_nt(a, w, "bf16", scale=kw["ls"][:64])
    with pytest.raises(ValueError, match="multiple of 64"):
        block.fused_gemm_tn(a[:, :96].contiguous(), kw["res"])
    with pytest.raises(ValueError, match="a \\(M, K_in\\) and g \\(M, N\\)"):
        block.fused_gemm_tn(a, kw["res"][:32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        block.fused_gemm_tn(a, kw["res"].t())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [384, 768, 1024])
def test_ln_rows_matches_plain_rounding(cuda_device, d):
    """The chains' LayerNorm rows (what every first product reads) against
    the plain LayerNorm's one bf16 rounding: the statistics are summed in
    another order and rsqrtf is not 1/sqrt to the last bit, so a value on a
    bf16 rounding boundary may round the other way; every element within
    one ulp of the larger magnitude plus 1e-5 (an output near zero is the
    difference of terms near one, test_layernorm_kernel_matches_plain's
    bound), and at least 99.9% with the same bits."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy((rng.standard_normal((128 * 257, d)) * 3 + 1).astype(np.float32))
    x = x.to(cuda_device, torch.bfloat16)
    g = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy((rng.standard_normal(d) * 0.1).astype(np.float32)).to(cuda_device)
    block.reset_launches()
    got = block.ln_rows(x, g, b, EPS)
    want = block._ln_fwd(x, g, b, EPS)[0]
    torch.cuda.synchronize()
    assert block.LAUNCHES["ln_rows"] == 1
    gf, wf = got.float(), want.float()
    mag = torch.maximum(gf.abs(), wf.abs()).clamp_min(1e-30)
    assert bool(((gf - wf).abs() <= torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5).all())
    assert (got != want).float().mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [6, 12, 16])
@pytest.mark.parametrize("streamed", [False, True])
def test_packed_attention_matches_plain(cuda_device, streamed, heads):
    """The chains' attention step at S = 257 on a packed qkv, each kernel
    (resident and streamed) at chip_smoke.py's attention tolerance."""
    rng = np.random.default_rng(heads)
    qkv = torch.from_numpy(rng.standard_normal((2, 257, 3 * heads * 64)).astype(np.float32))
    qkv = qkv.to(cuda_device, torch.bfloat16)
    got = block.packed_attention(qkv, heads, streamed=streamed).float()
    want = block._heads_attention(qkv, heads).float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert bool((err <= 4e-3 + 2e-2 * want.abs()).all())
    assert ((got - want).norm() / want.norm()).item() <= 5e-4


# The resident attention pair at every ROUTE_HEADS shape of chip_smoke.py
# (dinov2-small, -base, -large and the tp shards' heads, S = 257) at B = 1
# and 8, and at ragged S at both head widths: up to the resident route's
# limits, 320 (304 backward) at dh = 64 and 400 (384) at dh = 32.
ROUTE_HEADS = (6, 12, 16, 8, 4)
CORE_SEQS = {64: (1, 63, 65, 200, 257, 304, 320), 32: (1, 63, 65, 200, 257, 304, 320, 384, 400)}
CORE_CASES = ([(b, h, 257, 64) for h in ROUTE_HEADS for b in (1, 8)]
              + [(2, 12 if dh == 32 else 6, s, dh) for dh, seqs in CORE_SEQS.items() for s in seqs])


def _assert_core_close(got, want):
    """chip_smoke.py's attention tolerance with the flash pair's relative
    Frobenius limit; a zero reference (dq and dk at S = 1) to its absolute
    part."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    if not bool(want.any()):
        assert bool((got.abs() <= 4e-3).all())
        return
    assert bool(((got - want).abs() <= 4e-3 + 2e-2 * want.abs()).all())
    assert ((got - want).norm() / want.norm()).item() <= 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("batch, heads, seq, dh", CORE_CASES,
                         ids=lambda c: str(c))
def test_attention_core_matches_plain(cuda_device, batch, heads, seq, dh):
    """The resident forward (attn_fwd_kernel) and backward (attn_bwd_dq_kernel
    + attn_bwd_dkv_kernel) on a packed qkv against the plain versions: ctx,
    and dq, dk, dv with a unit-scale cotangent, where the route takes the
    backward; one launch each."""
    rng = np.random.default_rng(batch * 1000 + seq + dh)
    qkv = _bf16(rng, (batch, seq, 3 * heads * dh), cuda_device)
    dctx = _bf16(rng, (batch, seq, heads * dh), cuda_device)
    block.reset_launches()
    got = block.packed_attention(qkv, heads, streamed=False)
    torch.cuda.synchronize()
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "packed_attention": 1,
                              "attn_fwd": 1}
    _assert_core_close(got, block._heads_attention(qkv, heads))
    if block._ext.lib().dp_flash_backward(seq, dh):
        with pytest.raises(ValueError, match="resident backward"):
            block.packed_attention_bwd(qkv, dctx, heads, streamed=False)
        return
    block.reset_launches()
    got = block.packed_attention_bwd(qkv, dctx, heads, streamed=False)
    again = block.packed_attention_bwd(qkv, dctx, heads, streamed=False)
    torch.cuda.synchronize()
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "packed_attention_bwd": 2,
                              "attn_bwd": 2}
    assert torch.equal(got, again)  # no atomics: the same bits every run
    want = block.packed_attention_bwd_math(qkv, dctx, heads)
    for g, w in zip(got.chunk(3, -1), want.chunk(3, -1)):
        _assert_core_close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("streamed", [False, True])
def test_packed_attention_bwd_launches_and_refusals(cuda_device, streamed):
    """packed_attention_bwd at dinov2-small's S = 257: the streamed route
    runs a flash forward (for the statistics) and the flash pair; both
    routes refuse what they do not take."""
    rng = np.random.default_rng(5)
    qkv = _bf16(rng, (2, 257, 3 * 384), cuda_device)
    dctx = _bf16(rng, (2, 257, 384), cuda_device)
    block.reset_launches()
    got = block.packed_attention_bwd(qkv, dctx, 6, streamed=streamed)
    torch.cuda.synchronize()
    want = ({"flash_fwd": 1, "flash_bwd": 1} if streamed else {"attn_bwd": 1})
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0), "packed_attention_bwd": 1,
                              **want}
    for g, w in zip(got.chunk(3, -1), block.packed_attention_bwd_math(qkv, dctx, 6).chunk(3, -1)):
        _assert_core_close(g, w)
    with pytest.raises(ValueError, match="dctx"):
        block.packed_attention_bwd(qkv, dctx[:, :128].contiguous(), 6, streamed=streamed)
    with pytest.raises(TypeError, match="bf16"):
        block.packed_attention_bwd(qkv.float(), dctx, 6, streamed=streamed)
    with pytest.raises(ValueError, match="head width"):
        block.packed_attention_bwd(qkv, dctx, 5, streamed=streamed)


# The chains' attention route as the first resident kernels' shared memory
# set it: resident forward up to S = 320 (dh 64) and 400 (dh 32), resident
# backward up to 304 and 384. The new kernels take the same shapes.
ROUTE_PINS = {64: {257: (0, 0), 304: (0, 0), 305: (0, 1), 320: (0, 1), 321: (1, 1),
                   1297: (1, 1)},
              32: {257: (0, 0), 384: (0, 0), 385: (0, 1), 400: (0, 1), 401: (1, 1),
                   1297: (1, 1)}}


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 32])
def test_attention_route_is_pinned(cuda_device, dh):
    lib = block._ext.lib()
    for seq, (fwd, bwd) in ROUTE_PINS[dh].items():
        assert (lib.dp_flash_forward(seq, dh), lib.dp_flash_backward(seq, dh)) == (fwd, bwd), seq


def _definition(src: str, head: str) -> str:
    """The text of the definition in ``src`` that starts with ``head``: up to
    the closing brace at the start of a line."""
    start = src.index(head)
    return src[start:src.index("\n}\n", start)]


@pytest.mark.cuda
def test_convffn_kernels_are_wgmma(cuda_device):
    """convffn_kernels.cu holds no WMMA: its products (the rank terms and the
    weight-gradient reductions too, m64n8k16) are wgmma.mma_async, fed by
    TMA tile loads."""
    import pathlib

    src = (pathlib.Path(convffn.__file__).parent / "csrc" / "convffn_kernels.cu").read_text()
    assert "wmma::" not in src and "<mma.h>" not in src
    assert "wgmma.mma_async.sync.aligned.m64n8k16" in _definition(src, "void wgmma_n8(")
    body = _definition(src, "\nconvffn_kernel(")
    for call in ("wgmma_n64<", "wgmma_n8<", "tma_load("):
        assert call in body, call


@pytest.mark.cuda
def test_attention_kernels_are_wgmma(cuda_device):
    """The resident attention kernels issue their products as wgmma (the
    helpers they call, in block_kernels.cu or the shared hopper.cuh, hold
    wgmma.mma_async, P and dS from registers through wgmma_rs), and no WMMA
    call is left in block_kernels.cu."""
    import pathlib

    csrc = pathlib.Path(block.__file__).parent / "csrc"
    src = (csrc / "block_kernels.cu").read_text()
    assert "wmma::" not in src and "<mma.h>" not in src
    src += (csrc / "hopper.cuh").read_text()
    for helper in ("wgmma_rs_n64(", "wgmma_rs_n32(", "wgmma_n16(", "wgmma_n64("):
        assert "wgmma.mma_async" in _definition(src, f"void {helper}"), helper
    for name in ("attn_fwd_kernel(", "attn_bwd_dq_kernel(", "attn_bwd_dkv_kernel("):
        body = _definition(src, f"\n{name}")
        assert "wgmma_rs<DH>" in body, name
        assert "row_scores<" in body or "issue_nt<" in body, name


def _write_coco(root, n, seed):
    """``n`` seeded JPEGs (portrait and landscape) and a COCO keypoint file
    with mixed visibility under ``root``; returns (images dir, annotation)."""
    import json

    from PIL import Image

    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    for i in range(n):
        h, w = ((240, 320), (640, 480), (333, 500))[i % 3]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / "images" / f"{i}.jpg")
        kps = np.stack([rng.uniform(0.15 * w, 0.85 * w, 24), rng.uniform(0.15 * h, 0.85 * h, 24),
                        rng.choice([0.0, 1.0, 2.0], 24)], 1)
        images.append({"id": i, "file_name": f"{i}.jpg", "width": w, "height": h})
        annotations.append({"id": i, "image_id": i, "num_keypoints": 24,
                            "keypoints": kps.reshape(-1).tolist(),
                            "keypoints_z": rng.uniform(-40, 40, 24).tolist()})
    (root / "ann.json").write_text(json.dumps({"images": images, "annotations": annotations}))
    return str(root / "images"), str(root / "ann.json")


@pytest.mark.cuda
def test_warp_batch_on_cuda_matches_cpu(cuda_device, tmp_path):
    """The device warp (plain torch ops) of a loader batch on the card
    against the same function on the CPU: 1e-5 abs in normalised units."""
    from dino_pose_tpu_torch.config import get_default_configs
    from dino_pose_tpu_torch.data.dataset import create_dataloaders
    from dino_pose_tpu_torch.data.warp import WARP_KEYS, warp_batch

    images, ann = _write_coco(tmp_path, 8, seed=0)
    _, _, preproc, model_cfg = get_default_configs()
    loader = create_dataloaders(preproc, model_cfg, images, ann, batch_size=8, num_workers=2,
                                render_targets=False, device_warp=True)
    batch = [torch.from_numpy(next(iter(loader))[k]) for k in WARP_KEYS]
    got = warp_batch(*(a.to(cuda_device) for a in batch))
    assert got.device.type == "cuda" and got.shape == (8, 3, 224, 224)
    assert (got.cpu() - warp_batch(*batch)).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_fit_two_steps_on_cuda(cuda_device, tmp_path):
    """``fit`` on the card with test/vit-tiny + LoRA: two train steps through
    the kernels (1 fused_block, 1/1/1 halves and 1 fused_mlp_dx a step), a
    validation batch and the PCKh evaluations (1 fused_block and 1/1 halves a
    forward), the checkpoint reloaded on the card."""
    from dino_pose_tpu_torch.config import get_default_configs
    from dino_pose_tpu_torch.io.checkpoint import load_model_smart
    from dino_pose_tpu_torch.train.loop import fit

    (ti, ta), (vi, va) = _write_coco(tmp_path / "train", 8, 1), _write_coco(tmp_path / "val", 4, 2)
    d, t, p, m = get_default_configs()
    d.update(train_images_dir=ti, train_annotation_json=ta, val_images_dir=vi,
             val_annotation_json=va)
    t.update(batch_size=4, num_epochs=1, save_freq=1, checkpoint_dir=str(tmp_path / "ck"),
             multiprocessing_num=2)
    m.update(model_name="test/vit-tiny")
    block.reset_launches()
    history = fit(d, t, p, m, progress=False)
    torch.cuda.synchronize()
    steps, forwards = 2, 1 + len(history["pckh"])
    assert history["state"].step == steps and np.isfinite(history["train_loss"]).all()
    assert block.LAUNCHES == {**dict.fromkeys(block.LAUNCHES, 0),
                              "fused_block": steps + forwards, "fused_attn_part": steps + forwards,
                              "fused_mlp_part": steps + forwards, "fused_mlp_dx": steps,
                              "attn_fwd": 2 * (steps + forwards)}
    model = load_model_smart(str(tmp_path / "ck" / "final_model.pth"))
    assert next(model.parameters()).device.type == "cuda"
    for a, b in zip(model.state_dict().values(), history["model"].state_dict().values()):
        assert torch.equal(a, b)


# A fresh interpreter (so that the ConvFFN's tensor-map cache is cold) makes
# the operands on its main thread, leaves freed blocks in the caching
# allocator's pools, then calls the wrapper on a new thread, whose first CUDA
# work that launch is, and again on the main thread.
_FRESH_THREAD = r"""
import json, sys, threading
import torch
from dino_pose_tpu_torch.ops import block, convffn
from test_torch_cuda import _convffn_inputs, _gemm_operands

dev = torch.device("cuda")
if sys.argv[1] == "fused_gemm":
    a, w, kw = _gemm_operands(dev, 257, 384, 1152)
    call = lambda: block.fused_gemm(a, w, "bias_gelu", **kw)
elif sys.argv[1] == "packed_attention":
    qkv = torch.randn(2, 257, 3 * 384, generator=torch.Generator().manual_seed(5)).to(
        dev, torch.bfloat16)
    call = lambda: block.packed_attention(qkv, 6, streamed=False)
else:
    y, p = _convffn_inputs(1, 1024, 96, 288, 8, dev, seed=5)
    call = lambda: convffn.fused_convffn(y, p, 2.0)
for n in (1 << 19, 1 << 26):
    del_me = torch.empty(n, dtype=torch.uint8, device=dev)
    del del_me
torch.cuda.synchronize()
box = {}

def run():
    try:
        box["out"] = call()
        torch.cuda.synchronize()
    except Exception as e:  # reported to the test, which fails on it
        box["err"] = repr(e)

thread = threading.Thread(target=run)
thread.start()
thread.join(300)
main = call()
torch.cuda.synchronize()
print(json.dumps({"alive": thread.is_alive(), "err": box.get("err"),
                  "equal": "out" in box and torch.equal(box["out"], main)}))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["fused_gemm", "fused_convffn", "packed_attention"])
def test_tensor_map_encoder_on_a_fresh_thread(cuda_device, wrapper):
    """A launch that is a new host thread's first CUDA work encodes its TMA
    tensor maps (``dp_hopper::encode_tiles``: directly from block_kernels.cu
    for fused_gemm, through convffn_kernels.cu's cache, cold, for
    fused_convffn; the resident attention's 3-D ``encode_heads``) and gives
    the same bits as the call on the main thread. Without a context bound on
    that thread the encode fails and the launch returns CUDA error 1."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    here = pathlib.Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": f"{here.parent}:{here}"}
    proc = subprocess.run([sys.executable, "-c", _FRESH_THREAD, wrapper], cwd=here.parent,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"alive": False, "err": None, "equal": True}


# The CLIs on the card with test/vit-tiny + LoRA (one fused_block, the LoRA
# layer's two halves and two resident attention steps a forward) and
# fastvit_t8 (ten ConvFFN launches a forward).
TINY_LORA_FWD = {"fused_block": 1, "fused_attn_part": 1, "fused_mlp_part": 1, "attn_fwd": 2}
TINY_FWD = {"fused_block": 2, "attn_fwd": 2}
T8_FWD = {"fused_convffn": 10}


def _launches(*per_forward: tuple[dict, int]) -> dict:
    want = dict.fromkeys(block.LAUNCHES, 0)
    for per, n in per_forward:
        for k, v in per.items():
            want[k] += n * v
    return want


@pytest.fixture
def tiny_pth(cuda_device, tmp_path):
    """A test/vit-tiny + LoRA checkpoint written from the card, its LoRA B
    non-zero."""
    from dino_pose_tpu_torch.io.checkpoint import save_checkpoint

    model = registry.create_model_from_config({"model_name": "test/vit-tiny", "use_lora": True},
                                              device=cuda_device)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_B"):
                p.copy_(torch.randn(p.shape, generator=gen).to(p.device) * 0.02)
    path = tmp_path / "tiny.pth"
    save_checkpoint(path, model, epoch=5, train_loss=0.3, valid_loss=0.4)
    return str(path), model


@pytest.mark.cuda
def test_cli_model_info_on_cuda(tiny_pth, tmp_path, capsys):
    from dino_pose_tpu_torch.cli import model_info

    block.reset_launches()
    model_info.main(["--checkpoint", tiny_pth[0]])
    model_info.main(["--list-checkpoints", str(tmp_path)])
    out = capsys.readouterr().out
    assert "Dinov2PoseModelLoRA" in out and "epoch: 5" in out and "tiny.pth" in out
    assert block.LAUNCHES == _launches()


@pytest.mark.cuda
def test_cli_export_on_cuda(tiny_pth, tmp_path, capsys):
    """One self-check forward an export; the exported file serves the same
    bits as the source model on the card."""
    from dino_pose_tpu_torch.cli import export_coreml
    from dino_pose_tpu_torch.io.checkpoint import load_model_smart

    out = tmp_path / "out.pth"
    block.reset_launches()
    export_coreml.main(["-c", tiny_pth[0], "-o", str(out)])
    torch.cuda.synchronize()
    assert block.LAUNCHES == _launches((TINY_LORA_FWD, 1))
    assert "Self-check forward: heatmaps (1, 24, 48, 48), depths (1, 24)" in capsys.readouterr().out
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(0)).to(
        "cuda", torch.bfloat16)
    exported = load_model_smart(str(out))
    with torch.inference_mode():
        got = exported(x)
        want = tiny_pth[1](x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    export_coreml.main(["-c", tiny_pth[0], "-o", str(tmp_path / "m.mlpackage")])
    assert (tmp_path / "m.pth").exists()


@pytest.mark.cuda
def test_cli_demo_on_cuda(tiny_pth, tmp_path, monkeypatch):
    """The demo's one forward an image, drawing from serve.make_predictor's
    heatmaps bit for bit; its chunked video prediction, one forward a chunk
    of --batch_size frames (the last padded)."""
    from PIL import Image

    from dino_pose_tpu_torch.cli import demo
    from dino_pose_tpu_torch.data.preprocess import create_preprocessor
    from dino_pose_tpu_torch.serve import make_predictor

    rng = np.random.default_rng(4)
    path = tmp_path / "person.jpg"
    Image.fromarray(rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)).save(path)
    drawn = []
    monkeypatch.setattr(demo, "draw_image", lambda image, hm, z, args: drawn.append((hm, z)))
    block.reset_launches()
    demo.main(["--input", str(path), "--model", tiny_pth[0], "--output", str(tmp_path / "o.png")])
    torch.cuda.synchronize()
    assert block.LAUNCHES == _launches((TINY_LORA_FWD, 1))
    predict = make_predictor(tiny_pth[1])
    _, z, hm = predict([Image.open(path).convert("RGB")])
    assert np.array_equal(drawn[0][0], hm[0]) and np.array_equal(drawn[0][1], z[0])

    frames = [Image.fromarray(rng.integers(0, 256, (120, 160, 3), dtype=np.uint8))
              for _ in range(10)]
    block.reset_launches()
    chunks = list(demo.predict_chunks(frames, predict, create_preprocessor("test/vit-tiny"), 8))
    torch.cuda.synchronize()
    assert block.LAUNCHES == _launches((TINY_LORA_FWD, 2))
    assert [len(c[1]) for c in chunks] == [8, 2]
    assert all(np.isfinite(c[1]).all() and np.isfinite(c[2]).all() for c in chunks)


@pytest.mark.cuda
def test_cli_benchmark_on_cuda(tiny_pth):
    from dino_pose_tpu_torch.cli.benchmark_model import benchmark_model

    block.reset_launches()
    result = benchmark_model(tiny_pth[0], warmup=1, iters=2)
    assert block.LAUNCHES == _launches((TINY_LORA_FWD, 1 + 2 + 2))
    assert all(result[k] > 0 for k in ("avg_ms", "p50_ms", "device_ms", "device_p50_ms"))
    assert result["params"] == tiny_pth[1].count_parameters(trainable_only=False)


@pytest.mark.cuda
def test_cli_compare_on_cuda(cuda_device, capsys):
    """Each model: 3 warm-up + 2 + 2 timed forwards in benchmark_model, then
    3 + 2 in --device-time's forward + decode."""
    from dino_pose_tpu_torch.cli import compare_models

    block.reset_launches()
    a, b = compare_models.main(["--model_a", "test/vit-tiny", "--model_b",
                                "timm/fastvit_t8.apple_in1k", "--iters", "2", "--device-time"])
    assert block.LAUNCHES == _launches((TINY_FWD, 12), (T8_FWD, 12))
    assert all(r[k] > 0 for r in (a, b) for k in ("avg_ms", "device_ms", "device_p50_ms"))
    assert "on-device:" in capsys.readouterr().out


SMALL_SERVING = {"fused_block": 11, "fused_attn_part": 1, "fused_mlp_part": 1}


def _assert_model_close(got: tuple, want: tuple) -> None:
    """chip_smoke.py's MODEL_REL_TOL: within 5% of the largest output."""
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g.float() - w.float()).abs().max().item() <= 5e-2 * w.float().abs().max().item()


@pytest.mark.cuda
def test_pretrained_dinov2_small_from_a_cache_on_the_card(cuda_device, tmp_path, monkeypatch):
    """A full-width dinov2-small entry in a hub cache written here (seeded
    tensors under HF's plain keys, ``pytorch_model.bin``; nothing is
    downloaded), loaded by the registry's default ``pretrained`` into a
    LoRA model on the card: the backbone bit-equal to the file, LoRA B
    zero, then a batch-2 forward's launches (11/1/1 and 12 resident
    attention forwards) and its outputs against the plain path."""
    source = registry.create_model_from_config({"model_name": "facebook/dinov2-small"},
                                               seed=3, device="cpu", pretrained=False)
    gen = torch.Generator().manual_seed(4)
    hf = {k[len("backbone."):]: v + 0.05 * torch.randn(v.shape, generator=gen)
          for k, v in source.state_dict().items() if k.startswith("backbone.")}
    commit = "0123456789abcdef0123456789abcdef01234567"
    repo = tmp_path / "models--facebook--dinov2-small"
    (repo / "snapshots" / commit).mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text(commit)
    (repo / "snapshots" / commit / "config.json").write_text(json.dumps(
        {"hidden_size": 384, "num_hidden_layers": 12, "num_attention_heads": 6,
         "patch_size": 14, "image_size": 518, "layerscale_value": 1.0}))
    torch.save(hf, repo / "snapshots" / commit / "pytorch_model.bin")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model = registry.create_model_from_config(
            {"model_name": "facebook/dinov2-small", "use_lora": True}, device=cuda_device)
    sd = model.state_dict()
    lora = "encoder.layer.11.attention."
    for k, v in hf.items():
        got = sd["backbone." + k.replace(lora, lora + "original_attention.")]
        assert got.device.type == "cuda" and torch.equal(got.cpu(), v), k
    assert (sd["backbone." + lora + "lora_output.lora_B"] == 0).all()
    x = _bf16(np.random.default_rng(6), (2, 3, 224, 224), cuda_device)
    with torch.inference_mode():
        block.reset_launches()
        out = model(x)
        torch.cuda.synchronize()
        assert block.LAUNCHES == _launches((SMALL_SERVING, 1), ({"attn_fwd": 12}, 1))
        _assert_model_close(out, model(x, kernels=False))


@pytest.mark.cuda
def test_dinov2_base_504_forward_launches(cuda_device):
    """dinov2-base + LoRA at 504² (S = 1297), batch 1: every block on the
    "math" route, whose chains stream their attention, so 11 fused_block,
    the LoRA layer's two halves and 12 flash forwards and nothing else, and
    the outputs against the plain path."""
    model = registry.create_model_from_config(
        {"model_name": "facebook/dinov2-base", "use_lora": True}, seed=0, device=cuda_device,
        pretrained=False)
    x = _bf16(np.random.default_rng(7), (1, 3, 504, 504), cuda_device)
    with torch.inference_mode():
        block.reset_launches()
        out = model(x)
        torch.cuda.synchronize()
        assert block.LAUNCHES == _launches((SMALL_SERVING, 1), ({"flash_fwd": 12}, 1))
        _assert_model_close(out, model(x, kernels=False))
