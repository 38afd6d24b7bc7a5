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
abs/rel at every fastvit_t8 and fastvit_sa12 stage shape; its backward
``fused_convffn_bwd`` holds dy to the same and each parameter gradient (f32
sums over all rows) to 2e-3 of its largest magnitude, as the block
backward's.
"""

import copy

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


def _params(device) -> block.BlockParams:
    rng = np.random.default_rng(1)

    def n(*s, std=1.0, mean=0.0):
        return (rng.standard_normal(s) * std + mean).astype(np.float32)

    p = dict(
        g1=n(D, std=0.1, mean=1), b1=n(D, std=0.05), wqkv=n(D, 3 * D, std=D**-0.5),
        bqkv=n(3 * D, std=0.05), wo=n(D, D, std=D**-0.5), bo=n(D, std=0.05),
        ls1=rng.uniform(0.1, 1, D).astype(np.float32), g2=n(D, std=0.1, mean=1),
        b2=n(D, std=0.05), w1=n(D, HIDDEN, std=D**-0.5), bf1=n(HIDDEN, std=0.05),
        w2=n(HIDDEN, D, std=HIDDEN**-0.5), bf2=n(D, std=0.05),
        ls2=rng.uniform(0.1, 1, D).astype(np.float32),
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
                              "fused_attn_part": 1, "fused_mlp_part": 1}
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
                                  "fused_mlp_dx": want}
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
    assert block.LAUNCHES[name] == 1 and sum(block.LAUNCHES.values()) == 1
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
    fused_block_train, fused_mlp_bwd and fused_attn_bwd, nothing else. Losses
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
                                  "fused_mlp_bwd": want, "fused_attn_bwd": want}
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
# batch 1 and 4, head width 32, S = 577, and a single short tile.
# fastvit_sa12's SpatialAttention at 256² (16 heads of 32 over an 8x8 grid:
# one query tile, no ragged edge) at batch 1 and 8.
FLASH_CASES = [(1, 6, 1297, 64), (4, 6, 1297, 64), (2, 2, 1297, 32), (2, 6, 577, 64),
               (1, 2, 100, 32), (1, 16, 64, 32), (8, 16, 64, 32)]


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
    assert block.LAUNCHES == {**zero, "fused_block": 1}
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
    with pytest.raises(ValueError, match="multiples of 16"):
        y76, p76 = _convffn_inputs(1, 64, 76, 304, 8, cuda_device)   # fastvit_ma36
        convffn.fused_convffn(y76, p76, 2.0)
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
    model = registry.create_model_from_config(
        {"model_name": name, "use_lora": "t8" in name}, device=cuda_device)
    with torch.no_grad():
        for n, prm in model.named_parameters():
            if "lora_B" in n:
                prm.copy_(torch.randn_like(prm) * 0.02)
            elif n.rsplit(".", 1)[-1].startswith("layer_scale"):
                prm.uniform_(0.1, 1.0)
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 3, 256, 256)).astype(np.float32)
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


@pytest.mark.cuda
def test_convffn_bwd_refuses_what_it_does_not_take(cuda_device):
    y, p = _convffn_inputs(1, 64, 48, 144, 8, cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        convffn.fused_convffn_bwd(y.float(), y.float(), p, 2.0)
    with pytest.raises(ValueError, match="df must be"):
        convffn.fused_convffn_bwd(y, y[:, :32], p, 2.0)
    with pytest.raises(ValueError, match="multiples of 16"):
        y76, p76 = _convffn_inputs(1, 64, 76, 304, 8, cuda_device)   # fastvit_ma36
        convffn.fused_convffn_bwd(y76, y76, p76, 2.0)
    with pytest.raises(ValueError, match="rank"):
        y16, p16 = _convffn_inputs(1, 64, 48, 144, 16, cuda_device)
        convffn.fused_convffn_bwd(y16, y16, p16, 2.0)
    leaves = p._replace(w1=p.w1.clone().requires_grad_())
    with pytest.raises(ValueError, match="requires grad"):
        convffn.convffn_train(y, leaves, 2.0)


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
    model = registry.create_model_from_config(config, device=cuda_device)
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
