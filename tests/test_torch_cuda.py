"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card. The file
imports no JAX, so that it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: bf16, 3e-2 abs/rel — the JAX suite's own bf16 tolerance for the
fused block (tests/test_block_kernel.py); kernel and plain version round
every product to bf16, in another summation order, so single roundings flip
by one ulp.
"""

import numpy as np
import pytest
import torch

from dino_pose_tpu_torch.models import registry
from dino_pose_tpu_torch.ops import block

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
    assert block.LAUNCHES == {"fused_block": 1, "fused_attn_part": 1, "fused_mlp_part": 1}
    for got, want in ((hm, hm_p), (z, z_p)):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 5e-2 * want.float().abs().max().item()
