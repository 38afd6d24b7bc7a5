"""The port's fused-block functions against the JAX package's.

On the CPU the port's wrappers take their plain versions; these are held
against the JAX plain functions and against the JAX Pallas kernels run in
interpret mode, in float32 at small width with a ragged S (57), to 1e-5
abs/rel (the JAX suite's own f32 tolerance). The CUDA kernels themselves are
held against the plain versions on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_pose_tpu.ops import block as jblock
from dino_pose_tpu_torch.ops import block as tblock

D, H, S, B = 64, 2, 57, 2
EPS = 1e-6
NAMES = ("fused_block", "fused_attn_part", "fused_mlp_part")


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.05  # noqa: E731
    p = dict(
        g1=1 + r(D), b1=r(D), wqkv=r(D, 3 * D), bqkv=r(3 * D), wo=r(D, D), bo=r(D),
        ls1=1 + r(D), g2=1 + r(D), b2=r(D), w1=r(D, 4 * D), bf1=r(4 * D),
        w2=r(4 * D, D), bf2=r(D), ls2=1 + r(D),
    )
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return x, p


def _jax_call(name, x, p, fused):
    jp = jblock.BlockParams(**{k: jnp.asarray(v) for k, v in p.items()})
    ap = jblock.AttnParams(*(getattr(jp, f) for f in jblock.AttnParams._fields))
    mp = jblock.MlpParams(*(getattr(jp, f) for f in jblock.MlpParams._fields))
    x = jnp.asarray(x)
    if name == "fused_block":
        return jblock.fused_block(x, jp, H, EPS) if fused else \
            jblock.block_math(x, jp, num_heads=H, eps=EPS)
    if name == "fused_attn_part":
        return jblock.fused_attn_part(x, ap, H, EPS) if fused else \
            jblock.attn_part_math(x, ap, num_heads=H, eps=EPS)
    return jblock.fused_mlp_part(x, mp, EPS) if fused else \
        jblock.mlp_part_math(x, mp, eps=EPS)


def _torch_call(name, x, p, fused, device="cpu", dtype=torch.float32, heads=H):
    tp = tblock.BlockParams(**{
        k: torch.from_numpy(v).to(device, dtype if v.ndim == 2 else torch.float32)
        for k, v in p.items()
    })
    x = torch.from_numpy(x).to(device, dtype)
    ap, mp = tblock.attn_params(tp), tblock.mlp_params(tp)
    if name == "fused_block":
        return tblock.fused_block(x, tp, heads, EPS) if fused else \
            tblock.block_math(x, tp, num_heads=heads, eps=EPS)
    if name == "fused_attn_part":
        return tblock.fused_attn_part(x, ap, heads, EPS) if fused else \
            tblock.attn_part_math(x, ap, num_heads=heads, eps=EPS)
    return tblock.fused_mlp_part(x, mp, EPS) if fused else \
        tblock.mlp_part_math(x, mp, eps=EPS)


@pytest.mark.parametrize("name", NAMES)
def test_plain_versions_match_jax(arrays, name):
    x, p = arrays
    want = np.asarray(_jax_call(name, x, p, fused=False))
    got = _torch_call(name, x, p, fused=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_wrappers_match_pallas_kernels(arrays, name, monkeypatch):
    """The JAX Pallas kernel (interpret mode on the CPU) vs the port's
    wrapper, which takes its plain version for CPU tensors."""
    monkeypatch.setenv("DINO_POSE_TPU_BLOCK", "fused")
    x, p = arrays
    want = np.asarray(_jax_call(name, x, p, fused=True))
    tblock.reset_launches()
    got = _torch_call(name, x, p, fused=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert tblock.LAUNCHES[name] == 0  # no kernel launched on the CPU


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_on_cpu_is_the_plain_version(arrays, name):
    x, p = arrays
    assert torch.equal(_torch_call(name, x, p, fused=True), _torch_call(name, x, p, fused=False))


def test_wrapper_refuses_other_devices(arrays):
    x, p = arrays
    tp = tblock.BlockParams(**{k: torch.from_numpy(v) for k, v in p.items()})
    with pytest.raises(ValueError, match="unsupported device"):
        tblock.fused_block(torch.empty((B, S, D), device="meta"), tp, H, EPS)


def test_bound_model_matches_the_block_arithmetic():
    flops = tblock.block_flops(257, 384)
    assert abs(flops["fused_block"] / 1e9 - 1.011) < 1e-3
    assert flops["fused_block"] == flops["fused_attn_part"] + flops["fused_mlp_part"]
    nbytes = tblock.block_bytes(1, 257, 384)["fused_block"]
    assert 3.53e6 < nbytes - 2 * 257 * 384 * 2 < 3.57e6  # bf16 matrices + f32 vectors
    t, by = tblock.bound_ms(1e12 * 989, 1.0)
    assert by == "operations" and abs(t - 1e3) < 1e-9
