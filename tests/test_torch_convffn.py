"""The port's ConvFFN plain version against the JAX package's ConvFFN kernel.

``convffn_math`` (dino_pose_tpu_torch/ops/convffn.py) is held against JAX's
``fused_convffn``, which runs the Pallas ``_convffn_fwd_kernel`` in interpret
mode on the CPU (as tests/test_convffn_kernel.py runs it). Inputs come from
numpy with a seed: B = 2, S = 64 and a ragged 50 (JAX pads it to 56), C = 64,
H = 192, LoRA rank 4 with random masks that are not ones, and rank 0 as JAX
expresses it (rank-1 zero adapters, ones masks), s = 4. In f32 the two agree
to 1e-5 relative (summation order only).

In bf16 both round at the same points and sum their products in f32 in
another order. Against JAX's kernel body run op by op (eager, every
rounding point kept) the outputs agree within one bf16 ulp of the output's
largest magnitude. Against the Pallas kernel itself they agree within two:
XLA's CPU compiler evaluates the jitted body's f32 GELU polynomial in
another order than the same code run eagerly, which flips a bf16 rounding
of g, and the jitted and eager JAX results then differ by two ulps (0.0625
at |out| ~ 4 for these inputs), so no port can sit closer to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_pose_tpu.ops import convffn as jconvffn
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu_torch.ops import convffn as tconvffn

B, C, H, S_LORA = 2, 64, 192, 4.0


def _inputs(s: int, rank: int, seed: int) -> tuple[np.ndarray, dict]:
    rng = np.random.default_rng(seed)

    def n(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    y = n(B, s, C)
    if rank:
        a1, b1l = n(C, rank, std=C**-0.5), n(rank, H, std=0.1)
        a2, b2l = n(H, rank, std=H**-0.5), n(rank, C, std=0.1)
        # Dropout2d-style masks: zeros and 1/keep, per (sample, rank).
        m1, m2 = ((rng.random((B, rank)) > 0.3).astype(np.float32) / 0.7 for _ in range(2))
    else:
        a1, b1l = np.zeros((C, 1), np.float32), np.zeros((1, H), np.float32)
        a2, b2l = np.zeros((H, 1), np.float32), np.zeros((1, C), np.float32)
        m1 = m2 = np.ones((B, 1), np.float32)
    p = dict(
        inv=rng.uniform(0.5, 1.5, C).astype(np.float32), shift=n(C, std=0.1),
        w1=n(C, H, std=C**-0.5), b1=n(H, std=0.1), w2=n(H, C, std=H**-0.5), b2=n(C, std=0.1),
        a1=a1, b1l=b1l, a2=a2, b2l=b2l, m1=m1, m2=m2,
    )
    return y, p


class _Ref:
    """A stand-in for a Pallas ref, to run the kernel body eagerly."""

    def __init__(self, value):
        self.value = value

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, value):
        self.value = value


def _jax_eager(y, p, dtype):
    """JAX's ``_convffn_fwd_kernel`` body on whole arrays, op by op."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = jconvffn.ConvFFNParams(**{k: jnp.asarray(v) for k, v in p.items()})
    out = _Ref(None)
    jconvffn._convffn_fwd_kernel(
        _Ref(jnp.asarray(y, jdt)), _Ref(jp.m1[:, None, :]), _Ref(jp.m2[:, None, :]),
        *(_Ref(a) for a in jconvffn._prep(jp, jdt)), out, s_lora=S_LORA)
    return np.asarray(out.value.astype(jnp.float32))


def _run_both(y, p, dtype, monkeypatch):
    """(port's convffn_math, JAX's fused_convffn) in ``dtype``: activations and
    matrices in ``dtype``, vectors and masks f32."""
    monkeypatch.setenv("DINO_POSE_TPU_CONVFFN", "force")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    calls = []
    kernel = jconvffn._convffn_fwd_kernel
    monkeypatch.setattr(jconvffn, "_convffn_fwd_kernel",
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))

    def jx(k, v):
        return jnp.asarray(v, jdt if v.ndim == 2 and k not in ("m1", "m2") else jnp.float32)

    def tx(k, v):
        t = torch.from_numpy(v)
        return t.to(dtype) if v.ndim == 2 and k not in ("m1", "m2") else t

    with jdispatch.local():
        want = jconvffn.fused_convffn(jnp.asarray(y, jdt),
                                      jconvffn.ConvFFNParams(**{k: jx(k, v) for k, v in p.items()}),
                                      S_LORA)
    assert calls, "the JAX side must run its Pallas kernel"
    got = tconvffn.fused_convffn(torch.from_numpy(y).to(dtype),
                                 tconvffn.ConvFFNParams(**{k: tx(k, v) for k, v in p.items()}),
                                 S_LORA)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("rank", [4, 0])
@pytest.mark.parametrize("s", [64, 50])
def test_convffn_math_matches_jax_kernel_f32(s, rank, monkeypatch):
    y, p = _inputs(s, rank, seed=s + rank)
    got, want = _run_both(y, p, torch.float32, monkeypatch)
    assert got.shape == want.shape == (B, s, C)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rank", [4, 0])
@pytest.mark.parametrize("s", [64, 50])
def test_convffn_math_matches_jax_kernel_bf16(s, rank, monkeypatch):
    y, p = _inputs(s, rank, seed=10 + s + rank)
    got, want = _run_both(y, p, torch.bfloat16, monkeypatch)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 2 * ulp
    eager = _jax_eager(y, p, torch.bfloat16)
    assert np.abs(got - eager).max() <= 2.0 ** (np.floor(np.log2(np.abs(eager).max())) - 7)


def test_lora_terms_and_masks_reach_the_output(monkeypatch):
    """The LoRA terms are not lost in the comparison's noise: with rank 4 and
    real masks the output moves by far more than the tolerance when the
    adapters are zeroed."""
    y, p = _inputs(64, 4, seed=7)
    got, _ = _run_both(y, p, torch.float32, monkeypatch)
    p0 = {**p, "b1l": np.zeros_like(p["b1l"]), "b2l": np.zeros_like(p["b2l"])}
    got0, _ = _run_both(y, p0, torch.float32, monkeypatch)
    assert np.abs(got - got0).max() > 100 * 1e-5 * np.abs(got).max()


def test_cost_counts_the_products_and_bytes():
    flops, nbytes = tconvffn.convffn_cost(2, 64, 48, 144, 8)
    assert flops == 4 * 2 * 64 * 48 * 144 + 4 * 2 * 64 * 8 * (48 + 144)
    assert nbytes == (2 * 2 * 64 * 48 * 2 + (2 * 48 * 144 + 2 * 8 * (48 + 144)) * 2
                      + (3 * 48 + 144) * 4 + 2 * 2 * 8 * 4)
