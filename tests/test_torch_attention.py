"""The port's flash attention against the JAX package's, on the CPU.

On the CPU ``flash_attention`` runs its plain versions, ``flash_math`` and
``flash_bwd_math``; the JAX side runs its Pallas ``_flash_kernel`` and
``_flash_bwd_kernel`` in interpret mode (the CPU route of its own tests).
Inputs are made from numpy seeds and given to both. Float32: the output to
1e-5 and dq, dk, dv to 1e-4 abs (measured below 5e-7: summation order
only). bf16: 2e-2 abs, one bf16 ulp of values up to 4 (both sides round P
and dS to bf16, in another summation order). The CUDA kernels are held
against these plain versions on the card by tests/test_torch_cuda.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_pose_tpu_torch.ops import attention as tattention
from dino_pose_tpu_torch.ops import block as tblock

jattention = importlib.import_module("dino_pose_tpu.ops.attention")


def _inputs(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(4)]


def _jax_flash(q, k, v, g, scale, dtype=jnp.float32):
    out, vjp = jax.vjp(lambda *a: jattention.flash_attention(*a, scale),
                       *(jnp.asarray(t, dtype) for t in (q, k, v)))
    return out, vjp(jnp.asarray(g, dtype))


def _count_kernels(monkeypatch):
    calls = {"_flash_kernel": 0, "_flash_bwd_kernel": 0}
    for name in calls:
        orig = getattr(jattention, name)

        def counted(*a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(jattention, name, counted)
    return calls


# (B, H, S, dh): the multi-chunk backward at S = 577 (five 128-row chunks in
# JAX, ten 64-row tiles here), S = 1297 (dinov2 at 504², ragged: 20*64 + 17
# rows) at both head widths, and a single short chunk.
CASES = [(1, 2, 577, 64), (1, 2, 1297, 32), (2, 1, 1297, 64), (1, 1, 100, 32)]


@pytest.mark.parametrize("shape", CASES)
def test_flash_attention_matches_jax(shape, monkeypatch):
    calls = _count_kernels(monkeypatch)
    q, k, v, g = _inputs(shape, sum(shape))
    scale = shape[-1] ** -0.5
    out, (dq, dk, dv) = _jax_flash(q, k, v, g, scale)
    assert calls == {"_flash_kernel": 1, "_flash_bwd_kernel": 1}
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    before = dict(tblock.LAUNCHES)
    got = tattention.flash_attention(tq, tk, tv, scale)
    got.backward(torch.from_numpy(g))
    assert tblock.LAUNCHES == before  # the CPU launches no kernel
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=0)
    for t, want in zip((tq, tk, tv), (dq, dk, dv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_flash_attention_bf16_rounding_points_match_jax():
    """bf16 inputs: both sides round P (and dS) to bf16 before their
    products and the outputs once."""
    shape = (1, 2, 300, 32)
    q, k, v, g = _inputs(shape, 5)
    scale = shape[-1] ** -0.5
    out, grads = _jax_flash(q, k, v, g, scale, jnp.bfloat16)
    tq, tk, tv, tg = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v, g))
    got = tattention.flash_math(tq, tk, tv, scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(out, np.float32), atol=2e-2, rtol=0)
    for t, want in zip(tattention.flash_bwd_math(tq, tk, tv, tg, scale), grads):
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(t.float().numpy(), np.asarray(want, np.float32),
                                   atol=2e-2, rtol=0)


def test_flash_math_is_softmax_attention_and_its_backward_autograd():
    """In f32 the plain versions are exactly attention and its gradient:
    held to torch autograd of ``plain_attention``."""
    q, k, v, g = (torch.from_numpy(t) for t in _inputs((2, 3, 70, 32), 3))
    scale = 32 ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = tattention.plain_attention(*leaves, scale)
    want.backward(g)
    torch.testing.assert_close(tattention.flash_math(q, k, v, scale), want.detach(),
                               atol=1e-6, rtol=1e-6)
    for got, leaf in zip(tattention.flash_bwd_math(q, k, v, g, scale), leaves):
        torch.testing.assert_close(got, leaf.grad, atol=1e-5, rtol=1e-5)


def test_attention_dispatch_and_constants():
    """On the CPU ``attention`` is ``flash_math`` at every S (the card takes
    the kernel at every S: the port keeps no ``FLASH_MIN_SEQ``)."""
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs((1, 2, 40, 32), 4))
    torch.testing.assert_close(tattention.attention(q, k, v, 0.2),
                               tattention.flash_math(q, k, v, 0.2), atol=0, rtol=0)


@pytest.mark.parametrize("shape", [(2, 6, 64, 32), (1, 3, 256, 64), (32, 6, 1297, 64)])
def test_flash_cost_is_jax_cost_estimate(shape, monkeypatch):
    """``flash_cost``'s FLOPs and bytes are the ``CostEstimate`` JAX's
    ``_pallas_forward`` and ``_pallas_backward`` give their pallas_calls
    (traced abstractly, nothing runs), where JAX pads nothing (S a multiple
    of 8, and of 128 past the backward's one chunk); at S = 1297 JAX counts
    its padded 1304 (forward) and 1408 (backward) rows, the port the true
    S. The executed counts are 1.5 and 1.8 times JAX's FLOPs."""
    b, h, s, dh = shape
    estimates = []
    real = jattention.pl.CostEstimate

    def record(**kw):
        estimates.append(kw)
        return real(**kw)

    monkeypatch.setattr(jattention.pl, "CostEstimate", record)
    x = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
    jax.eval_shape(lambda q, k, v: jattention._pallas_forward(q, k, v, 0.125), x, x, x)
    jax.eval_shape(lambda q, k, v, g: jattention._pallas_backward(q, k, v, g, 0.125),
                   x, x, x, x)
    cost = tattention.flash_cost(b, h, s, dh)
    pads = {"flash_attention": -(-s // 8) * 8, "flash_attention_bwd": jattention._bwd_chunk(s)[0]}
    for (name, (flops, nbytes, executed)), est in zip(cost.items(), estimates):
        sp = pads[name]
        assert flops * sp * sp == est["flops"] * s * s, name
        assert nbytes * sp == est["bytes_accessed"] * s, name
        if sp == s:
            assert (flops, nbytes) == (est["flops"], est["bytes_accessed"]), name
        assert executed * (4 if name == "flash_attention" else 10) == flops * (
            6 if name == "flash_attention" else 18)
