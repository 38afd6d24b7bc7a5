"""The chains' attention step alone, on the packed layout, on the CPU.

``packed_attention_bwd_math`` (the plain version of the resident backward
pair and of every backward chain's attention step) against the JAX
package's ``flash_attention`` vjp (``dino_pose_tpu/ops/attention.py``),
whose Pallas ``_flash_bwd_kernel`` runs in interpret mode here and rounds P
and dS to bf16 where ``_attn_bwd_kernel``'s per-head loop does: f32 to 1e-4
abs (summation order only), bf16 to 2e-2 abs (one bf16 ulp of values up to
4). Inputs are made from numpy seeds in the chains' packed layout, qkv (B,
S, 3D) with q|k|v on the last axis and dctx (B, S, D), and given to JAX as
(B, H, S, dh) heads. Then ``_attn_bwd``'s dqkv is that function's, bit for
bit; the wrappers take their plain versions on CPU tensors; and
``attention_core_cost`` counts what ``flash_cost`` counts. The CUDA kernels
are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
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

EPS = 1e-6
# (B, H, S, dh): dinov2's S = 257 at head width 64 (a ragged last 64-row
# tile), and a short ragged S at head width 32.
CASES = [(2, 2, 257, 64), (1, 3, 65, 32)]


def _packed(shape, seed):
    """Seeded qkv (B, S, 3D) and dctx (B, S, D), f32 numpy."""
    b, h, s, dh = shape
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * h * dh)).astype(np.float32)
    dctx = rng.standard_normal((b, s, h * dh)).astype(np.float32)
    return qkv, dctx


def _heads(t, h):
    """(B, S, h*dh) -> (B, h, S, dh)."""
    b, s, d = t.shape
    return t.reshape(b, s, h, d // h).transpose(0, 2, 1, 3)


def _jax_dqkv(qkv, dctx, h, dtype):
    """JAX's flash_attention vjp at the packed inputs, packed back into dqkv
    (B, S, 3D) f32."""
    d = dctx.shape[-1]
    q, k, v = (jnp.asarray(_heads(qkv[..., i * d:(i + 1) * d], h), dtype) for i in range(3))
    scale = (d // h) ** -0.5
    _, vjp = jax.vjp(lambda *a: jattention.flash_attention(*a, scale), q, k, v)
    grads = vjp(jnp.asarray(_heads(dctx, h), dtype))
    b, s = dctx.shape[:2]
    return np.concatenate([np.asarray(g, np.float32).transpose(0, 2, 1, 3).reshape(b, s, d)
                           for g in grads], axis=-1)


@pytest.mark.parametrize("shape", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_attention_bwd_math_matches_jax(shape, dtype):
    qkv, dctx = _packed(shape, sum(shape))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    want = _jax_dqkv(qkv, dctx, shape[1], jdt)
    got = tblock.packed_attention_bwd_math(torch.from_numpy(qkv).to(tdt),
                                           torch.from_numpy(dctx).to(tdt), shape[1])
    assert got.dtype == tdt and got.shape == qkv.shape
    atol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("shape", CASES)
def test_packed_attention_bwd_math_is_the_flash_backward(shape):
    """In f32 the packed plain version is the streamed pair's plain version,
    ``flash_bwd_math``, on the same heads: one function on two layouts."""
    b, h, s, dh = shape
    qkv, dctx = (torch.from_numpy(t) for t in _packed(shape, 7))
    d = h * dh
    q, k, v = (torch.from_numpy(_heads(t.numpy(), h).copy()) for t in qkv.split(d, dim=-1))
    g = torch.from_numpy(_heads(dctx.numpy(), h).copy())
    want = tattention.flash_bwd_math(q, k, v, g, dh**-0.5)
    got = tblock.packed_attention_bwd_math(qkv, dctx, h).split(d, dim=-1)
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w.transpose(1, 2).reshape(b, s, d), atol=1e-5, rtol=1e-5)


def _block_inputs(d, heads, s, dtype, seed):
    rng = np.random.default_rng(seed)

    def n(*shape, std=1.0, mean=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * std + mean).astype(np.float32))

    p = tblock.BlockParams(
        g1=n(d, std=0.1, mean=1), b1=n(d, std=0.05), wqkv=n(d, 3 * d, std=d**-0.5),
        bqkv=n(3 * d, std=0.05), wo=n(d, d, std=d**-0.5), bo=n(d, std=0.05),
        ls1=torch.from_numpy(rng.uniform(0.1, 1, d).astype(np.float32)),
        g2=n(d, std=0.1, mean=1), b2=n(d, std=0.05), w1=n(d, 4 * d, std=d**-0.5),
        bf1=n(4 * d, std=0.05), w2=n(4 * d, d, std=(4 * d)**-0.5), bf2=n(d, std=0.05),
        ls2=torch.from_numpy(rng.uniform(0.1, 1, d).astype(np.float32)))
    p = tblock.cast_params(p, dtype)
    x, dres = (n(2, s, d).to(dtype) for _ in range(2))
    return x, dres, p


@pytest.mark.parametrize("route", ["resident", "stream"])
def test_attn_bwd_takes_its_dqkv_from_the_packed_math(route, monkeypatch):
    """``_attn_bwd`` (both backward routes' plain version) hands its own qkv
    and dctx to ``packed_attention_bwd_math`` and uses what it returns, bit
    for bit, in bf16: qkv = LN1(x) Wqkv + bqkv at the chains' rounding, dctx
    = bf16(do Wo^T), and dbqkv the column sums of that dqkv."""
    d, heads = 128, 2
    x, dres, p = _block_inputs(d, heads, 57, torch.bfloat16, seed=3)
    seen = []
    plain = tblock.packed_attention_bwd_math

    def spy(qkv, dctx, num_heads):
        out = plain(qkv, dctx, num_heads)
        seen.append((qkv, dctx, num_heads, out))
        return out

    monkeypatch.setattr(tblock, "packed_attention_bwd_math", spy)
    if route == "resident":
        _, grads = tblock.attn_bwd_math(x, dres, tblock.attn_train_params(p), num_heads=heads,
                                        eps=EPS)
        dob = (dres.float() * p.ls1.float()).to(x.dtype)
    else:
        _, grads = tblock.attn_stream_bwd_math(x, dres, tblock.attn_params(p), num_heads=heads,
                                               eps=EPS)
        dob = dres
    assert len(seen) == 1
    qkv, dctx, num_heads, dqkv = seen[0]
    assert num_heads == heads
    a = tblock._ln_fwd(x, p.g1, p.b1, EPS)[0]
    assert torch.equal(qkv, tblock._dense(a, p.wqkv, p.bqkv))
    assert torch.equal(dctx, (dob.float() @ p.wo.to(x.dtype).float().t()).to(x.dtype))
    assert torch.equal(dqkv, plain(qkv, dctx, heads))
    assert torch.equal(grads.bqkv, tblock._colsum(dqkv))


@pytest.mark.parametrize("streamed", [False, True])
def test_packed_attention_wrappers_take_their_plain_versions_on_the_cpu(streamed):
    b, h, s, dh = 2, 3, 65, 32
    qkv, dctx = (torch.from_numpy(t).to(torch.bfloat16) for t in _packed((b, h, s, dh), 11))
    before = dict(tblock.LAUNCHES)
    assert torch.equal(tblock.packed_attention(qkv, h, streamed=streamed),
                       tblock._heads_attention(qkv, h))
    assert torch.equal(tblock.packed_attention_bwd(qkv, dctx, h, streamed=streamed),
                       tblock.packed_attention_bwd_math(qkv, dctx, h))
    assert tblock.LAUNCHES == before  # the CPU launches no kernel


@pytest.mark.parametrize("shape", [(1, 6, 257, 64), (128, 16, 257, 64), (8, 12, 65, 32)])
def test_attention_core_cost(shape):
    """JAX's FLOPs (the count ``flash_cost`` takes from the Pallas kernels'
    CostEstimate) and the packed layout's bytes, each once."""
    b, h, s, dh = shape
    d = h * dh
    fwd, bwd = (tblock.attention_core_cost(b, h, s, dh, backward) for backward in (False, True))
    # By hand: scores and PV, 2*S*S*dh each a head; the backward recomputes
    # the scores and adds dP, dq, dk and dv.
    assert fwd[0] == 2 * 2 * b * h * s * s * dh
    assert bwd[0] == 5 * 2 * b * h * s * s * dh
    assert fwd[1] == (b * s * 3 * d + b * s * d) * 2          # qkv read, ctx written
    assert bwd[1] == (b * s * 3 * d + b * s * d + b * s * 3 * d) * 2  # qkv, dctx; dqkv
    flash = tattention.flash_cost(b, h, s, dh)
    assert fwd == flash["flash_attention"][:2]
    assert bwd == flash["flash_attention_bwd"][:2]
