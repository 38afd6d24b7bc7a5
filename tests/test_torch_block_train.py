"""The trainable block's backward against the JAX package's, on the CPU.

``mlp_bwd_math`` and ``attn_bwd_math`` are held against JAX's ``_mlp_bwd`` and
``_attn_bwd``, whose Pallas kernels ``_mlp_bwd_kernel`` and
``_attn_bwd_kernel`` run in interpret mode, in f32 at D=64, H=2, a ragged
S=57 (JAX pads it to 64 and masks the keys) and B=3 (the TPU kernels add
their weight gradients over three grid steps). ``block_train`` is held
against ``jax.vjp`` of JAX's ``fused_block_train`` in f32 and in bf16.

Tolerances. f32: summation order only. y and dx are held to 1e-5 relative
plus 1e-5 of their largest magnitude (their values reach 35; the JAX side's
GELU uses a rational erf good to 1.5e-7), each weight gradient, a sum over
171 rows, to 1e-5 relative Frobenius error (measured below 1e-6). bf16: the
same rounding points on both sides, but a product rounded to bf16 in another
summation order flips by one ulp (2^-8 relative), and the flip travels on.
y and dx are held to 1.5e-2 relative plus 1.5e-2 of their largest magnitude
(measured 5.6e-3 of it: one or two ulps of the largest value), each gradient
to 1e-2 relative Frobenius error (measured up to 4.6e-3). The CUDA kernels
are held against these plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_pose_tpu.ops import block as jblock
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu_torch.ops import block as tblock

D, H, S, B = 64, 2, 57, 3
SP = 64  # JAX pads S to a multiple of 8
EPS = 1e-6


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(10)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.05  # noqa: E731
    p = dict(
        g1=1 + r(D), b1=r(D), wqkv=r(D, 3 * D) * 4, bqkv=r(3 * D), wo=r(D, D) * 4, bo=r(D),
        ls1=1 + r(D), g2=1 + r(D), b2=r(D), w1=r(D, 4 * D) * 4, bf1=r(4 * D),
        w2=r(4 * D, D) * 2, bf2=r(D), ls2=1 + r(D),
    )
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    x2 = rng.standard_normal((B, S, D)).astype(np.float32)
    ct = rng.standard_normal((B, S, D)).astype(np.float32)
    return x, x2, ct, p


def _count(monkeypatch, *names):
    calls = {n: 0 for n in names}
    for n in names:
        orig = getattr(jblock, n)

        def counted(*a, _n=n, _orig=orig, **k):
            calls[_n] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(jblock, n, counted)
    return calls


def _pad(a):
    return jnp.pad(jnp.asarray(a), [(0, 0), (0, SP - S), (0, 0)])


def _rel(got, want):
    return np.linalg.norm(np.asarray(got, np.float64) - np.asarray(want, np.float64)) \
        / np.linalg.norm(np.asarray(want, np.float64))


def _tparams(p, names, dtype=torch.float32):
    return {k: torch.from_numpy(p[k]).to(dtype if p[k].ndim == 2 else torch.float32)
            for k in names}


def _check_grads(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    for k in want:
        g = got[k].float().numpy()
        w = np.asarray(want[k], np.float32).reshape(g.shape)
        assert np.abs(w).max() > 0, k
        rel = _rel(g, w)
        assert rel < tol, f"{k}: relative Frobenius error {rel:.3e} (tol {tol})"


def test_mlp_bwd_math_matches_pallas_kernel(arrays, monkeypatch):
    x, x2, ct, p = arrays
    calls = _count(monkeypatch, "_mlp_bwd_kernel")
    jp = jblock.BlockParams(**{k: jnp.asarray(v) for k, v in p.items()})
    with jdispatch.local():
        dx2_j, g_j = jblock._mlp_bwd(_pad(x2), _pad(ct), jp, EPS, S)
    assert calls["_mlp_bwd_kernel"]
    mp = tblock.MlpParams(**_tparams(p, tblock.MlpParams._fields))
    dx2, grads = tblock.mlp_bwd_math(torch.from_numpy(x2), torch.from_numpy(ct), mp, eps=EPS)
    np.testing.assert_allclose(dx2.numpy(), np.asarray(dx2_j)[:, :S], atol=1e-5, rtol=1e-5)
    _check_grads(grads._asdict(), g_j, 1e-5)


def test_attn_bwd_math_matches_pallas_kernel(arrays, monkeypatch):
    x, _, ct, p = arrays
    calls = _count(monkeypatch, "_attn_bwd_kernel")
    jp = jblock.BlockParams(**{k: jnp.asarray(v) for k, v in p.items()})
    with jdispatch.local():
        dx_j, g_j = jblock._attn_bwd(_pad(x), _pad(ct), jp, H, EPS, S)
    assert calls["_attn_bwd_kernel"]
    atp = tblock.AttnTrainParams(**_tparams(p, tblock.AttnTrainParams._fields))
    dx, grads = tblock.attn_bwd_math(torch.from_numpy(x), torch.from_numpy(ct), atp,
                                     num_heads=H, eps=EPS)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j)[:, :S], atol=1e-5, rtol=1e-5)
    _check_grads(grads._asdict(), g_j, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_train_matches_jax_fused_block_train(arrays, dtype, monkeypatch):
    """y, dx and the gradient of every parameter (f32 masters on both sides)
    of ``block_train`` (plain on the CPU) against ``jax.vjp`` of JAX's
    ``fused_block_train``, whose forward and both backward kernels run."""
    x, _, ct, p = arrays
    calls = _count(monkeypatch, "_mlp_bwd_kernel", "_attn_bwd_kernel")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jblock.BlockParams(**{k: jnp.asarray(v) for k, v in p.items()})
    xj = jnp.asarray(x).astype(jdt)
    with jdispatch.local():
        y_j, vjp = jax.vjp(lambda x_, p_: jblock.fused_block_train(x_, p_, H, EPS), xj, jp)
        dx_j, dp_j = vjp(jnp.asarray(ct).astype(jdt))
    assert all(calls.values()), calls

    params = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    tblock.reset_launches()
    y = tblock.block_train(xt, tblock.BlockParams(**params), H, EPS)
    assert y.dtype == tdt and type(y.grad_fn).__name__ == "_BlockTrainBackward"
    y.backward(torch.from_numpy(ct).to(tdt))
    assert all(n == 0 for n in tblock.LAUNCHES.values())   # the CPU runs the plain versions
    atol, tol = (1e-5, 1e-5) if dtype == "float32" else (1.5e-2, 1e-2)
    for got, want in ((y, y_j), (xt.grad, dx_j)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   atol=atol * np.abs(want).max(), rtol=atol)
    assert all(t.grad.dtype == torch.float32 for t in params.values())
    _check_grads({k: t.grad for k, t in params.items()}, dp_j._asdict(), tol)


def test_block_train_kernels_flag_is_the_plain_path_on_cpu(arrays):
    """On the CPU the wrappers take their plain versions, so both settings
    of ``kernels`` give the same bits."""
    x, _, ct, p = arrays
    out = []
    for kernels in (True, False):
        params = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
        xt = torch.from_numpy(x).requires_grad_()
        y = tblock.block_train(xt, tblock.BlockParams(**params), H, EPS, kernels=kernels)
        y.backward(torch.from_numpy(ct))
        out.append([y.detach(), xt.grad] + [t.grad for t in params.values()])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_block_train_leaves_an_unused_input_gradient_out(arrays):
    """The lowest trainable block's input needs no gradient: none is given,
    and the weights still get theirs."""
    x, _, ct, p = arrays
    params = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x)
    tblock.block_train(xt, tblock.BlockParams(**params), H, EPS).backward(torch.from_numpy(ct))
    assert xt.grad is None and all(t.grad.abs().max() > 0 for t in params.values())


def test_fused_block_train_on_cpu_is_the_plain_version(arrays):
    x, _, _, p = arrays
    tp = tblock.BlockParams(**_tparams(p, tblock.BlockParams._fields))
    xt = torch.from_numpy(x)
    y, x2 = tblock.fused_block_train(xt, tp, H, EPS)
    assert torch.equal(y, tblock.fused_block(xt, tp, H, EPS))
    assert torch.equal(x2, xt + tblock.attn_part_math(xt, tblock.attn_params(tp), num_heads=H,
                                                      eps=EPS) * tp.ls1)


def test_backward_bound_model():
    """The figures the chip run's bound column rests on, at dinov2-small,
    S = 257, batch 128 on an H100 (989 TFLOP/s bf16)."""
    flops = tblock.block_flops(257, 384)
    assert flops["fused_mlp_bwd"] == 6 * 2 * 257 * 384 * 1536
    assert flops["fused_block_train"] == flops["fused_block"]
    nbytes = tblock.block_bytes(128, 257, 384)
    t, by = tblock.bound_ms(128 * flops["fused_mlp_bwd"], nbytes["fused_mlp_bwd"])
    assert by == "operations" and abs(t - 0.235) < 1e-3
    t, by = tblock.bound_ms(128 * flops["fused_attn_bwd"], nbytes["fused_attn_bwd"])
    assert by == "operations" and abs(t - 0.157) < 1e-3
