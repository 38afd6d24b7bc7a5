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

import jax
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


# ---------------------------------------------------------------------------
# The backward: convffn_bwd_math against _convffn_bwd_kernel, and convffn_train
# ---------------------------------------------------------------------------

GRAD_FIELDS = ("inv", "shift", "a1", "b1l", "a2", "b2l")


def _jax_vjp(y, df, p, jdt, monkeypatch):
    """JAX's fused_convffn under jax.vjp, y in ``jdt`` and f32 parameters (cast
    inside, as its train step passes them): (dy, {field: gradient}). Its
    backward is the Pallas ``_convffn_bwd_kernel`` in interpret mode."""
    monkeypatch.setenv("DINO_POSE_TPU_CONVFFN", "force")
    calls = []
    kernel = jconvffn._convffn_bwd_kernel
    monkeypatch.setattr(jconvffn, "_convffn_bwd_kernel",
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    jp = jconvffn.ConvFFNParams(**{k: jnp.asarray(v) for k, v in p.items()})
    with jdispatch.local():
        out, vjp = jax.vjp(lambda y_, p_: jconvffn.fused_convffn(y_, p_, S_LORA),
                           jnp.asarray(y, jdt), jp)
        dy, dp = vjp(jnp.asarray(df, jdt))
    assert calls, "the JAX side must run its Pallas backward kernel"
    return (np.asarray(dy.astype(jnp.float32)),
            {k: np.asarray(getattr(dp, k)) for k in GRAD_FIELDS})


def _port_bwd(y, df, p, dtype):
    params = tconvffn.ConvFFNParams(**{k: torch.from_numpy(v) for k, v in p.items()})
    dy, g = tconvffn.convffn_bwd_math(torch.from_numpy(y).to(dtype),
                                      torch.from_numpy(df).to(dtype),
                                      tconvffn._cast(params, dtype), S_LORA)
    assert dy.dtype == dtype and all(t.dtype == torch.float32 for t in g)
    return dy.float().numpy(), {k: getattr(g, k).numpy() for k in GRAD_FIELDS}


def _rel_fro(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("rank", [4, 0])
@pytest.mark.parametrize("s", [64, 49])
def test_convffn_bwd_math_matches_jax_kernel_f32(s, rank, monkeypatch):
    """Every output to 1e-5 relative Frobenius error; S = 49 is padded to 56
    by JAX (padded rows give zero contributions on both sides). Rank 0's
    adapter gradients are zero on both sides (its adapters are zeros)."""
    y, p = _inputs(s, rank, seed=30 + s + rank)
    df = np.random.default_rng(s + rank).standard_normal(y.shape).astype(np.float32)
    want_dy, want = _jax_vjp(y, df, p, jnp.float32, monkeypatch)
    got_dy, got = _port_bwd(y, df, p, torch.float32)
    assert _rel_fro(got_dy, want_dy) < 1e-5
    for k in GRAD_FIELDS:
        if rank == 0 and k in ("a1", "b1l", "a2", "b2l"):
            assert not got[k].any() and not want[k].any(), k
            continue
        assert got[k].shape == want[k].shape, k
        assert _rel_fro(got[k], want[k]) < 1e-5, (k, _rel_fro(got[k], want[k]))


@pytest.mark.parametrize("s", [64, 49])
def test_convffn_bwd_math_matches_jax_kernel_bf16(s, monkeypatch):
    """bf16 activations, f32 parameters cast inside: dy within two bf16 ulps
    of its largest magnitude (the forward test's bound: the jitted kernel's
    GELU polynomial may flip a rounding of g or dh; measured half an ulp).
    The parameter gradients are f32 sums over bf16-rounded terms (a flipped
    rounding of dh or du moves a whole row's share): each within 1e-2 of its
    largest magnitude (measured at most 4.6e-3, dA2 at S = 64)."""
    y, p = _inputs(s, 4, seed=40 + s)
    df = np.random.default_rng(50 + s).standard_normal(y.shape).astype(np.float32)
    want_dy, want = _jax_vjp(y, df, p, jnp.bfloat16, monkeypatch)
    got_dy, got = _port_bwd(y, df, p, torch.bfloat16)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want_dy).max())) - 7)
    assert np.abs(got_dy - want_dy).max() <= 2 * ulp
    for k in GRAD_FIELDS:
        assert np.abs(got[k] - want[k]).max() <= 1e-2 * np.abs(want[k]).max(), k


def test_convffn_bwd_math_matches_torch_autograd():
    """In f32, the hand-written backward equals autograd of convffn_math."""
    y, p = _inputs(49, 4, seed=60)
    df = np.random.default_rng(61).standard_normal(y.shape).astype(np.float32)
    leaves = {k: torch.from_numpy(v).requires_grad_(k in GRAD_FIELDS) for k, v in p.items()}
    yt = torch.from_numpy(y).requires_grad_()
    tconvffn.convffn_math(yt, tconvffn.ConvFFNParams(**leaves), S_LORA).backward(
        torch.from_numpy(df))
    got_dy, got = _port_bwd(y, df, p, torch.float32)
    assert _rel_fro(got_dy, yt.grad.numpy()) < 1e-5
    for k in GRAD_FIELDS:
        assert _rel_fro(got[k], leaves[k].grad.numpy()) < 1e-5, k


def _train_leaves(p, dtype):
    """The parameters as a train step holds them: the BN affine and the LoRA
    matrices f32 leaves that require grad, the frozen weights in ``dtype``."""
    out = {}
    for k, v in p.items():
        t = torch.from_numpy(v)
        if k in GRAD_FIELDS:
            t.requires_grad_()
        elif k in ("w1", "w2"):
            t = t.to(dtype)
        out[k] = t
    return tconvffn.ConvFFNParams(**out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convffn_train_on_cpu_is_the_plain_backward(dtype):
    """On CPU tensors convffn_train's forward is convffn_math and its
    backward convffn_bwd_math, bit for bit, and no kernel launches; the f32
    LoRA and BN-affine leaves get f32 gradients (JAX's f32 masters)."""
    y, p = _inputs(49, 4, seed=70)
    df = torch.from_numpy(np.random.default_rng(71).standard_normal(y.shape)
                          .astype(np.float32)).to(dtype)
    leaves = _train_leaves(p, dtype)
    yt = torch.from_numpy(y).to(dtype).requires_grad_()
    tconvffn.LAUNCHES.update(dict.fromkeys(tconvffn.LAUNCHES, 0))
    out = tconvffn.convffn_train(yt, leaves, S_LORA)
    assert type(out.grad_fn).__name__ == "_ConvFFNTrainBackward"
    cast = tconvffn._cast(leaves, dtype)
    with torch.no_grad():
        assert torch.equal(out, tconvffn.convffn_math(yt, cast, S_LORA))
    out.backward(df)
    want_dy, want = tconvffn.convffn_bwd_math(yt.detach(), df, cast, S_LORA)
    assert torch.equal(yt.grad, want_dy)
    for k in GRAD_FIELDS:
        g = getattr(leaves, k).grad
        assert g.dtype == torch.float32 and torch.equal(g, getattr(want, k)), k
    assert all(n == 0 for n in tconvffn.LAUNCHES.values())


@pytest.mark.parametrize("field", ["w1", "b1", "w2", "b2"])
def test_convffn_train_refuses_trainable_base_weights(field):
    """JAX's backward returns zero cotangents for fc1/fc2 (frozen-backbone
    LoRA): a base weight that requires grad is refused, not given zeros."""
    y, p = _inputs(16, 4, seed=80)
    leaves = _train_leaves(p, torch.float32)
    leaves = leaves._replace(**{field: getattr(leaves, field).clone().requires_grad_()})
    with pytest.raises(ValueError, match="requires grad"):
        tconvffn.convffn_train(torch.from_numpy(y), leaves, S_LORA)


def test_bwd_cost_counts_the_products_and_bytes():
    """The t8 step's ten backward launches at bs=128 (256² input, rank 8):
    three products of 2*B*S*C*H per launch (217.4 GFLOP) and the rank-8
    terms (39.4), 0.260 ms on an H100 at 989 TFLOP/s against 0.193 ms for
    their 0.648 GB: bound by operations."""
    stages = [(48, 144, 4096, 2), (96, 288, 1024, 2), (192, 576, 256, 4), (384, 1152, 64, 2)]
    flops = nbytes = 0
    for c, h, s, n in stages:
        f, b = tconvffn.convffn_bwd_cost(128, s, c, h, 8)
        m = 128 * s
        assert f == 6 * m * c * h + 2 * m * 8 * (5 * c + 6 * h)
        assert b == (3 * m * c * 2 + (2 * c * h + 16 * (c + h)) * 2 + (2 * c + h) * 4
                     + 2 * 128 * 8 * 4 + (2 * c + 16 * (c + h)) * 4)
        flops, nbytes = flops + n * f, nbytes + n * b
    assert abs(flops / 989e12 * 1e3 - 0.260) < 1e-3
    assert abs(nbytes / 3.35e12 * 1e3 - 0.193) < 1e-3
