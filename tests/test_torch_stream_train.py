"""A trainable dinov2-base or -large block's rounding route: the port's
weight-streamed training halves (``mlp_part_stream_train_math``,
``mlp_stream_bwd_math``, ``attn_stream_bwd_math``, the autograd functions
``attn_part_stream_train`` and ``mlp_part_stream_train`` behind
``Block.forward``) against ``jax.vjp`` of the JAX package's
``fused_mlp_part_stream`` with trainable weights and ``fused_attn_part_stream``,
whose backward runs ``_mlp_stream_train_kernel``, ``_mlp_stream_dx_full_kernel``,
``_mlp_stream_dw_kernel``, ``_attn_stream_dx_kernel`` and
``_attn_stream_dw_kernel`` (interpret mode on the CPU).

Width D = 128, 2 heads of 64, S = 57, batch 2, where JAX's streaming plans
exist (as tests/test_torch_stream.py, whose helpers these tests share): the
JAX kernels run jitted with ``xla_allow_excess_precision`` off, so that
XLA:CPU keeps the bf16 round trips they write. Tolerances: f32 to 1e-5
abs/rel (summation order only). bf16: outputs and dx within one ulp of
the tensor's largest magnitude on a stated share of the elements, each
weight gradient (an f32 sum over the rows of bf16-rounded terms, in another
order) to a stated relative Frobenius error; each limit is stated beside the
value measured. The witness shows that ``block_train``'s rounding
(``_block_kernel`` and its backward kernels) differs from JAX's streamed
training route on a stated share of dx elements, so the bf16 tests see the
route. The whole D = 128 pose model's unfreeze-last-1 step runs on the
streamed route on both sides over two f32 steps, held as
tests/test_torch_train.py holds the dinov2-small unfreeze step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from dino_pose_tpu.models import registry as jregistry
from dino_pose_tpu.models import vit as jvit
from dino_pose_tpu.nn import layers as jlayers
from dino_pose_tpu.ops import block as jblock
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu_torch.models import vit as tvit
from dino_pose_tpu_torch.ops import block as tblock
from test_torch_stream import D, EPS, H, _jax_block_params, _jit, _port_block
from test_torch_stream import _count_kernels as count_kernels
from test_torch_train import _ABOVE_LAST_RELU, _BLOCK_LEAVES, _NoDropout, _two_steps_match_jax

BWD_KERNELS = ("_mlp_stream_train_kernel", "_mlp_stream_dx_full_kernel", "_mlp_stream_dw_kernel",
               "_attn_stream_dx_kernel", "_attn_stream_dw_kernel")
FWD_KERNELS = ("_block_kernel", "_attn_part_kernel", "_mlp_part_kernel", "_attn_stream_kernel",
               "_mlp_stream_kernel", "_mlp_bwd_kernel", "_attn_bwd_kernel")
S, B = 57, 2


def _count_kernels(monkeypatch) -> dict:
    return count_kernels(monkeypatch, BWD_KERNELS + FWD_KERNELS)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(21)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.05  # noqa: E731
    p = dict(g1=1 + r(D), b1=r(D), wqkv=r(D, 3 * D), bqkv=r(3 * D), wo=r(D, D), bo=r(D),
             ls1=rng.uniform(0.1, 1.0, D).astype(np.float32), g2=1 + r(D), b2=r(D),
             w1=r(D, 4 * D), bf1=r(4 * D), w2=r(4 * D, D), bf2=r(D),
             ls2=rng.uniform(0.1, 1.0, D).astype(np.float32))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    dy = rng.standard_normal((B, S, D)).astype(np.float32)
    return x, dy, p


def _half_fields(name):
    return (jblock.AttnParams if name == "attn" else jblock.MlpParams)._fields


def _jax_vjp(name, x, dy, p, dtype):
    """``jax.vjp`` of JAX's streamed half with trainable f32 weights, ``x``
    and the cotangent in ``dtype``: (output, dx, {field: gradient})."""
    fields = _half_fields(name)
    half = (jblock.AttnParams if name == "attn" else jblock.MlpParams)(
        *(jnp.asarray(p[f]) for f in fields))

    def fn(a, hp, ct):
        if name == "attn":
            out, vjp = jax.vjp(lambda a_, p_: jblock.fused_attn_part_stream(a_, p_, H, EPS), a, hp)
        else:
            out, vjp = jax.vjp(lambda a_, p_: jblock.fused_mlp_part_stream(a_, p_, EPS), a, hp)
        return (out, *vjp(ct))

    out, dx, grads = _jit(fn, jnp.asarray(x).astype(dtype), half, jnp.asarray(dy).astype(dtype))
    f32 = lambda t: np.asarray(jnp.asarray(t).astype(jnp.float32))  # noqa: E731
    return f32(out), f32(dx), {f: f32(getattr(grads, f)) for f in fields}


def _port_vjp(name, x, dy, p, dtype):
    """The port's plain streamed half and its backward: (output, dx, grads)."""
    fields = _half_fields(name)
    cls = tblock.AttnParams if name == "attn" else tblock.MlpParams
    hp = tblock.cast_params(cls(*(torch.from_numpy(p[f]) for f in fields)), dtype)
    tx, tdy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    if name == "attn":
        out = tblock.attn_part_stream_math(tx, hp, num_heads=H, eps=EPS)
        dx, grads = tblock.attn_stream_bwd_math(tx, tdy, hp, num_heads=H, eps=EPS)
    else:
        out, h2 = tblock.mlp_part_stream_train_math(tx, hp, eps=EPS)
        dx, grads = tblock.mlp_stream_bwd_math(tx, tdy, h2, hp, eps=EPS)
    np32 = lambda t: t.float().numpy()  # noqa: E731
    return np32(out), np32(dx), {f: np32(getattr(grads, f)) for f in fields}


def _rel_fro(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ulp_of_max_check(got: np.ndarray, want: np.ndarray, max_share: float) -> float:
    """bf16: every element within one ulp of the tensor's largest magnitude,
    and at most ``max_share`` of them differing. Returns the share."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp, f"max {np.abs(got - want).max() / ulp:.3g} ulps"
    share = float((got != want).mean())
    assert share <= max_share, f"{share:.3g} of the elements differ"
    return share


# bf16 limits of the halves against JAX: the share of output and dx
# elements that differ (each within one ulp of the tensor's largest
# magnitude), and the relative Frobenius error of each weight gradient.
# Measured: MLP 0 and 5.5e-4 of the elements, gradients at most 3.7e-5.
# Attention 6.3% and 10.6%, gradients at most 5.4e-4: one element of LN1's
# output (of 14592) rounds the other way in the two frameworks (their f32
# mean and variance sum in another order), which moves 51 of that row's
# qkv elements by one ulp and, through K and V, every row of that image; the
# f32 test and the whole-block test below (dx 3.0%, its witness 15%) hold
# the rounding route itself.
HALF_BF16_LIMITS = {"attn": (0.15, 2e-3), "mlp": (1e-3, 2e-3)}


@pytest.mark.parametrize("name", ["attn", "mlp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_backward_plain_versions_match_jax(arrays, name, dtype, monkeypatch):
    x, dy, p = arrays
    calls = _count_kernels(monkeypatch)
    want = _jax_vjp(name, x, dy, p, jnp.dtype(dtype))
    if name == "attn":
        assert calls["_attn_stream_kernel"] == 1
        assert calls["_attn_stream_dx_kernel"] == calls["_attn_stream_dw_kernel"] == 1
    else:
        assert calls["_mlp_stream_train_kernel"] == 1 and calls["_mlp_stream_kernel"] == 0
        assert calls["_mlp_stream_dx_full_kernel"] == calls["_mlp_stream_dw_kernel"] == 1
    got = _port_vjp(name, x, dy, p, getattr(torch, dtype))
    fields = _half_fields(name)
    if dtype == "float32":
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
        for f in fields:
            np.testing.assert_allclose(got[2][f], want[2][f], atol=1e-5, rtol=1e-5, err_msg=f)
        return
    share, fro = HALF_BF16_LIMITS[name]
    for g, w in zip(got[:2], want[:2]):
        _ulp_of_max_check(g, w, share)
    for f in fields:
        assert _rel_fro(got[2][f], want[2][f]) <= fro, (f, _rel_fro(got[2][f], want[2][f]))


@pytest.mark.parametrize("name", ["attn", "mlp"])
def test_stream_train_wrappers_on_cpu_are_the_plain_versions(arrays, name):
    x, dy, p = arrays
    fields = _half_fields(name)
    cls = tblock.AttnParams if name == "attn" else tblock.MlpParams
    hp = tblock.cast_params(cls(*(torch.from_numpy(p[f]) for f in fields)), torch.bfloat16)
    tx, tdy = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(dy).to(torch.bfloat16)
    tblock.reset_launches()
    if name == "attn":
        got = tblock.fused_attn_bwd_stream(tx, tdy, hp, H, EPS)
        want = tblock.attn_stream_bwd_math(tx, tdy, hp, num_heads=H, eps=EPS)
    else:
        y, h2 = tblock.fused_mlp_part_stream_train(tx, hp, EPS)
        wy, wh2 = tblock.mlp_part_stream_train_math(tx, hp, eps=EPS)
        assert torch.equal(y, wy) and torch.equal(h2, wh2)
        assert torch.equal(y, tblock.mlp_part_stream_math(tx, hp, eps=EPS))
        got = tblock.fused_mlp_bwd_stream(tx, tdy, h2, hp, EPS)
        want = tblock.mlp_stream_bwd_math(tx, tdy, h2, hp, eps=EPS)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(g, w) for g, w in zip(got[1], want[1]))
    assert all(n == 0 for n in tblock.LAUNCHES.values())


def test_stream_mlp_backward_reads_the_saved_h2(arrays):
    """dls2 and dbf2 come from the h2 the forward saved and from sum(dy)
    (JAX's XLA reductions), the other gradients as the resident backward
    computes them: in f32 both routes agree to summation order."""
    x, dy, p = arrays
    mp = tblock.MlpParams(*(torch.from_numpy(p[f]) for f in tblock.MlpParams._fields))
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    _, h2 = tblock.mlp_part_stream_train_math(tx, mp, eps=EPS)
    dx, got = tblock.mlp_stream_bwd_math(tx, tdy, h2, mp, eps=EPS)
    dx_r, want = tblock.mlp_bwd_math(tx, tdy, mp, eps=EPS)
    assert torch.equal(dx, dx_r)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got.ls2, (tdy * h2).sum((0, 1)))
    # A stale h2 moves dls2 and nothing else.
    _, stale = tblock.mlp_stream_bwd_math(tx, tdy, h2 * 1.5, mp, eps=EPS)
    assert not torch.allclose(stale.ls2, got.ls2)
    assert all(torch.equal(a, b) for f, a, b in zip(mp._fields, stale, got) if f != "ls2")


# ---------------------------------------------------------------------------
# A trainable block against JAX's vit Block on its streamed training route
# ---------------------------------------------------------------------------

def _jax_block_vjp(p, x, dy, dtype, monkeypatch):
    """JAX's trainable vit ``Block`` (width D, ``DINO_POSE_TPU_BLOCK=stream``)
    and its vjp: (y, dx, flat {param path: gradient})."""
    monkeypatch.setenv("DINO_POSE_TPU_BLOCK", "stream")
    cfg = dataclasses.replace(jvit.VIT_PRESETS["test/vit-tiny"], hidden_size=D, num_heads=H)
    blk = jvit.Block(cfg, frozen=False)
    variables = jax.tree.map(jnp.asarray, _jax_block_params(p))

    def fn(v, a, ct):
        out, vjp = jax.vjp(lambda v_, a_: blk.apply(v_, a_, deterministic=False), v, a)
        return (out, *vjp(ct))

    with jdispatch.local():
        y, gv, dx = _jit(fn, variables, jnp.asarray(x).astype(dtype), jnp.asarray(dy).astype(dtype))
    f32 = lambda t: np.asarray(jnp.asarray(t).astype(jnp.float32))  # noqa: E731
    flat = traverse_util.flatten_dict(gv["params"])
    return f32(y), f32(dx), {k: f32(v) for k, v in flat.items()}


def _port_block_grads(blk) -> dict:
    """The port block's gradients keyed by the JAX parameter paths."""
    sa = blk.attention.attention
    t = lambda w: w.grad.t().numpy()  # noqa: E731
    b = lambda w: w.grad.numpy()  # noqa: E731
    return {
        ("norm1", "scale"): b(blk.norm1.weight), ("norm1", "bias"): b(blk.norm1.bias),
        ("attention", "query", "kernel"): t(sa.query.weight),
        ("attention", "query", "bias"): b(sa.query.bias),
        ("attention", "key", "kernel"): t(sa.key.weight),
        ("attention", "key", "bias"): b(sa.key.bias),
        ("attention", "value", "kernel"): t(sa.value.weight),
        ("attention", "value", "bias"): b(sa.value.bias),
        ("attention", "out", "kernel"): t(blk.attention.output.dense.weight),
        ("attention", "out", "bias"): b(blk.attention.output.dense.bias),
        ("layerscale1",): b(blk.layer_scale1.lambda1),
        ("norm2", "scale"): b(blk.norm2.weight), ("norm2", "bias"): b(blk.norm2.bias),
        ("fc1", "kernel"): t(blk.mlp.fc1.weight), ("fc1", "bias"): b(blk.mlp.fc1.bias),
        ("fc2", "kernel"): t(blk.mlp.fc2.weight), ("fc2", "bias"): b(blk.mlp.fc2.bias),
        ("layerscale2",): b(blk.layer_scale2.lambda1),
    }


def _port_block_vjp(p, x, dy, dtype, route, monkeypatch):
    """The port's trainable ``Block`` on ``route`` (forced), plain versions:
    (y, dx, grads by JAX path)."""
    monkeypatch.setattr(tvit, "block_route", lambda *a, **k: route)
    blk = _port_block(p)
    for w in blk.parameters():
        w.requires_grad_(True)
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    tblock.reset_launches()
    y = blk(tx)
    y.backward(torch.from_numpy(dy).to(dtype))
    assert all(n == 0 for n in tblock.LAUNCHES.values())
    return y.detach().float().numpy(), tx.grad.float().numpy(), _port_block_grads(blk)


# bf16 limits of a trainable block on the streamed route against JAX's:
# the share of y and dx elements that differ, each within one ulp of the
# tensor's largest magnitude (measured 1.8% and 3.0%; the resident route
# 20% and 15%, the witness below), the relative Frobenius error of each
# weight gradient but dls1 (measured at most 1.5e-3; the resident route up
# to 5.9e-3) and of dls1 (measured 8.7e-3, the resident route 9.3e-3),
# which both frameworks take from the autodiff of the bf16 stitch
# o * bf16(ls1): a bf16 product, summed over the rows. The key bias's true
# gradient is zero (a constant added to a query's scores leaves its softmax
# unchanged): both sides hold roundoff there, below 1e-3 of the largest
# gradient.
BLOCK_ULP_SHARE, BLOCK_GRAD_FRO, BLOCK_DLS1_FRO = 0.05, 3e-3, 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainable_block_on_the_stream_route_matches_jax(arrays, dtype, monkeypatch):
    x, dy, p = arrays
    calls = _count_kernels(monkeypatch)
    want = _jax_block_vjp(p, x, dy, jnp.dtype(dtype), monkeypatch)
    assert all(calls[k] == 1 for k in BWD_KERNELS + ("_attn_stream_kernel",)), calls
    assert calls["_mlp_stream_kernel"] == calls["_block_kernel"] == calls["_mlp_bwd_kernel"] == 0
    got = _port_block_vjp(p, x, dy, getattr(torch, dtype), "stream", monkeypatch)
    assert set(got[2]) == set(want[2])
    scale = max(np.abs(w).max() for w in want[2].values())
    if dtype == "float32":
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
        for k, w in want[2].items():
            np.testing.assert_allclose(got[2][k], w, atol=1e-5 * scale, rtol=1e-5, err_msg=str(k))
        return
    for g, w in zip(got[:2], want[:2]):
        _ulp_of_max_check(g, w, BLOCK_ULP_SHARE)
    for k, w in want[2].items():
        if np.linalg.norm(w) < 1e-3 * scale:  # the key bias: a true zero
            assert np.linalg.norm(got[2][k] - w) <= 1e-3 * scale, k
            continue
        tol = BLOCK_DLS1_FRO if k == ("layerscale1",) else BLOCK_GRAD_FRO
        assert _rel_fro(got[2][k], w) <= tol, (k, _rel_fro(got[2][k], w))


def test_block_train_rounding_differs_from_jax_stream_route(arrays, monkeypatch):
    """The witness: in bf16 the port's resident trainable route
    (``block_train``: ``_block_kernel``'s forward, ``_mlp_bwd_kernel`` and
    ``_attn_bwd_kernel``'s backward) differs from JAX's streamed training
    route on >= 10% of the output and of the dx elements (measured 20% and
    15%), where the streamed route differs on at most 5% (the test above,
    measured 1.8% and 3.0%): the bf16 tests see the route."""
    x, dy, p = arrays
    want = _jax_block_vjp(p, x, dy, jnp.bfloat16, monkeypatch)
    got = _port_block_vjp(p, x, dy, torch.bfloat16, "block", monkeypatch)
    assert (got[0] != want[0]).mean() >= 0.10
    assert (got[1] != want[1]).mean() >= 0.10


@pytest.mark.parametrize("s", [257, 1297])
def test_trainable_small_block_keeps_block_train(s, monkeypatch):
    """A trainable dinov2-small block (D = 384) goes through ``block_train``
    at 224² and 504², as JAX's ``dispatch_block_train`` / ``block_math``:
    ``block_route(..., training=True)`` gives "block" and "math", and the
    streamed halves are never called."""
    cfg = tvit.VIT_PRESETS["facebook/dinov2-small"]
    assert tblock.block_route(cfg.hidden_size, s, cfg.num_heads, 4 * cfg.hidden_size, 2,
                              lora=False, training=True) == {257: "block", 1297: "math"}[s]
    seen = []
    monkeypatch.setattr(tvit, "block_train", lambda x, *a, **k: seen.append("block_train") or x)
    for name in ("attn_part_stream_train", "mlp_part_stream_train"):
        monkeypatch.setattr(tvit, name, lambda *a, _n=name, **k: seen.append(_n))
    blk = tvit.Block(cfg)
    x = torch.zeros(1, s, cfg.hidden_size, dtype=torch.bfloat16)
    blk(x)
    assert seen == ["block_train"]


@pytest.mark.parametrize("s", [257, 1297])
@pytest.mark.parametrize("model", ["facebook/dinov2-base", "facebook/dinov2-large"])
def test_trainable_route_at_full_width_matches_jax_vjp(model, s, monkeypatch):
    """JAX's vjp of a trainable vit ``Block`` at full width, traced on a
    patched single TPU (``jax.eval_shape``: nothing runs), reaches the
    streamed forward and all five streamed backward kernels at S = 257 (their
    backward plans exist at one row a program: ~12.7 MB at D = 768 and ~16.3
    MB at D = 1024 of the 16 MiB budget) and none at S = 1297; the port's
    ``block_route(..., training=True)`` says "stream" and "math", and its
    Block takes the streamed halves exactly there."""
    monkeypatch.setattr(jblock, "_dispatch_target", lambda: ("tpu", 1))
    monkeypatch.delenv("DINO_POSE_TPU_BLOCK", raising=False)
    calls = _count_kernels(monkeypatch)
    cfg = jvit.VIT_PRESETS[model]
    d = cfg.hidden_size
    blk = jvit.Block(cfg, frozen=False)
    x = jax.ShapeDtypeStruct((1, s, d), jnp.bfloat16)
    shapes = jax.eval_shape(lambda a: blk.init(jax.random.key(0), a, deterministic=False), x)
    for k in calls:
        calls[k] = 0

    def fn(v, a):
        out, vjp = jax.vjp(lambda v_, a_: blk.apply(v_, a_, deterministic=False), v, a)
        return vjp(out)

    jax.eval_shape(fn, shapes, x)
    route = tblock.block_route(d, s, cfg.num_heads, d * cfg.mlp_ratio, 2, lora=False,
                               training=True)
    if s == 257:
        assert all(calls[k] == 1 for k in BWD_KERNELS + ("_attn_stream_kernel",)), calls
        assert route == "stream"
    else:
        assert not any(calls.values()) and route == "math", calls


# ---------------------------------------------------------------------------
# The D = 128 pose model's unfreeze-last-1 train step on the streamed route
# ---------------------------------------------------------------------------

CONFIG = {"model_name": "test/vit-tiny", "use_lora": False, "unfreeze_last_n_layers": 1}


def test_unfreeze_train_step_on_the_stream_route_matches_jax(monkeypatch):
    """Two f32 unfreeze-last-1 train steps (no dropout) of ``test/vit-tiny``
    widened to D = 128 (2 heads of 64, 2 layers) against JAX's, both blocks
    on the streamed route (``DINO_POSE_TPU_BLOCK=stream``; the port's
    ``block_route`` forced): layer 1 trains through JAX's five streamed
    kernels and the port's streamed training halves. Held as
    tests/test_torch_train.py holds the dinov2-small unfreeze step: losses
    to 1e-5, then 1e-4 at step 2; the leaves above the heads' last ReLU to
    1e-4, the others (the block's 18 included) to 1e-2."""
    for presets, vit_config in ((jvit.VIT_PRESETS, jvit.ViTConfig),
                                (tvit.VIT_PRESETS, tvit.ViTConfig)):
        monkeypatch.setitem(presets, "test/vit-tiny",
                            vit_config(hidden_size=D, num_layers=2, num_heads=H, pos_grid=37))
    monkeypatch.setenv("DINO_POSE_TPU_BLOCK", "stream")
    monkeypatch.setattr(tvit, "block_route", lambda *a, **k: "stream")
    monkeypatch.setattr(jlayers, "Dropout", _NoDropout)
    calls = _count_kernels(monkeypatch)
    jm = jregistry.create_model_from_config(dict(CONFIG), pretrained=False)
    rng = np.random.default_rng(23)
    flat = traverse_util.flatten_dict(jax.device_get(jm.variables))
    for k, v in flat.items():
        if k[-1].startswith("layerscale"):
            flat[k] = rng.uniform(0.1, 1.0, v.shape).astype(np.float32)
        elif k[0] == "batch_stats":
            flat[k] = ((rng.standard_normal(v.shape) * 0.1) if k[-1] == "mean"
                       else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        else:
            flat[k] = np.asarray(v)
    variables = traverse_util.unflatten_dict(flat)
    kps = rng.uniform(10, 214, (B, 24, 3)).astype(np.float32)
    kps[..., 2] = 2.0
    batch = {"image": rng.standard_normal((B, 3, 224, 224)).astype(np.float32),
             "2d_keypoints": kps,
             "z_coords": (rng.standard_normal((B, 24)) * 10).astype(np.float32)}
    grads = _two_steps_match_jax(jm.module, variables, CONFIG, batch, step2_rtol=1e-4,
                                 above=_ABOVE_LAST_RELU)
    assert all(calls[k] >= 1 for k in BWD_KERNELS), calls
    assert calls["_block_kernel"] == calls["_mlp_bwd_kernel"] == calls["_attn_bwd_kernel"] == 0
    blocks = [n for n in grads if n.startswith("backbone.")]
    assert len(blocks) == _BLOCK_LEAVES and all(n.startswith("backbone.encoder.layer.1.")
                                                for n in blocks)
    assert all(np.abs(grads[n]).max() > 0 for n in blocks)
