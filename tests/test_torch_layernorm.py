"""The gated LayerNorm: ``ops/layernorm.fused_layernorm`` (its plain version
on the CPU) against the JAX package's ``fused_layernorm``, which runs
``_ln_kernel`` in interpret mode, and ``layernorm_reference``; and the gate
``DINO_POSE_TPU_LN=pallas`` on the tiny pose model against JAX's under the
same gate.

Tolerances: f32 to 1e-6 abs/rel, JAX's own for its kernel
(tests/test_layernorm_kernel.py; the f32 sums in another order); bf16
within one ulp of the larger magnitude plus that 1e-6 elementwise (one
rounding of f32 values that differ in their last bits; where the bias
cancels the normalised value, an f32 difference in the last bits of terms
of size ~1 is more than one ulp of the small result: measured 2 ulps of a
value near zero); gradients to 1e-4, JAX's own. The pose model in f32 to 1e-4 abs
(tests/test_torch_model.py), the backbone's LoRA gradients under a seeded
cotangent to 1e-5 relative Frobenius (tests/test_torch_train.py). The kernel
itself is held against its plain version on the card by
tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from dino_pose_tpu.models import vit as jvit
from dino_pose_tpu.models.pose import DinoPoseModule as JaxPoseModule
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu.ops import layernorm as jln
from dino_pose_tpu_torch.io.convert import state_dict_from_jax
from dino_pose_tpu_torch.models import vit as tvit
from dino_pose_tpu_torch.ops import block as tblock
from dino_pose_tpu_torch.ops import layernorm as tln
from test_torch_train import _port_model, _randomise

EPS = 1e-6


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    bias = rng.uniform(-1, 1, shape[-1]).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", [(2, 257, 384), (5, 384), (1, 130, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_layernorm_matches_jax_kernel(shape, dtype, monkeypatch):
    """JAX's own shapes (ragged row counts: it pads them to 512 rows, the
    port takes them as they are)."""
    calls = []
    orig = jln._ln_kernel
    monkeypatch.setattr(jln, "_ln_kernel", lambda *a, **k: calls.append(1) or orig(*a, **k))
    x, scale, bias = _inputs(shape, 0)
    xj = jnp.asarray(x, dtype)
    want = jln.fused_layernorm(xj, jnp.asarray(scale), jnp.asarray(bias), EPS)
    ref = jln.layernorm_reference(xj, jnp.asarray(scale), jnp.asarray(bias), EPS)
    assert calls
    tblock.reset_launches()
    got = tln.fused_layernorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(scale), torch.from_numpy(bias), EPS)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    assert all(n == 0 for n in tblock.LAUNCHES.values())
    got = got.float().numpy()
    for w in (want, ref):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, w, atol=1e-6, rtol=1e-6)
        else:
            mag = np.maximum(np.abs(got), np.abs(w))
            ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
            assert np.all(np.abs(got - w) <= ulp + 1e-6)


def test_fused_layernorm_gradients_match_jax():
    """The backward is autograd of the plain formula, as JAX's ``_bwd`` is
    ``jax.vjp`` of ``layernorm_reference``: x, scale and bias gradients of
    sum(y**2) against ``jax.grad`` through JAX's ``fused_layernorm``."""
    x, scale, bias = _inputs((3, 70, 128), 1)
    want = jax.grad(lambda *a: jnp.sum(jln.fused_layernorm(*a, EPS) ** 2), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    (tln.fused_layernorm(*args, EPS) ** 2).sum().backward()
    for a, w in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_validation_cache_revalidates_after_an_in_place_update():
    """``check_operands`` converts and checks scale and bias once per
    (tensor, version): a second call returns the same f32 views; an in-place
    update of scale moves its ``_version``, and the next call converts it
    again (the new values, not the cached ones)."""
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((4, 384), 3))
    scale = scale.to(torch.bfloat16)
    d, s1, b1 = tln.check_operands(x, scale, bias)
    assert d == 384 and s1.dtype == torch.float32 and torch.equal(s1, scale.float())
    _, s2, b2 = tln.check_operands(x, scale, bias)
    assert s2 is s1 and b2 is b1
    scale.mul_(2)
    _, s3, b3 = tln.check_operands(x, scale, bias)
    assert s3 is not s1 and torch.equal(s3, scale.float()) and not torch.equal(s3, s1)
    bias.add_(1)
    _, s4, b4 = tln.check_operands(x, scale, bias)
    assert s4 is not s3 and b4 is not b1 and torch.equal(b4, bias)


@pytest.mark.parametrize("case", ["dtype", "width", "too_wide", "strided", "unaligned",
                                  "scale_shape", "scale_device"])
def test_refusals_run_on_the_cpu(case):
    """Every refusal of the card's wrapper is raised by ``check_operands``,
    which runs on any device: a wrong dtype, a width the kernel does not
    take, an x that is not contiguous or not 16-byte aligned, scale or bias
    of the wrong shape or on another device; also after the pair was cached."""
    x, scale, bias = (torch.from_numpy(a) for a in _inputs((4, 384), 4))
    tln.check_operands(x, scale, bias)
    if case == "dtype":
        args, err, match = (x.half(), scale, bias), TypeError, "bf16 or f32"
    elif case == "width":
        args, err, match = (torch.zeros(4, 100), scale[:100], bias[:100]), ValueError, "multiple of 8"
    elif case == "too_wide":
        args, err, match = (torch.zeros(2, 8192), torch.ones(8192), torch.zeros(8192)), \
            ValueError, "multiple of 8"
    elif case == "strided":
        args, err, match = (torch.zeros(384, 8).t(), scale, bias), ValueError, "contiguous"
    elif case == "unaligned":
        args, err, match = (torch.zeros(4 * 384 + 1)[1:].view(4, 384), scale, bias), \
            ValueError, "16-byte aligned"
    elif case == "scale_shape":
        args, err, match = (x, scale[:192], bias), ValueError, "scale and bias"
    else:
        args, err, match = (x, scale, bias.to("meta")), ValueError, "scale and bias"
    with pytest.raises(err, match=match):
        tln.check_operands(*args)


def test_layernorm_cost():
    flops, nbytes = tln.layernorm_cost(128 * 257, 384, 2)
    assert nbytes == 128 * 257 * 384 * 4 + 2 * 384 * 4 and flops == 8 * 128 * 257 * 384


@pytest.fixture(scope="module")
def jax_pose():
    vit = dataclasses.replace(jvit.VIT_PRESETS["test/vit-tiny"], lora_layers=(1,),
                              lora_dropout=0.0)
    module = JaxPoseModule(vit=vit, num_keypoints=24, heatmap_size=48)
    variables = jax.jit(module.init)(jax.random.key(0), jnp.zeros((1, 3, 224, 224)))
    return module, _randomise(jax.device_get(variables), np.random.default_rng(21))


@pytest.fixture
def ln_gate(monkeypatch):
    """``DINO_POSE_TPU_LN=pallas`` on both sides; counts JAX's ``_ln_kernel``
    traces and the port's ``fused_layernorm`` calls from models/vit.py."""
    monkeypatch.setenv("DINO_POSE_TPU_LN", "pallas")
    calls = {"jax": 0, "port": 0}
    orig_j, orig_t = jln._ln_kernel, tvit.fused_layernorm

    def count_j(*a, **k):
        calls["jax"] += 1
        return orig_j(*a, **k)

    def count_t(*a, **k):
        calls["port"] += 1
        return orig_t(*a, **k)

    monkeypatch.setattr(jln, "_ln_kernel", count_j)
    monkeypatch.setattr(tvit, "fused_layernorm", count_t)
    return calls


def test_gated_pose_model_matches_jax(jax_pose, ln_gate):
    """The tiny pose model's final norm through ``fused_layernorm`` (one call
    a forward; none with ``kernels=False``, the plain path), heatmaps and z
    against JAX's under the same gate."""
    module, variables = jax_pose
    pixels = np.random.default_rng(22).standard_normal((2, 3, 224, 224)).astype(np.float32)
    with jdispatch.local():
        hm_j, z_j = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables,
                                                                           jnp.asarray(pixels))
    assert ln_gate["jax"] == 1
    tm = _port_model(variables)
    with torch.inference_mode():
        hm, z = tm(torch.from_numpy(pixels))
        assert ln_gate["port"] == 1
        tm(torch.from_numpy(pixels), kernels=False)
    assert ln_gate["port"] == 1
    np.testing.assert_allclose(hm.numpy(), np.asarray(hm_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=1e-4, rtol=0)


def test_gated_backbone_lora_grads_match_jax(jax_pose, ln_gate):
    """The backbone's LoRA gradients under a seeded cotangent on its tokens,
    through the gated final norm's backward on both sides, against
    ``jax.vjp``."""
    module, variables = jax_pose
    flat = traverse_util.flatten_dict(variables["params"]["backbone"])
    lora = {k: jnp.asarray(v) for k, v in flat.items() if k[-1] in ("lora_A", "lora_B")}
    pixels = np.random.default_rng(23).standard_normal((2, 3, 224, 224)).astype(np.float32)
    backbone = jvit.Dinov2Backbone(module.vit)

    def tokens(leaves):
        params = traverse_util.unflatten_dict({**flat, **leaves})
        return backbone.apply({"params": params}, jnp.transpose(jnp.asarray(pixels), (0, 2, 3, 1)),
                              deterministic=True)[0]

    with jdispatch.local():
        out, vjp = jax.vjp(tokens, lora)
        ct = np.random.default_rng(24).standard_normal(out.shape).astype(np.float32)
        (jgrads,) = vjp(jnp.asarray(ct))
    assert ln_gate["jax"] >= 1
    tm = _port_model(variables).train()
    got, _ = tm.backbone(torch.from_numpy(pixels))
    got.backward(torch.from_numpy(ct))
    assert ln_gate["port"] == 1
    gflat = traverse_util.flatten_dict(jax.tree.map(np.zeros_like, variables["params"]))
    gflat.update({("backbone",) + k: np.asarray(g) for k, g in jgrads.items()})
    want = state_dict_from_jax({"params": traverse_util.unflatten_dict(gflat),
                                "batch_stats": variables["batch_stats"]}, tm)
    names = [n for n, p in tm.named_parameters() if p.grad is not None]
    assert len(names) == 2
    for n in names:
        g, w = dict(tm.named_parameters())[n].grad.numpy(), want[n].numpy()
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert np.abs(w).max() > 0 and rel < 1e-5, f"{n}: relative Frobenius error {rel:.3e}"
