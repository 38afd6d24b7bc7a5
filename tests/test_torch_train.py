"""The port's training path against the JAX package's, on the CPU in f32.

Inputs are made from numpy seeds and given to both sides. Tolerances:
1e-6 for the target render (f32 products of the same separable factors);
1e-5 abs/rel for losses, loss weights, BatchNorm and the MLP backward (the
JAX suite's own f32 tolerance: summation order only). Relative Frobenius
error of the train step's gradients: 1e-4 for the leaves above the heatmap
head's last ReLU (measured below 5e-6), 1e-2 for every leaf below it, the
LoRA adapters included (measured 1.5e-3 to 4.7e-3 on both routes): the
heads' 2x128x47x47 ReLU maps hold units within roundoff of zero whose gate
can flip between the frameworks, and each flip moves a channel's
BatchNorm-bias gradient (a sum that cancels to 1/40 of its absolute sum)
and the cotangent of everything below it. The LoRA gradients of the
backbone alone, with no gate between them and a seeded cotangent, are held
to 1e-5 (measured below 1e-6). 2*lr per step for parameters after AdamW
(its first step is about lr*sign(g), so a gradient within roundoff of zero
may step the other way), and so 1e-4 abs for the BatchNorm statistics of
step 2, whose batch means run on weights that may differ by that 2*lr
(measured up to 1.5e-5). The unfreeze-last-N step (no LoRA, whole blocks
training) is held the same way, with the exceptions its docstring states;
its block gradients alone, under a seeded cotangent on the backbone's
tokens, to 1e-5. The CUDA kernels themselves are held against their plain
versions on the card by tests/test_torch_cuda.py.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from dino_pose_tpu.data import heatmaps as jheatmaps
from dino_pose_tpu.models.pose import DinoPoseModule as JaxPoseModule
from dino_pose_tpu.models.vit import VIT_PRESETS as JAX_VIT_PRESETS
from dino_pose_tpu.models.vit import Dinov2Backbone as JaxBackbone
from dino_pose_tpu.nn import layers as jlayers
from dino_pose_tpu.ops import block as jblock
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu.train import losses as jlosses
from dino_pose_tpu.train import partition as jpartition
from dino_pose_tpu.train import state as jstate
from dino_pose_tpu.train import step as jstep
from dino_pose_tpu.train import weighting as jweighting
from dino_pose_tpu_torch.data import heatmaps as theatmaps
from dino_pose_tpu_torch.io.convert import (
    dinov2_pose_rules,
    loss_weight_from_jax,
    state_dict_from_jax,
)
from dino_pose_tpu_torch.models import registry as tregistry
from dino_pose_tpu_torch.nn import layers as tlayers
from dino_pose_tpu_torch.ops import block as tblock
from dino_pose_tpu_torch.train import losses as tlosses
from dino_pose_tpu_torch.train import partition as tpartition
from dino_pose_tpu_torch.train import state as tstate
from dino_pose_tpu_torch.train import step as tstep
from dino_pose_tpu_torch.train import weighting as tweighting

EPS = 1e-6
LR, WD = 3e-5, 1e-6  # the training config's defaults (dino_pose_tpu/config.py)
CONFIG = {"model_name": "test/vit-tiny", "use_lora": True, "lora_dropout": 0.0}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Targets
# ---------------------------------------------------------------------------

def _keypoints(rng, b, k, hw):
    h, w = hw
    kps = np.stack([rng.uniform(0, w, (b, k)), rng.uniform(0, h, (b, k)),
                    rng.choice([0.0, 1.0, 2.0], (b, k))], -1).astype(np.float32)
    kps[0, :6] = [[-3.0, 50.0, 2.0], [0.0, 0.0, 2.0], [w - 0.5, h - 0.5, 2.0],
                  [float(w), 10.0, 2.0], [w + 80.0, h + 5.0, 1.0], [40.0, 60.0, 0.0]]
    return kps


@pytest.mark.parametrize("against", ["jax", "jax_host", "port_host"])
@pytest.mark.parametrize("hw", [(224, 224), (200, 160)])
def test_render_heatmaps_matches_jax(hw, against):
    """Invisible, negative, edge and off-image keypoints included. One
    comparison a case, so that a failure names it: ``jax``, the port's
    batched f32 render against JAX's (1e-6); ``jax_host``, each sample of it
    against JAX's numpy host render (f64, rounded once; 1e-6);
    ``port_host``, the port's host render against JAX's, bit for bit."""
    h, w = hw
    kps = _keypoints(np.random.default_rng(0), 3, 24, hw)
    got = theatmaps.render_heatmaps(_t(kps), height=h, width=w, heatmap_size=48).numpy()
    assert got.shape == (3, 24, 48, 48) and got.dtype == np.float32
    assert not got[0, [0, 4, 5]].any()          # x < 0, window off the image, v == 0
    assert min(got[0, c].max() for c in (1, 2, 3)) > 0   # corner, edge, x == w
    if against == "jax":
        want = np.asarray(jheatmaps.render_heatmaps(jnp.asarray(kps), height=h, width=w,
                                                    heatmap_size=48))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for i in range(3):
        host = jheatmaps.render_heatmaps_host(kps[i], (w, h), 48)
        if against == "jax_host":
            np.testing.assert_allclose(got[i], host, atol=1e-6, rtol=0, err_msg=f"sample {i}")
        elif against == "port_host":
            np.testing.assert_array_equal(theatmaps.render_heatmaps_host(kps[i], (w, h), 48),
                                          host, err_msg=f"sample {i}")


@pytest.mark.parametrize("sizes", [(224, 48), (200, 48), (48, 64), (17, 5)])
def test_resize_matrix_matches_jax(sizes):
    np.testing.assert_array_equal(theatmaps.resize_matrix(*sizes),
                                  jheatmaps.resize_matrix(*sizes))


# ---------------------------------------------------------------------------
# Losses and loss weighting
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((3, 24, 16, 16)).astype(np.float32)
    target = rng.random((3, 24, 16, 16)).astype(np.float32)
    conf = rng.choice([0.0, 1.0, 2.0], (3, 24)).astype(np.float32)
    pz = (rng.standard_normal((3, 24)) * 20).astype(np.float32)
    tz = (rng.standard_normal((3, 24)) * 20).astype(np.float32)
    return pred, target, conf, pz, tz


@pytest.mark.parametrize("sample_valid", [None, [1.0, 0.0, 1.0]])
def test_losses_match_jax(loss_inputs, sample_valid):
    pred, target, conf, pz, tz = loss_inputs
    sv_j = None if sample_valid is None else jnp.asarray(sample_valid)
    sv_t = None if sample_valid is None else torch.tensor(sample_valid)
    want_kp = jlosses.keypoint_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(conf), sv_j)
    got_kp = tlosses.keypoint_loss(_t(pred), _t(target), _t(conf), sv_t)
    want_z = jlosses.z_loss(jnp.asarray(pz), jnp.asarray(tz), jnp.asarray(conf), sv_j)
    got_z = tlosses.z_loss(_t(pz), _t(tz), _t(conf), sv_t)
    np.testing.assert_allclose(got_kp.item(), float(want_kp), rtol=1e-5)
    np.testing.assert_allclose(got_z.item(), float(want_z), rtol=1e-5)
    assert got_kp.dtype == got_z.dtype == torch.float32


def test_keypoint_loss_gradient_matches_jax(loss_inputs):
    """The exp(-diff) weight is detached on both sides."""
    pred, target, conf, _, _ = loss_inputs
    want = jax.grad(lambda p: jlosses.keypoint_loss(p, jnp.asarray(target), jnp.asarray(conf)))(
        jnp.asarray(pred))
    p = _t(pred).requires_grad_()
    tlosses.keypoint_loss(p, _t(target), _t(conf)).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), atol=1e-9, rtol=1e-5)


def test_loss_weighting_trajectory_matches_jax():
    rng = np.random.default_rng(2)
    js = jweighting.LossWeightState.create(0.1)
    ts = tweighting.LossWeightState.create(0.1)
    for i in range(5):
        kp, z = (100.0, 1e-6) if i == 2 else (float(rng.uniform(0.01, 2)), float(rng.uniform(0.01, 8)))
        val = float(rng.uniform(0.1, 3.0))
        js = jweighting.update(js, jnp.float32(kp), jnp.float32(z))
        ts = tweighting.update(ts, torch.tensor(kp), torch.tensor(z))
        pairs = [
            (tweighting.balanced_loss(ts, torch.tensor(kp), torch.tensor(z)),
             jweighting.balanced_loss(js, jnp.float32(kp), jnp.float32(z))),
            (tweighting.validation_loss(ts, torch.tensor(kp), torch.tensor(z)),
             jweighting.validation_loss(js, jnp.float32(kp), jnp.float32(z))),
            *zip(tweighting.loss_contributions(ts, torch.tensor(kp), torch.tensor(z)),
                 jweighting.loss_contributions(js, jnp.float32(kp), jnp.float32(z))),
        ]
        js = jweighting.update_best(js, jnp.float32(val))
        ts = tweighting.update_best(ts, torch.tensor(val))
        for f in dataclasses.fields(tweighting.LossWeightState):
            pairs.append((getattr(ts, f.name), getattr(js, f.name)))
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy().astype(np.float64),
                                       np.asarray(want, np.float64), rtol=1e-5)
    carried = loss_weight_from_jax(js)
    for f in dataclasses.fields(tweighting.LossWeightState):
        got, want = getattr(carried, f.name), getattr(ts, f.name)
        assert got.dtype == want.dtype and got.shape == ()
        np.testing.assert_allclose(got.numpy().astype(np.float64),
                                   want.numpy().astype(np.float64), rtol=1e-5)


# ---------------------------------------------------------------------------
# Optimizer, partition, BatchNorm, dropout
# ---------------------------------------------------------------------------

def test_adamw_matches_optax_chain():
    """Three steps, a new learning rate each: torch AdamW's decoupled decay
    p*(1 - lr*wd) gives the optax chain's p - lr*(adam + wd*p)."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(3)]
    lrs, wd = [1e-3, 5e-4, 2e-3], 0.05
    tx = jstate.make_optimizer(wd)
    params = {"w": jnp.asarray(p0)}
    opt_state = tx.init(params)
    w = torch.nn.Parameter(_t(p0))
    opt = tstate.make_optimizer([w], wd)
    for g, lr in zip(grads, lrs):
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params)
        params = jax.tree.map(lambda p, u: p - lr * u, params, updates)
        opt.param_groups[0]["lr"] = lr
        w.grad = _t(g)
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]), rtol=1e-6, atol=1e-8)


def _jax_param_shapes(use_lora: bool, unfreeze: int = 0):
    vit = dataclasses.replace(JAX_VIT_PRESETS["test/vit-tiny"], lora_layers=(1,) if use_lora else ())
    shapes = jax.eval_shape(JaxPoseModule(vit=vit).init, jax.random.key(0),
                            jnp.zeros((1, 3, 224, 224)))
    return shapes["params"]


@pytest.mark.parametrize("use_lora, unfreeze", [(True, 0), (False, 0), (False, 1), (False, 2),
                                                (True, 2)])
def test_partition_matches_jax(use_lora, unfreeze):
    """The trainable names equal JAX's trainable_mask mapped through the
    port's conversion rules, and the registry builds the model with those
    flags. Under LoRA the unfreeze count is ignored, as in the JAX package;
    the final backbone LayerNorm never trains."""
    config = {"model_name": "test/vit-tiny", "use_lora": use_lora,
              "unfreeze_last_n_layers": unfreeze}
    params = _jax_param_shapes(use_lora)
    jmask = traverse_util.flatten_dict(jpartition.trainable_mask(params, config, "dinov2"))
    model = tregistry.create_model_from_config(config, device="cpu")
    rules = dinov2_pose_rules(2, (1,) if use_lora else ())
    want = {r.torch_key for r in rules if r.jax_path[0] == "params" and jmask[r.jax_path[1:]]}
    assert len(jmask) == sum(r.jax_path[0] == "params" for r in rules)
    assert {n for n, p in model.named_parameters() if p.requires_grad} == want
    got = tpartition.apply_partition(model, config)
    assert got == want and any("lora_B" in n for n in got) == use_lora
    assert {n for n, p in model.named_parameters() if p.requires_grad} == got
    blocks = {int(n.split(".")[3]) for n in got if n.startswith("backbone.encoder.layer.")
              and "lora" not in n}
    assert blocks == (set() if use_lora else set(range(2 - unfreeze, 2)))
    assert not any(n.startswith("backbone.layernorm") for n in got)


def test_batch_norm_train_matches_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 6, 5, 7)) * 2 + 3).astype(np.float32)
    g, b = rng.uniform(0.5, 1.5, 6).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    rm, rv = rng.standard_normal(6).astype(np.float32), rng.uniform(0.5, 2, 6).astype(np.float32)
    y_j, mut = jlayers.BatchNorm().apply(
        {"params": {"scale": g, "bias": b}, "batch_stats": {"mean": rm, "var": rv}},
        jnp.asarray(x.transpose(0, 2, 3, 1)), use_running_average=False, mutable=["batch_stats"])
    bn = torch.nn.BatchNorm2d(6)
    with torch.no_grad():
        for t, v in ((bn.weight, g), (bn.bias, b), (bn.running_mean, rm), (bn.running_var, rv)):
            t.copy_(_t(v))
    y_t = tlayers.batch_norm_train(_t(x), bn)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j).transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), mut["batch_stats"]["mean"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), mut["batch_stats"]["var"], rtol=1e-5)
    assert bn.num_batches_tracked.item() == 1


def test_dropout_uses_its_generator():
    x = torch.ones(200_000)
    a = tlayers.dropout(x, 0.25, torch.Generator().manual_seed(5))
    b = tlayers.dropout(x, 0.25, torch.Generator().manual_seed(5))
    c = tlayers.dropout(x, 0.25, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert tlayers.dropout(x, 0.0, None) is x
    assert not tlayers.dropout(x, 1.0, None).any()


def test_train_mode_dropout_follows_the_step_generator():
    """LoRA and z-head dropout in a train-mode forward: the same step seed
    gives the same outputs, another step another mask."""
    model = tregistry.create_model_from_config(
        {"model_name": "test/vit-tiny", "use_lora": True}, device="cpu").train()
    x = _t(np.random.default_rng(5).standard_normal((2, 3, 224, 224)).astype(np.float32))
    dev = torch.device("cpu")
    with torch.no_grad():
        z0 = model(x, generator=tstep.step_generator(0, 0, dev))[1]
        z1 = model(x, generator=tstep.step_generator(0, 0, dev))[1]
        z2 = model(x, generator=tstep.step_generator(0, 1, dev))[1]
    assert torch.equal(z0, z1) and not torch.equal(z0, z2)


# ---------------------------------------------------------------------------
# The MLP half's backward
# ---------------------------------------------------------------------------

D, S, B, HID = 64, 57, 2, 256


@pytest.fixture(scope="module")
def mlp_arrays():
    rng = np.random.default_rng(6)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.05  # noqa: E731
    mp = dict(g2=1 + r(D), b2=r(D), w1=r(D, HID), bf1=r(HID), w2=r(HID, D), bf2=r(D),
              ls2=1 + r(D))
    x2 = rng.standard_normal((B, S, D)).astype(np.float32)
    dy = rng.standard_normal((B, S, D)).astype(np.float32)
    return x2, dy, mp


def _tmp(mp, requires_grad=()):
    return tblock.MlpParams(**{k: _t(v).requires_grad_(k in requires_grad) for k, v in mp.items()})


def test_mlp_dx_math_matches_pallas_kernel(mlp_arrays, monkeypatch):
    """jax.vjp of fused_mlp_part(..., assume_frozen_weights=True) runs
    _mlp_dx_kernel (interpret mode on the CPU)."""
    x2, dy, mp = mlp_arrays
    calls = []
    orig = jblock._mlp_dx_kernel
    monkeypatch.setattr(jblock, "_mlp_dx_kernel", lambda *a, **k: calls.append(1) or orig(*a, **k))
    jp = jblock.MlpParams(**{k: jnp.asarray(v) for k, v in mp.items()})
    _, vjp = jax.vjp(lambda x: jblock.fused_mlp_part(x, jp, EPS, True), jnp.asarray(x2))
    (want,) = vjp(jnp.asarray(dy))
    assert calls
    got = tblock.mlp_dx_math(_t(x2), _t(dy), _tmp(mp), eps=EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_mlp_dx_math_matches_torch_autograd(mlp_arrays):
    x2, dy, mp = mlp_arrays
    x = _t(x2).requires_grad_()
    tblock.mlp_part_math(x, _tmp(mp), eps=EPS).backward(_t(dy))
    got = tblock.mlp_dx_math(_t(x2), _t(dy), _tmp(mp), eps=EPS)
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), atol=1e-5, rtol=1e-5)


def test_fused_mlp_dx_on_cpu_is_the_plain_version(mlp_arrays):
    x2, dy, mp = mlp_arrays
    tblock.reset_launches()
    got = tblock.fused_mlp_dx(_t(x2), _t(dy), _tmp(mp), EPS)
    assert torch.equal(got, tblock.mlp_dx_math(_t(x2), _t(dy), _tmp(mp), eps=EPS))
    assert tblock.LAUNCHES["fused_mlp_dx"] == 0


def test_mlp_part_frozen_backward_is_mlp_dx(mlp_arrays):
    x2, dy, mp = mlp_arrays
    x = _t(x2).requires_grad_()
    y = tblock.mlp_part_frozen(x, _tmp(mp), EPS)
    assert type(y.grad_fn).__name__ == "_MlpPartFrozenBackward"
    with torch.no_grad():
        assert torch.equal(y, tblock.fused_mlp_part(_t(x2), _tmp(mp), EPS))
    y.backward(_t(dy))
    assert torch.equal(x.grad, tblock.mlp_dx_math(_t(x2), _t(dy), _tmp(mp), eps=EPS))


@pytest.mark.parametrize("field", ["w1", "ls2", "g2"])
def test_mlp_part_frozen_refuses_trainable_weights(mlp_arrays, field):
    x2, _, mp = mlp_arrays
    with pytest.raises(ValueError, match="requires grad"):
        tblock.mlp_part_frozen(_t(x2).requires_grad_(), _tmp(mp, (field,)), EPS)


def test_forward_wrappers_refuse_to_cut_the_graph(mlp_arrays):
    x2, _, mp = mlp_arrays
    x = _t(x2).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        tblock.fused_mlp_part(x, _tmp(mp), EPS)
    with torch.no_grad():
        tblock.fused_mlp_part(x, _tmp(mp), EPS)


def test_dx_bound_model():
    flops = tblock.block_flops(257, 384)["fused_mlp_dx"]
    assert abs(flops / 1e9 - 0.909) < 1e-3
    t, by = tblock.bound_ms(128 * flops, tblock.block_bytes(128, 257, 384)["fused_mlp_dx"])
    assert by == "operations" and abs(t - 0.118) < 1e-3
    t_mem = tblock.block_bytes(128, 257, 384)["fused_mlp_dx"] / 3.35e12 * 1e3
    assert abs(t_mem - 0.023) < 1e-3


# ---------------------------------------------------------------------------
# Train and eval steps against the JAX package's
# ---------------------------------------------------------------------------

def _randomise(variables: dict, rng: np.random.Generator) -> dict:
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.array(v)
            if k == "lora_B":
                v = rng.standard_normal(v.shape).astype(np.float32) * 0.05
            elif k.startswith("layerscale"):
                v = rng.uniform(0.1, 1.0, v.shape).astype(np.float32)
            elif path and path[0] == "batch_stats":
                v = (rng.standard_normal(v.shape) * 0.1).astype(np.float32) if k == "mean" \
                    else rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            out[k] = v
        return out

    return walk(variables, ())


@pytest.fixture(scope="module")
def jax_pose():
    """test/vit-tiny + LoRA as the JAX registry builds it (jitted init)."""
    vit = dataclasses.replace(JAX_VIT_PRESETS["test/vit-tiny"], lora_layers=(1,), lora_dropout=0.0)
    module = JaxPoseModule(vit=vit, num_keypoints=24, heatmap_size=48)
    variables = jax.jit(module.init)(jax.random.key(0), jnp.zeros((1, 3, 224, 224)))
    return module, _randomise(jax.device_get(variables), np.random.default_rng(7))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(8)
    return {
        "image": rng.standard_normal((2, 3, 224, 224)).astype(np.float32),
        "2d_keypoints": _keypoints(rng, 2, 24, (224, 224)),
        "z_coords": (rng.standard_normal((2, 24)) * 10).astype(np.float32),
    }


def _port_model(variables, config=CONFIG):
    tm = tregistry.create_model_from_config(dict(config), device="cpu")
    tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return tm


class _NoDropout:
    def __init__(self, rate=0.0, **kw):
        pass

    def __call__(self, x, deterministic=True):
        return x


# Leaves whose cotangent comes only from above the heatmap head's last ReLU,
# so no gate flip reaches them (measured below 5e-6 on both routes).
_ABOVE_GATE_FLIPS = ("pose_heads.z_head.", "pose_heads.heatmap_head.prediction.")


# Leaves with no ReLU at all between them and the losses: the z head's last
# linear and the heatmap head's last conv. The unfreeze test holds only these
# to 1e-4: its weights flip a gate of the ReLU after the prediction BN, whose
# conv and BN bias then read 1.7e-3 and 1.2e-4 on both routes.
_ABOVE_LAST_RELU = ("pose_heads.z_head.mlp.9.", "pose_heads.heatmap_head.prediction.3.")


def _grad_close(got: np.ndarray, want: np.ndarray, scale: float, name: str,
                above: tuple[str, ...] = _ABOVE_GATE_FLIPS, below_tol: float = 1e-2) -> None:
    if np.linalg.norm(want) < 1e-5 * scale:
        # A true-zero gradient (a conv bias normalised away by the BN that
        # follows): both sides hold roundoff.
        assert np.linalg.norm(got) < 1e-4 * scale, name
        return
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    tol = 1e-4 if name.startswith(above) else below_tol
    assert rel < tol, f"{name}: relative Frobenius error {rel:.3e} (tol {tol})"


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_backbone_lora_grads_match_jax(jax_pose, batch, route, monkeypatch):
    """The LoRA gradients of the backbone alone, under a seeded cotangent on
    its tokens, against ``jax.vjp``. No head and so no ReLU gate lies between
    them, and they are held to 1e-5. ``fused``: the JAX side's LoRA layer
    carries the cotangent back through _mlp_dx_kernel (interpret mode)."""
    module, variables = jax_pose
    monkeypatch.setenv("DINO_POSE_TPU_BLOCK", route)
    calls = []
    orig = jblock._mlp_dx_kernel
    monkeypatch.setattr(jblock, "_mlp_dx_kernel", lambda *a, **k: calls.append(1) or orig(*a, **k))
    flat = traverse_util.flatten_dict(variables["params"]["backbone"])
    lora = {k: jnp.asarray(v) for k, v in flat.items() if k[-1] in ("lora_A", "lora_B")}
    pixels = jnp.transpose(jnp.asarray(batch["image"]), (0, 2, 3, 1))
    backbone = JaxBackbone(module.vit)

    def tokens(leaves):
        params = traverse_util.unflatten_dict({**flat, **leaves})
        return backbone.apply({"params": params}, pixels, deterministic=True)[0]

    with jdispatch.local():
        out, vjp = jax.vjp(tokens, lora)
        ct = np.random.default_rng(9).standard_normal(out.shape).astype(np.float32)
        (jgrads,) = vjp(jnp.asarray(ct))
    assert len(lora) == 2 and bool(calls) == (route == "fused")

    tm = _port_model(variables).train()
    got, _ = tm.backbone(_t(batch["image"]))
    got.backward(_t(ct))
    gflat = traverse_util.flatten_dict(jax.tree.map(np.zeros_like, variables["params"]))
    gflat.update({("backbone",) + k: np.asarray(g) for k, g in jgrads.items()})
    want = state_dict_from_jax({"params": traverse_util.unflatten_dict(gflat),
                                "batch_stats": variables["batch_stats"]}, tm)
    names = [n for n, p in tm.named_parameters() if p.grad is not None]
    assert len(names) == 2 and all("lora" in n for n in names)
    for n in names:
        g, w = dict(tm.named_parameters())[n].grad.numpy(), want[n].numpy()
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert np.abs(w).max() > 0 and rel < 1e-5, f"{n}: relative Frobenius error {rel:.3e}"


def _two_steps_match_jax(module, variables, config, batch, step2_rtol=1e-5,
                         above=_ABOVE_GATE_FLIPS, unreached=(), family="dinov2",
                         below_tol=1e-2, step2_stats_atol=1e-4, step_atol=2 * LR):
    """Two steps of the port's ``prepare_batch(make_train_step)`` against JAX
    ``_prepare_batch(make_train_step)`` with device targets, from the same
    weights: losses, step-1 gradients of every trainable leaf, parameters
    after AdamW and BatchNorm statistics after each step. Step-2 losses are
    held to ``step2_rtol``, gradients of the leaves named by ``above`` to
    1e-4 and the others to ``below_tol``, the step-2 statistics to
    ``step2_stats_atol``, the parameters to ``step_atol`` a step. Modules
    under the ``unreached`` prefixes do not
    run at this input size: their BatchNorms count no batch. ``family`` is
    the JAX model family (its partition rule). Returns the port's step-1
    gradients."""
    targets = (batch["image"].shape[-1], 48)
    # --- JAX
    js, tx, part = jstate.create_train_state(variables, config, family, weight_decay=WD)
    jfn = jax.jit(jstep._prepare_batch(jstep.make_train_step(module, tx, part), targets))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jdispatch.local():
        js1, jstats1 = jfn(js, jbatch, jnp.float32(LR), jax.random.key(0))
        js2, jstats2 = jfn(js1, jbatch, jnp.float32(LR), jax.random.key(0))

    # --- port
    tm = _port_model(variables, config)
    ts, opt, tpart = tstate.create_train_state(tm, config, weight_decay=WD)
    tfn = tstep.prepare_batch(tstep.make_train_step(tm, opt, tpart), targets)
    tbatch = {k: _t(v) for k, v in batch.items()}
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tblock.reset_launches()
    ts, tstats1 = tfn(ts, tbatch, LR, 0)
    grads = {n: p.grad.numpy().copy() for n, p in tm.named_parameters() if p.grad is not None}
    after1 = {k: v.clone() for k, v in tm.state_dict().items()}
    ts, tstats2 = tfn(ts, tbatch, LR, 0)
    assert ts.step == 2 and all(n == 0 for n in tblock.LAUNCHES.values())

    for got, want, rtol in ((tstats1, jstats1, 1e-5), (tstats2, jstats2, step2_rtol)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=rtol, err_msg=k)

    # Step-1 gradients: after one step optax's first moment is (1 - 0.9) * g.
    mu = js1.opt_state[0].mu
    _, frozen = part.split(js.params)
    jgrads = state_dict_from_jax(
        {"params": part.merge(jax.tree.map(lambda m: np.asarray(m) / (1 - 0.9), mu),
                              jax.tree.map(np.zeros_like, frozen)),
         "batch_stats": variables["batch_stats"]}, tm)
    assert set(grads) == tpart
    scale = max(np.abs(jgrads[n]).max() for n in grads)
    for n in grads:
        _grad_close(grads[n], jgrads[n].numpy(), scale, n, above, below_tol)

    # Parameters and BatchNorm statistics after each step.
    for k_step, (tsd, jst) in enumerate(((after1, js1), (tm.state_dict(), js2)), start=1):
        jsd = state_dict_from_jax({"params": jst.params, "batch_stats": jst.batch_stats}, tm)
        for k, v in tsd.items():
            if k.endswith("num_batches_tracked"):
                assert v.item() == (0 if k.startswith(unreached) else k_step), k
            elif k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), jsd[k].numpy(), rtol=1e-5,
                                           atol=1e-7 if k_step == 1 else step2_stats_atol,
                                           err_msg=k)
            elif k in tpart:
                np.testing.assert_allclose(v.numpy(), jsd[k].numpy(), rtol=0,
                                           atol=step_atol * k_step, err_msg=k)
                assert not torch.equal(v, before[k]) or np.abs(grads[k]).max() == 0
            else:
                assert torch.equal(v, before[k]), k  # frozen: bitwise unchanged
    return grads


def _count_calls(monkeypatch, *names):
    """Count the calls of JAX Pallas kernel bodies (traced once per pallas_call)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        orig = getattr(jblock, name)

        def counted(*a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(jblock, name, counted)
    return calls


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_train_step_matches_jax(jax_pose, batch, route, monkeypatch):
    """Two LoRA train steps against JAX's. ``fused``: the JAX side runs its
    Pallas kernels in interpret mode, its LoRA layer's backward through
    _mlp_dx_kernel; ``unfused``: its XLA math."""
    module, variables = jax_pose
    monkeypatch.setenv("DINO_POSE_TPU_BLOCK", route)
    monkeypatch.setattr(jlayers, "Dropout", _NoDropout)
    calls = _count_calls(monkeypatch, "_mlp_dx_kernel")
    grads = _two_steps_match_jax(module, variables, CONFIG, batch)
    assert bool(calls["_mlp_dx_kernel"]) == (route == "fused")
    lora = [n for n in grads if "lora" in n]
    assert len(lora) == 2 and all(np.abs(grads[n]).max() > 0 for n in lora)


@pytest.fixture(scope="module")
def jax_plain():
    """test/vit-tiny without LoRA, randomised LayerScales and BN statistics;
    the variables serve every unfreeze count (the tree does not depend on it)."""
    module = JaxPoseModule(vit=JAX_VIT_PRESETS["test/vit-tiny"], num_keypoints=24,
                           heatmap_size=48)
    variables = jax.jit(module.init)(jax.random.key(0), jnp.zeros((1, 3, 224, 224)))
    return _randomise(jax.device_get(variables), np.random.default_rng(11))


def _unfreeze_config(n: int) -> dict:
    return {"model_name": "test/vit-tiny", "use_lora": False, "unfreeze_last_n_layers": n}


def _unfreeze_vit(n: int):
    return dataclasses.replace(JAX_VIT_PRESETS["test/vit-tiny"], num_unfrozen_layers=n)


_BLOCK_LEAVES = 18  # norms 4, q/k/v 6, out-projection 2, fc1 2, fc2 2, LayerScales 2


@pytest.mark.parametrize("unfreeze", [1, 2])
@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_unfreeze_train_step_matches_jax(jax_plain, batch, route, unfreeze, monkeypatch):
    """Two unfreeze-last-N train steps (no LoRA) against JAX's. ``fused``:
    the JAX side's trainable blocks run ``fused_block_train``, whose backward
    is _mlp_bwd_kernel and _attn_bwd_kernel (interpret mode); ``unfused``:
    its XLA math. The block gradients sit below the heads' ReLU gates and are
    held to 1e-2 with the other such leaves (measured 4.0e-3 to 5.8e-3 on
    both routes); they are held to 1e-5 without the heads by the next test.
    Only the leaves above the last ReLU are held to 1e-4. AdamW's first step moves every element of
    the 18 to 36 block leaves by about lr*sign(g), so each element whose
    gradient a gate flip moves across zero lands 2*lr away from JAX's: the
    step-2 losses are held to 1e-4 relative (measured up to 2.8e-5 on both
    routes), the LoRA step's to 1e-5."""
    monkeypatch.setenv("DINO_POSE_TPU_BLOCK", route)
    monkeypatch.setattr(jlayers, "Dropout", _NoDropout)
    calls = _count_calls(monkeypatch, "_mlp_bwd_kernel", "_attn_bwd_kernel")
    module = JaxPoseModule(vit=_unfreeze_vit(unfreeze), num_keypoints=24, heatmap_size=48)
    grads = _two_steps_match_jax(module, jax_plain, _unfreeze_config(unfreeze), batch,
                                 step2_rtol=1e-4, above=_ABOVE_LAST_RELU)
    assert all(calls.values()) == (route == "fused") and any(calls.values()) == (route == "fused")
    blocks = [n for n in grads if n.startswith("backbone.")]
    assert len(blocks) == _BLOCK_LEAVES * unfreeze
    assert {int(n.split(".")[3]) for n in blocks} == set(range(2 - unfreeze, 2))
    assert all(np.abs(grads[n]).max() > 0 for n in blocks)


def test_unfreeze_train_step_at_504_matches_jax(jax_plain, monkeypatch):
    """Two unfreeze-last-1 train steps at 504² (S = 1297) against JAX's on
    its own route there: block_math around ``flash_attention`` in both
    layers (``DINO_POSE_TPU_BLOCK=unfused``, ``DINO_POSE_TPU_ATTENTION=
    pallas``), so the trainable layer's backward runs _flash_bwd_kernel
    (interpret mode). Held as the 224² unfreeze step. The heads take their
    one-stage plan at the 36x36 grid: their second stage gets a zero
    gradient, as in JAX, and AdamW only decays it."""
    monkeypatch.setenv("DINO_POSE_TPU_BLOCK", "unfused")
    monkeypatch.setenv("DINO_POSE_TPU_ATTENTION", "pallas")
    monkeypatch.setattr(jlayers, "Dropout", _NoDropout)
    jattention = importlib.import_module("dino_pose_tpu.ops.attention")
    calls = {"_flash_kernel": 0, "_flash_bwd_kernel": 0}
    for name in calls:
        orig = getattr(jattention, name)
        monkeypatch.setattr(jattention, name, lambda *a, _n=name, _o=orig, **k:
                            calls.__setitem__(_n, calls[_n] + 1) or _o(*a, **k))
    rng = np.random.default_rng(13)
    batch = {"image": rng.standard_normal((2, 3, 504, 504)).astype(np.float32),
             "2d_keypoints": _keypoints(rng, 2, 24, (504, 504)),
             "z_coords": (rng.standard_normal((2, 24)) * 10).astype(np.float32)}
    module = JaxPoseModule(vit=_unfreeze_vit(1), num_keypoints=24, heatmap_size=48)
    unreached = "pose_heads.heatmap_head.upsampling.1."
    grads = _two_steps_match_jax(module, jax_plain, _unfreeze_config(1), batch,
                                 step2_rtol=1e-4, above=_ABOVE_LAST_RELU,
                                 unreached=(unreached,))
    assert all(not grads[n].any() for n in grads if n.startswith(unreached))
    assert calls["_flash_kernel"] >= 2 and calls["_flash_bwd_kernel"] >= 1, calls
    blocks = [n for n in grads if n.startswith("backbone.")]
    assert len(blocks) == _BLOCK_LEAVES and all(n.startswith("backbone.encoder.layer.1.")
                                                for n in blocks)
    assert all(np.abs(grads[n]).max() > 0 for n in blocks)


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_backbone_unfreeze_grads_match_jax(jax_plain, batch, route, monkeypatch):
    """The gradients of both trainable blocks of test/vit-tiny (unfreeze 2)
    under a seeded cotangent on the backbone's tokens, against ``jax.vjp``:
    no head and so no ReLU gate lies between them, so they are held to 1e-5
    relative Frobenius error. The key biases' true gradient is zero (a
    constant added to every score of a query leaves its softmax unchanged):
    both sides hold roundoff there, below 1e-5 of the largest gradient.
    Layer 0's gradients come through the dx of layer 1's backward.
    ``fused``: the JAX side runs ``fused_block_train`` (deterministic=False,
    as in training)."""
    monkeypatch.setenv("DINO_POSE_TPU_BLOCK", route)
    calls = _count_calls(monkeypatch, "_mlp_bwd_kernel", "_attn_bwd_kernel")
    flat = traverse_util.flatten_dict(jax_plain["params"]["backbone"])
    train = {k: jnp.asarray(v) for k, v in flat.items()
             if any(part.startswith("layer") and part[5:].isdigit() for part in k)}
    pixels = jnp.transpose(jnp.asarray(batch["image"]), (0, 2, 3, 1))
    backbone = JaxBackbone(_unfreeze_vit(2))

    def tokens(leaves):
        params = traverse_util.unflatten_dict({**flat, **leaves})
        return backbone.apply({"params": params}, pixels, deterministic=False)[0]

    with jdispatch.local():
        out, vjp = jax.vjp(tokens, train)
        ct = np.random.default_rng(12).standard_normal(out.shape).astype(np.float32)
        (jgrads,) = vjp(jnp.asarray(ct))
    assert all(calls.values()) == (route == "fused") and any(calls.values()) == (route == "fused")

    tm = _port_model(jax_plain, _unfreeze_config(2)).train()
    got, _ = tm.backbone(_t(batch["image"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-4, rtol=0)
    got.backward(_t(ct))
    gflat = traverse_util.flatten_dict(jax.tree.map(np.zeros_like, jax_plain["params"]))
    gflat.update({("backbone",) + k: np.asarray(g) for k, g in jgrads.items()})
    want = state_dict_from_jax({"params": traverse_util.unflatten_dict(gflat),
                                "batch_stats": jax_plain["batch_stats"]}, tm)
    params = dict(tm.named_parameters())
    names = [n for n, p in params.items() if p.grad is not None]
    assert len(names) == 2 * _BLOCK_LEAVES and len(train) == len(names)
    assert all(n.startswith("backbone.encoder.layer.") for n in names)
    scale = max(np.abs(want[n].numpy()).max() for n in names)
    zeros = []
    for n in names:
        g, w = params[n].grad.numpy(), want[n].numpy()
        if np.linalg.norm(w) < 1e-5 * scale:
            zeros.append(n)
            assert np.linalg.norm(g) < 1e-5 * scale, n
            continue
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < 1e-5, f"{n}: relative Frobenius error {rel:.3e}"
    assert sorted(zeros) == [f"backbone.encoder.layer.{i}.attention.attention.key.bias"
                             for i in (0, 1)]


def test_eval_after_a_train_step_sees_the_trained_weights(jax_plain, batch):
    """A block's packed copies are keyed on its parameters' versions: an eval
    step after a train step (the eval step before it packed the copies) gives
    the bits a fresh model loaded with the trained state dict gives."""
    config = _unfreeze_config(2)
    tm = _port_model(jax_plain, config)
    ts, opt, part = tstate.create_train_state(tm, config)
    tbatch = {k: _t(v) for k, v in batch.items()}
    ebatch = {**tbatch, "2d_heatmaps": theatmaps.render_heatmaps(tbatch["2d_keypoints"])}
    evaluate = tstep.make_eval_step(tm)
    evaluate(ts, ebatch)
    block = tm.backbone.encoder.layer[0]
    w1 = block.packed(torch.float32).w1.clone()
    train = tstep.prepare_batch(tstep.make_train_step(tm, opt, part), (224, 48))
    ts, _ = train(ts, tbatch, 1e-3, 0)
    after = evaluate(ts, ebatch)
    assert not torch.equal(block.packed(torch.float32).w1, w1)
    fresh = _port_model(jax_plain, config)
    fresh.load_state_dict(tm.state_dict())
    want = tstep.make_eval_step(fresh)(ts, ebatch)
    for k in ("pred_heatmaps", "pred_z", "loss"):
        assert torch.equal(after[k], want[k]), k


def test_eval_step_matches_jax(jax_pose, batch):
    module, variables = jax_pose
    hm = np.asarray(jheatmaps.render_heatmaps(jnp.asarray(batch["2d_keypoints"])))
    sv = np.array([1.0, 0.0], np.float32)
    js, _, _ = jstate.create_train_state(variables, CONFIG, "dinov2")
    js = js.replace(loss_weight=js.loss_weight.replace(weight=jnp.float32(0.37)))
    with jdispatch.local():
        want = jax.jit(jstep.make_eval_step(module))(
            js, {**{k: jnp.asarray(v) for k, v in batch.items()},
                 "2d_heatmaps": jnp.asarray(hm), "sample_valid": jnp.asarray(sv)})
    tm = _port_model(variables)
    ts, _, _ = tstate.create_train_state(tm, CONFIG)
    ts.loss_weight = loss_weight_from_jax(js.loss_weight)
    got = tstep.make_eval_step(tm)(ts, {**{k: _t(v) for k, v in batch.items()},
                                        "2d_heatmaps": _t(hm), "sample_valid": _t(sv)})
    assert not tm.training
    for k in ("loss", "kp_loss", "z_loss"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    for k in ("pred_heatmaps", "pred_z"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=0)


def test_prepare_batch_refuses_device_warp_batches():
    fn = tstep.prepare_batch(lambda state, batch: batch, (224, 48))
    with pytest.raises(NotImplementedError, match="data-pipeline"):
        fn(None, {"canvas": torch.zeros(1)})
    out = tstep.prepare_batch(lambda s, b: b, (224, 48), torch.bfloat16)(
        None, {"image": torch.zeros(1, 3, 4, 4), "2d_keypoints": torch.full((1, 2, 3), 50.0)})
    assert out["image"].dtype == torch.bfloat16 and out["2d_heatmaps"].shape == (1, 2, 48, 48)
