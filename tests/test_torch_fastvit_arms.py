"""JAX's FastViT fold switches on the port, against the JAX package in the same
arm, on the CPU in f32.

Each case sets one arm on both sides (``monkeypatch.setenv``; both read
``os.environ`` at each call): ``DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS=branch``
(the reference's branch math in training), ``=fold`` (one conv per block,
its kernel folded from the batch statistics),
``DINO_POSE_TPU_FASTVIT_TRAIN_FFN=fold`` (SpatialAttention's BatchNorm folded
into qkv, the ConvFFN's statistics as one-pass moments) and
``DINO_POSE_TPU_FASTVIT_FOLD=0`` (the branch math in eval). The model is
``test_torch_fastvit_train``'s: ``test/fastvit-tiny`` with LoRA rank 4,
randomised running statistics, LayerScales and LoRA B. JAX's ConvFFN takes
its ``xla`` route throughout, the route whose train statistics follow
``TRAIN_FFN`` (its kernel route takes two-pass statistics in every arm); the
port's ConvFFN keeps its kernel (the plain version on the CPU) on every arm.

Tolerances (f32, summation order only): outputs to 1e-5 of their largest
magnitude and 1e-5 relative, running statistics to 1e-5 relative (1e-7
absolute), as ``test_torch_fastvit_train``; the RepMixer's dx and
parameter gradients to 1e-5 relative Frobenius error; JAX's two stride-2
backwards (``DINO_POSE_TPU_DS_BWD``) to each other and to the port's
autograd dx to 1e-5 of the largest magnitude; the train step with
``test_torch_train._two_steps_match_jax``'s rules (``GATED``);
``fuse_mobileone_params`` to JAX's at 1e-6 and to the branch-form eval at
1e-4 (``tests/test_fastvit.py``'s tolerance).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_fastvit_train import (
    CONFIG,
    GATED,
    _assert_stats_match,
    _jax_blocks,
    _nhwc,
    _port_model,
    _route,
    _stats_with,
    _sub,
    _to_port,
    batch,  # noqa: F401 (a fixture)
    jax_model,  # noqa: F401 (a fixture)
)
from test_torch_train import _NoDropout, _t, _two_steps_match_jax

from dino_pose_tpu.models import fastvit as jfastvit
from dino_pose_tpu.models import fastvit_fold as jfold
from dino_pose_tpu.nn import layers as jlayers
from dino_pose_tpu.ops import convffn as jconvffn
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu.ops import dwconv as jdwconv
from dino_pose_tpu_torch.io.convert import state_dict_from_jax
from dino_pose_tpu_torch.models import fastvit as tfastvit
from dino_pose_tpu_torch.models import fastvit_fold as tfold

# Each arm: (its switches, train mode?).
ARMS = {
    "branch": ({"DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS": "branch"}, True),
    "fold": ({"DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS": "fold"}, True),
    "ffn_fold": ({"DINO_POSE_TPU_FASTVIT_TRAIN_FFN": "fold"}, True),
    "fold0_eval": ({"DINO_POSE_TPU_FASTVIT_FOLD": "0"}, False),
}
BLOCKS = ["stem0", "stem1", "patch_embed", "repmixer", "convffn", "final_conv", "attention"]
SWITCHES = ("DINO_POSE_TPU_FASTVIT_FOLD", "DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS",
            "DINO_POSE_TPU_FASTVIT_TRAIN_FFN", "DINO_POSE_TPU_DS_BWD",
            "DINO_POSE_TPU_STAGE_PAIR", "DINO_POSE_TPU_DWCONV")


@pytest.fixture
def switches(monkeypatch):
    """Clears every switch, then sets the ones given, for both sides."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)

    def set_(env: dict) -> None:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    return set_


@pytest.fixture(scope="module")
def port_model(jax_model):  # noqa: F811 (the imported fixture)
    """The port's model of ``jax_model``'s variables, built once; each case
    takes a copy."""
    return _port_model(jax_model[1], CONFIG)


@pytest.mark.parametrize("name", BLOCKS)
@pytest.mark.parametrize("arm", list(ARMS))
def test_block_matches_jax_in_each_arm(jax_model, port_model, switches,  # noqa: F811
                                       monkeypatch, arm, name):
    """Each block's output, and in training every running statistic, against
    JAX's in the same arm (eval: no BatchNorm counts a batch)."""
    module, variables = jax_model
    env, train = ARMS[arm]
    switches(env)
    _route(monkeypatch, "xla")
    jmod, path, get, call, shape = _jax_blocks(module.cfg)[name]
    x = _nhwc(shape, seed=len(name) + 7)
    sub = {c: _sub(variables[c], path) for c in ("params", "batch_stats")}
    with jdispatch.local():
        if train:
            want, mutated = jmod.apply(sub, jnp.asarray(x), train=True, mutable=["batch_stats"])
        else:
            want = jmod.apply(sub, jnp.asarray(x), train=False)
    tm = copy.deepcopy(port_model).train(train)
    tmod = get(tm)
    with torch.no_grad():
        got = call(tm, _to_port(x)) if call else tmod(_to_port(x))
    want = np.asarray(want)
    assert got.shape == (shape[0], want.shape[-1], *want.shape[1:3])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    if train:
        owner = tm.backbone.stages[3].blocks[0].norm if name == "attention" else tmod
        _assert_stats_match(tm, _stats_with(variables, path, mutated["batch_stats"]), owner)
    else:
        assert all(m.num_batches_tracked.item() == 0 for m in tm.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))


# The RepMixer's one ill-conditioned leaf: a depthwise 1x1 scale whose
# BatchNorm normalises its per-channel scale away, so that its exact
# gradient is only BatchNorm's eps term, a small difference of large ones.
# f32 leaves it 7.3e-5 (the port) and 1.96e-4 (JAX) from an f64 gradient in
# the branch form, 7.9e-6 and 1.2e-6 in the fold; it is held to the port's
# f64 gradient: within 1e-5, or no further than JAX's.
EPS_LEAF = "mixer.rbr_scale.conv.weight"


@pytest.mark.parametrize("mode", ["fold", "branch"])
def test_repmixer_gradients_match_jax(jax_model, port_model, switches, mode):  # noqa: F811
    """The train-mode RepMixer's dx and every parameter's gradient under a
    seeded cotangent, against JAX's vjp in the same mode (the port's
    parameters made trainable for this); ``EPS_LEAF`` against the port's
    gradient in f64."""
    module, variables = jax_model
    switches({"DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS": mode})
    jmod, path, get, _, shape = _jax_blocks(module.cfg)["repmixer"]
    x = _nhwc(shape, seed=11)
    ct = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    stats = _sub(variables["batch_stats"], path)

    def out(params, xin):
        return jmod.apply({"params": params, "batch_stats": stats}, xin, train=True,
                          mutable=["batch_stats"])[0]

    want, vjp = jax.vjp(out, _sub(variables["params"], path), jnp.asarray(x))
    jparams, jdx = vjp(jnp.asarray(ct))
    gflat = traverse_util.flatten_dict(jax.tree.map(np.zeros_like, variables["params"]))
    gflat.update({path + k: np.asarray(g)
                  for k, g in traverse_util.flatten_dict(jparams).items()})
    jgrads = state_dict_from_jax({"params": traverse_util.unflatten_dict(gflat),
                                  "batch_stats": variables["batch_stats"]}, port_model)
    prefix = "backbone.stages.0.blocks.0.token_mixer."

    grads = {}
    for dtype in (torch.float32, torch.float64):
        tmod = get(copy.deepcopy(port_model).train().to(dtype))
        for p in tmod.parameters():
            p.requires_grad_(True)
        xt = _to_port(x).to(dtype).requires_grad_(True)
        got = tmod(xt)
        if dtype == torch.float32:
            np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                                       np.asarray(want), rtol=1e-5,
                                       atol=1e-5 * np.abs(np.asarray(want)).max())
        got.backward(_t(ct.transpose(0, 3, 1, 2)).to(dtype))
        grads[dtype] = {"dx": xt.grad.permute(0, 2, 3, 1).double().numpy(),
                        **{n: p.grad.double().numpy() for n, p in tmod.named_parameters()}}

    def rel(g, w):
        return np.linalg.norm(g - w) / np.linalg.norm(w)

    port, exact = grads[torch.float32], grads[torch.float64]
    jax_grads = {"dx": np.asarray(jdx), **{n: jgrads[prefix + n].numpy() for n in port
                                             if n != "dx"}}
    assert len(port) == 12
    for n, g in port.items():
        if n == EPS_LEAF:
            assert rel(g, exact[n]) <= max(1e-5, rel(jax_grads[n], exact[n])), n
        else:
            assert rel(g, jax_grads[n]) < 1e-5, n


def test_lora_train_step_matches_jax_under_block_fold(jax_model, batch, switches,  # noqa: F811
                                                      monkeypatch):
    """Two LoRA train steps with ``TRAIN_BLOCKS=fold`` on both sides: every
    MobileOne block, ReparamLargeKernelConv and RepMixer one conv on a kernel
    folded from the batch statistics, differentiable through them."""
    module, variables = jax_model
    switches({"DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS": "fold"})
    monkeypatch.setattr(jlayers, "Dropout", _NoDropout)
    _route(monkeypatch, "xla")
    grads = _two_steps_match_jax(module, variables, CONFIG, batch, family="fastvit", **GATED)
    lora = [n for n in grads if "lora_" in n]
    assert len(lora) == 16 and all(np.abs(grads[n]).max() > 0 for n in lora)


def test_invalid_train_blocks_raises_jax_error(port_model, switches):
    """A value JAX refuses is refused with JAX's words, by the gate and by a
    train-mode forward; eval reads no train mode."""
    switches({"DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS": "Folded"})
    with pytest.raises(ValueError) as jerr:
        jfold.train_block_mode()
    with pytest.raises(ValueError) as terr:
        tfold.train_block_mode()
    assert str(terr.value) == str(jerr.value) == (
        "DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS='folded': expected branch|fold|reuse")
    tm = copy.deepcopy(port_model)
    x = _to_port(_nhwc((1, 128, 128, 3), seed=3))
    with torch.no_grad(), pytest.raises(ValueError, match="expected branch\\|fold\\|reuse"):
        tm.train().backbone(x)
    with torch.no_grad():
        assert tm.eval().backbone(x).shape == (1, 128, 4, 4)


@pytest.mark.parametrize("arm", ["reuse", "fold", "branch", "fold0"])
def test_stage_pair_gate_follows_jax(switches, arm):
    """With the pair arm on a t8 + LoRA block at 256², bs=128, takes the pair
    exactly where JAX's gate (fastvit.py:871-881) does: in the reuse form
    only; the RepMixer's ``combine_terms`` raises under ``TRAIN_BLOCKS=fold``
    or ``branch``, as JAX's ``return_combine`` does. ``force`` on both sides: JAX's ``on`` asks for a TPU (the port's
    ``on`` applies its window on any device, a recorded departure)."""
    env = {"DINO_POSE_TPU_STAGE_PAIR": "force"}
    if arm == "fold0":
        env["DINO_POSE_TPU_FASTVIT_FOLD"] = "0"
    elif arm != "reuse":
        env["DINO_POSE_TPU_FASTVIT_TRAIN_BLOCKS"] = arm
    switches(env)
    cfg = dataclasses.replace(tfastvit.FASTVIT_PRESETS["t8"], lora_rank=8)
    with torch.device("meta"):
        backbone = tfastvit.FastViTBackbone(cfg).train()
    got, want = [], []
    for i, stage in enumerate(backbone.stages):
        c, hh = cfg.embed_dims[i], 64 >> i
        x = torch.empty((128, c, hh, hh), dtype=torch.bfloat16, device="meta")
        for blk in stage.blocks:
            hidden = int(c * cfg.mlp_ratios[i])
            got.append(blk.pair(x))
            want.append(bool(
                jfold.block_fold_active(True) and jfold.block_reuse_active(True)
                and jdwconv.pair_enabled(c, hh, hh, 7, 2, batch=128)
                and jconvffn.convffn_res_enabled(c, hidden, hh * hh, 2, True, cfg.lora_rank,
                                                 batch=128)))
    assert got == want
    assert any(got) == (arm == "reuse")
    if arm in ("fold", "branch"):  # as JAX's return_combine (fastvit.py:733-734)
        with pytest.raises(ValueError, match="reuse train mode"):
            backbone.stages[0].blocks[0].token_mixer.combine_terms(
                torch.empty((128, 48, 64, 64), dtype=torch.bfloat16, device="meta"))


@pytest.mark.parametrize("name", ["stem1", "patch_embed"])
def test_stride2_dx_is_the_same_under_ds_bwd(jax_model, port_model, switches,  # noqa: F811
                                             monkeypatch, name):
    """JAX's stride-2 depthwise conv with its parity-split dx
    (``DINO_POSE_TPU_DS_BWD`` unset) and with XLA's transpose (``=0``): the
    same dx, and the port's autograd dx (it reads no such switch)."""
    module, variables = jax_model
    switches({})
    jmod, path, get, _, shape = _jax_blocks(module.cfg)[name]
    x = _nhwc(shape, seed=13)
    stats = _sub(variables["batch_stats"], path)
    params = _sub(variables["params"], path)

    tm = copy.deepcopy(port_model).train()
    xt = _to_port(x).requires_grad_(True)
    out = get(tm)(xt)
    ct = np.random.default_rng(14).standard_normal(out.permute(0, 2, 3, 1).shape)
    ct = ct.astype(np.float32)
    out.backward(_t(ct.transpose(0, 3, 1, 2)))
    got = xt.grad.permute(0, 2, 3, 1).numpy()

    def dx():
        _, vjp = jax.vjp(lambda xin: jmod.apply({"params": params, "batch_stats": stats}, xin,
                                                train=True, mutable=["batch_stats"])[0],
                         jnp.asarray(x))
        return np.asarray(vjp(jnp.asarray(ct))[0])

    parity = dx()
    monkeypatch.setenv("DINO_POSE_TPU_DS_BWD", "0")
    transpose = dx()
    scale = np.abs(parity).max()
    np.testing.assert_allclose(transpose, parity, rtol=0, atol=1e-5 * scale)
    for want in (parity, transpose):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("groups", [1, 8])
def test_fuse_mobileone_params_matches_jax_and_the_branch_form(switches, groups):
    """The port's deploy fuse against JAX's on the same arrays (torch layout
    against HWIO), and the fused conv against the port's branch-form eval
    (``FASTVIT_FOLD=0``) of a randomised block: dense (JAX's own test's
    block) and depthwise."""
    switches({"DINO_POSE_TPU_FASTVIT_FOLD": "0"})
    block = tfastvit.MobileOneBlock(8, 8, 3, 1, groups=groups, use_act=False).eval()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for t in (*block.parameters(), *(b for n, b in block.named_buffers() if "running" in n)):
            t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))

    def bn(m):
        return {k: getattr(m, k).detach().numpy()
                for k in ("weight", "bias", "running_mean", "running_var")}

    def flax_bn(m):
        d = bn(m)
        return {"scale": d["weight"], "bias": d["bias"], "mean": d["running_mean"],
                "var": d["running_var"]}

    conv, scale = block.rbr_conv[0], block.rbr_scale
    kernel, bias = tfastvit.fuse_mobileone_params(
        conv.conv.weight.detach().numpy(), bn(conv.bn), scale.conv.weight.detach().numpy(),
        bn(scale.bn), bn(block.rbr_skip))
    assert kernel.dtype == bias.dtype == torch.float32 and kernel.shape == (8, 8 // groups, 3, 3)
    jk, jb = jfastvit.fuse_mobileone_params(
        conv.conv.weight.detach().numpy().transpose(2, 3, 1, 0), flax_bn(conv.bn),
        scale.conv.weight.detach().numpy().transpose(2, 3, 1, 0), flax_bn(scale.bn),
        flax_bn(block.rbr_skip))
    np.testing.assert_allclose(kernel.numpy(), np.asarray(jk).transpose(3, 2, 0, 1), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(bias.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)

    x = torch.from_numpy(rng.standard_normal((2, 8, 10, 10)).astype(np.float32))
    with torch.no_grad():
        want = block(x)
    got = torch.nn.functional.conv2d(x, kernel, bias, 1, 1, 1, groups)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    assert not hasattr(block, "_fold_cache")  # the branch form caches nothing
