"""The port's FastViT pose model against the JAX package's.

``test/fastvit-tiny`` (RepMixer stages, an attention stage behind RepCPE,
C = 64 in stage 3) is built once per file on each side. The JAX variables,
with BatchNorm running stats randomised, LayerScales at 0.1-1 (at the
default 1e-5 every block is nearly the identity and a wrong ConvFFN would
pass) and LoRA B made non-zero, are carried into the port through
``io/convert.state_dict_from_jax`` and loaded with ``strict=True``. Float32
on the CPU: heatmaps and z agree to 1e-4 abs on both of JAX's CPU routes
for the ConvFFN, its folded XLA chain (the default off a TPU) and its Pallas
kernel in interpret mode (``DINO_POSE_TPU_CONVFFN=force``), with LoRA on
and off. The heads, with their BatchNorms, barely see the backbone at these
random weights (zeroing LoRA B moves the heatmaps by 4e-6), so the
backbone's feature map is held too, to 1e-5 abs (max ~0.1; zeroing LoRA B
moves it by 5e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dino_pose_tpu.io import torch_bridge as jbridge
from dino_pose_tpu.models import fastvit as jfastvit
from dino_pose_tpu.models import heads as jheads
from dino_pose_tpu.models import registry as jregistry
from dino_pose_tpu.ops import convffn as jconvffn
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu.train import partition as jpartition
from dino_pose_tpu_torch.io import convert
from dino_pose_tpu_torch.models import fastvit as tfastvit
from dino_pose_tpu_torch.models import registry as tregistry
from dino_pose_tpu_torch.models.fastvit_pose import FastVitPoseModule
from dino_pose_tpu_torch.models.heads import SpatialAwarePoseHeads
from dino_pose_tpu_torch.ops import block as tblock
from dino_pose_tpu_torch.serve import make_predictor

CONFIG = {"model_name": "test/fastvit-tiny", "use_lora": True, "lora_rank": 4}


def _randomise(tree: dict, rng: np.random.Generator, path=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise(v, rng, path + (k,))
            continue
        v = np.asarray(v)
        if "lora_B" in path:
            v = rng.standard_normal(v.shape).astype(np.float32) * 0.05
        elif k.startswith("layer_scale"):
            v = rng.uniform(0.1, 1.0, v.shape).astype(np.float32)
        elif path and path[0] == "batch_stats":
            v = ((rng.standard_normal(v.shape) * 0.1) if k == "mean"
                 else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        out[k] = v
    return out


def _drop_lora(tree: dict) -> dict:
    return {k: _drop_lora(v) if isinstance(v, dict) else v
            for k, v in tree.items() if not k.endswith("_lora")}


@pytest.fixture(scope="module")
def jax_lora():
    """One JAX init: the LoRA model; the plain model is the same module with
    rank 0 and the LoRA variables dropped."""
    jm = jregistry.create_model_from_config(dict(CONFIG), pretrained=False)
    return jm.module, _randomise(jax.device_get(jm.variables), np.random.default_rng(0))


@pytest.fixture(scope="module", params=[True, False], ids=["lora", "plain"])
def models(request, jax_lora):
    jmodule, variables = jax_lora
    config = dict(CONFIG, use_lora=request.param)
    if not request.param:
        jmodule = jmodule.clone(cfg=dataclasses.replace(jmodule.cfg, lora_rank=0))
        variables = _drop_lora(variables)
    tm = tregistry.create_model_from_config(config, device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(variables, tm), strict=True)
    return jmodule, variables, tm


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(1).standard_normal((2, 3, 128, 128)).astype(np.float32)


@pytest.mark.parametrize("route", ["xla", "force", "0", "unset"])
def test_pose_model_matches_jax(models, pixels, route, monkeypatch):
    """Each value of JAX's ``DINO_POSE_TPU_CONVFFN`` against the port, which
    reads none (its ConvFFN rounds as both of JAX's routes do): ``xla``,
    ``0`` and unset, JAX's folded XLA ConvFFN chain (unset: the default off a
    TPU); ``force``: its Pallas ConvFFN kernel in interpret mode, once per
    block."""
    jmodule, variables, tm = models
    if route == "unset":
        monkeypatch.delenv("DINO_POSE_TPU_CONVFFN", raising=False)
    else:
        monkeypatch.setenv("DINO_POSE_TPU_CONVFFN", route)
    calls = []
    kernel = jconvffn._convffn_fwd_kernel
    monkeypatch.setattr(jconvffn, "_convffn_fwd_kernel",
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    with jdispatch.local():
        hm_j, z_j = jmodule.apply(variables, jnp.asarray(pixels), train=False)
        fmap_j = jfastvit.FastViTBackbone(jmodule.cfg).apply(
            {c: v["backbone"] for c, v in variables.items()},
            jnp.asarray(pixels.transpose(0, 2, 3, 1)), train=False)
    assert len(calls) == (2 * sum(tm.cfg.depths) if route == "force" else 0)
    with torch.inference_mode():
        hm_t, z_t = tm(torch.from_numpy(pixels))
        fmap_t = tm.backbone(torch.from_numpy(pixels))
    assert hm_t.shape == (2, 24, 48, 48) and z_t.shape == (2, 24)
    np.testing.assert_allclose(fmap_t.permute(0, 2, 3, 1).numpy(), np.asarray(fmap_j),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(hm_t.numpy(), np.asarray(hm_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-4, rtol=0)


def test_lora_reaches_the_feature_map(jax_lora, pixels):
    """With LoRA B non-zero the adapters move the feature map by far more
    than its parity tolerance, so the LoRA comparison above is not vacuous."""
    _, variables = jax_lora
    tm = tregistry.create_model_from_config(dict(CONFIG), device="cpu")
    tm.load_state_dict(convert.state_dict_from_jax(variables, tm), strict=True)
    with torch.inference_mode():
        fmap = tm.backbone(torch.from_numpy(pixels))
        for m in tm.modules():
            if isinstance(m, tfastvit.ConvLoRA):
                m.lora_B.weight.zero_()
        fmap0 = tm.backbone(torch.from_numpy(pixels))
    assert (fmap - fmap0).abs().max() > 100 * 1e-5


@pytest.mark.parametrize("lora", [True, False])
@pytest.mark.parametrize("variant", ["t8", "sa12", "sa24", "sa36", "ma36"])
def test_state_dict_keys_are_the_reference_schema(variant, lora):
    """The port's keys equal the torch keys of JAX's ``fastvit_pose_rules``
    (with BatchNorm's ``num_batches_tracked``), on the meta device."""
    config = {"use_lora": lora}
    jcfg = dataclasses.replace(jfastvit.FASTVIT_PRESETS[variant], lora_rank=8 if lora else 0)
    rules = jbridge.fastvit_pose_rules(jcfg)
    want = {r.torch_key for r in rules} | set(jbridge.num_batches_tracked_keys(rules))
    with torch.device("meta"):
        tm = FastVitPoseModule(tregistry.fastvit_config_for(variant, config))
    assert set(tm.state_dict()) == want
    assert {r.torch_key: r.kind for r in convert.fastvit_pose_rules(tm.cfg)} == \
        {r.torch_key: r.kind for r in rules}


def test_heads_take_the_reference_14_at_an_8x8_grid():
    """FastViT's heads plan from the fixed 14 (strides 3, 1, then the resize)
    on t8's 8x8 grid, as the JAX heads do; planned from the 8x8 grid they
    would need three stages where two were built."""
    jh = jheads.SpatialAwarePoseHeads(num_keypoints=24, heatmap_size=48, spatial_input_size=14)
    fmap = np.random.default_rng(2).standard_normal((2, 8, 8, 32)).astype(np.float32)
    variables = jax.device_get(jh.init(jax.random.key(0), jnp.asarray(fmap), train=False))
    variables = _randomise(variables, np.random.default_rng(3))
    hm_j, z_j = jh.apply(variables, jnp.asarray(fmap), train=False)
    th = SpatialAwarePoseHeads(32, 24, 48, spatial_input_size=14).eval()
    wrapped = {c: {"pose_heads": v} for c, v in variables.items()}
    rules = convert.spatial_heads_rules(len(th.heatmap_head.upsampling), torch_prefix="")
    flat = convert._flatten(wrapped)
    th.load_state_dict(
        {**{r.torch_key: torch.from_numpy(convert._to_torch(flat[r.jax_path], r.kind).copy())
            for r in rules},
         **{k: v for k, v in th.state_dict().items() if k.endswith("num_batches_tracked")}},
        strict=True)
    x = torch.from_numpy(fmap.transpose(0, 3, 1, 2).copy())
    with torch.inference_mode():
        hm_t, z_t = th(x, spatial_input_size=14)
        with pytest.raises(ValueError, match="needs 3 upsampling stages"):
            th(x)
    np.testing.assert_allclose(hm_t.numpy(), np.asarray(hm_j).transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-5, rtol=0)


def test_registry_builds_fastvit_t8_by_default():
    model = tregistry.create_model_from_config({"model_name": "fastvit"}, device="cpu",
                                               pretrained=False)
    assert model.model_name == jregistry.resolve_model_name("fastvit") == \
        "timm/fastvit_t8.apple_in1k"
    assert model.cfg.embed_dims == (48, 96, 192, 384) and model.input_size == 256
    assert model.cfg.lora_rank == 0 and not model.training
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 3, 256, 256))
                         .astype(np.float32))
    with torch.inference_mode():
        hm, z = model(x)                 # the 8x8 grid, planned from 14
    assert hm.shape == (1, 24, 48, 48) and z.shape == (1, 24)
    assert torch.isfinite(hm).all() and torch.isfinite(z).all()
    tiny = tregistry.create_model_from_config({"model_name": "test/fastvit-tiny"}, device="cpu")
    assert tiny.input_size == 128
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tregistry.create_model_from_config({"model_name": "fastvit"})


def test_trainable_parameters_follow_jax_mask(jax_lora):
    """requires_grad equals JAX's FastViT ``trainable_mask`` leaf by leaf:
    the heads, and with LoRA every ConvFFN's A and B."""
    _, variables = jax_lora
    for use_lora in (True, False):
        config = dict(CONFIG, use_lora=use_lora)
        params = variables["params"] if use_lora else _drop_lora(variables["params"])
        mask = jax.tree_util.tree_leaves_with_path(
            jpartition.trainable_mask(params, config, "fastvit"))
        want = {tuple(k.key for k in path): bool(v) for path, v in mask}
        tm = tregistry.create_model_from_config(config, device="cpu")
        named = dict(tm.named_parameters())
        rules = [r for r in convert.fastvit_pose_rules(tm.cfg) if r.jax_path[0] == "params"]
        assert {r.torch_key for r in rules} == set(named)
        assert {r.torch_key: named[r.torch_key].requires_grad for r in rules} == \
            {r.torch_key: want[r.jax_path[1:]] for r in rules}
        n_lora = sum(1 for n, p in named.items() if p.requires_grad and "lora_" in n)
        assert n_lora == (sum(tm.cfg.depths) * 4 if use_lora else 0)


def test_refusals():
    """What stays refused: a ConvFFN whose base fc1/fc2 require grad (its
    backward gives them no gradient, as JAX's does), in train mode and under
    grad in eval; eval under grad with trainable LoRA adapters (the eval
    cache holds no graph: they train in train mode); and on the card
    fastvit_ma36's C = 76, which the ConvFFN kernels' 16-wide tiles do not
    take."""
    model = tregistry.create_model_from_config(dict(CONFIG), device="cpu")
    x = torch.zeros(1, 3, 128, 128)
    with pytest.raises(ValueError, match="requires grad"):
        model(x)                         # eval under grad, LoRA A/B trainable
    model.train()(x)
    model.backbone.stages[0].blocks[0].mlp.fc1.original_conv.weight.requires_grad_(True)
    for mode in (model.train, model.eval):
        with pytest.raises(ValueError, match="requires grad"):
            mode()(x)
    with torch.no_grad():
        model.eval()(x)
    if torch.cuda.is_available():
        ma36 = tregistry.create_model_from_config(
            {"model_name": "timm/fastvit_ma36.apple_in1k"}, device="cuda", pretrained=False)
        with pytest.raises(ValueError, match="multiples of 16"), torch.no_grad():
            ma36(torch.zeros(1, 3, 256, 256, device="cuda", dtype=torch.bfloat16))


def test_mobileone_folds_match_branch_math():
    """A MobileOne block's eval fold (conv + scale branch + identity BN, at
    stride 1) and the pure-affine block (identity BN only) against their
    branch form with eval BatchNorm."""
    from dino_pose_tpu_torch.nn import layers as L

    torch.manual_seed(0)
    blocks = [tfastvit.MobileOneBlock(8, 8, 3, 1, use_act=False),
              tfastvit.MobileOneBlock(8, 8, 3, 1, groups=8, use_act=False,
                                      use_scale_branch=False, num_conv_branches=0)]
    x = torch.randn(2, 8, 10, 10)
    for blk in blocks:
        with torch.no_grad():
            for bn in [m for m in blk.modules() if isinstance(m, torch.nn.BatchNorm2d)]:
                bn.weight.uniform_(0.5, 1.5)
                bn.bias.normal_(0, 0.1)
                bn.running_mean.normal_(0, 0.1)
                bn.running_var.uniform_(0.5, 1.5)
        blk.eval()
        want = sum((L.batch_norm_eval(L.conv2d(x, br.conv), br.bn) for br in
                    [*blk.rbr_conv, *([blk.rbr_scale] if blk.rbr_scale else [])]),
                   torch.zeros_like(x)) + L.batch_norm_eval(x, blk.rbr_skip)
        with torch.inference_mode():
            torch.testing.assert_close(blk(x), want, atol=1e-5, rtol=1e-5)


def test_loading_a_state_dict_refolds(models, pixels):
    """The folded kernels are cached per parameter version: a new state dict
    (here a zero RepMixer layer scale and stage-0 ConvFFN) reaches the
    forward."""
    _, _, tm = models
    x = torch.from_numpy(pixels[:1])
    fresh = tregistry.create_model_from_config(
        dict(CONFIG, use_lora=tm.cfg.lora_rank > 0), device="cpu")
    with torch.inference_mode():
        before = fresh(x)[0]
    fresh.load_state_dict(tm.state_dict(), strict=True)
    with torch.inference_mode():
        after, want = fresh(x)[0], tm(x)[0]
    assert torch.equal(after, want) and not torch.equal(before, after)


def test_predictor_serves_fastvit_on_cpu(models):
    _, _, tm = models
    predict = make_predictor(tm, device="cpu")
    rng = np.random.default_rng(5)
    images = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for h, w in ((300, 200), (128, 160))]
    tblock.reset_launches()
    kp, z, hm = predict(images)
    assert kp.shape == (2, 24, 2) and z.shape == (2, 24) and hm.shape == (2, 24, 48, 48)
    assert np.isfinite(kp).all() and np.isfinite(z).all() and np.isfinite(hm).all()
    assert all(n == 0 for n in tblock.LAUNCHES.values())   # the CPU runs the plain versions
    assert (kp >= 0).all() and (kp <= 128).all()           # decoded into the 128² crop
