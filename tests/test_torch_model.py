"""The port's dinov2 + LoRA pose model against the JAX package's.

The JAX model's variables are carried into the port by ``io/convert.py``.
LoRA B, the BatchNorm running stats and the LayerScales are randomised first
so that no path is an identity. Float32 on the CPU; heatmaps and z agree to
1e-4 abs (summation order across the whole network).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_pose_tpu.models import registry as jregistry
from dino_pose_tpu.models import heads as jheads
from dino_pose_tpu.models.vit import Dinov2Backbone as JaxBackbone
from dino_pose_tpu.nn import layers as jlayers
from dino_pose_tpu.ops import block as jblock
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu_torch.io.convert import state_dict_from_jax
from dino_pose_tpu_torch.models import heads as theads
from dino_pose_tpu_torch.models import registry as tregistry
from dino_pose_tpu_torch.models.vit import Dinov2Backbone, ViTConfig
from dino_pose_tpu_torch.nn import layers as tlayers

CONFIG = {"model_name": "test/vit-tiny", "use_lora": True}


def _randomise(variables: dict, rng: np.random.Generator) -> dict:
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
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
def models():
    jm = jregistry.create_model_from_config(dict(CONFIG), pretrained=False)
    variables = _randomise(jax.device_get(jm.variables), np.random.default_rng(0))
    tm = tregistry.create_model_from_config(dict(CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
    return jm, variables, tm


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(1).standard_normal((2, 3, 224, 224)).astype(np.float32)


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_pose_model_matches_jax(models, pixels, route, monkeypatch):
    """``fused``: the JAX side runs its Pallas kernels (interpret mode):
    _block_kernel for layer 0, _attn_part/_mlp_part kernels for the LoRA
    layer. ``unfused``: the JAX side runs its plain XLA math."""
    jm, variables, tm = models
    monkeypatch.setenv("DINO_POSE_TPU_BLOCK", route)
    calls = {"block": 0, "part": 0}
    fwd, part = jblock._fused_forward, jblock._part_call

    def count_fwd(*a, **k):
        calls["block"] += 1
        return fwd(*a, **k)

    def count_part(*a, **k):
        calls["part"] += 1
        return part(*a, **k)

    monkeypatch.setattr(jblock, "_fused_forward", count_fwd)
    monkeypatch.setattr(jblock, "_part_call", count_part)
    with jdispatch.local():
        hm_j, z_j = jm.module.apply(variables, jnp.asarray(pixels), train=False)
    assert calls == ({"block": 1, "part": 2} if route == "fused" else {"block": 0, "part": 0})
    with torch.inference_mode():
        hm_t, z_t = tm(torch.from_numpy(pixels))
    assert hm_t.shape == (2, 24, 48, 48) and z_t.shape == (2, 24)
    np.testing.assert_allclose(hm_t.numpy(), np.asarray(hm_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["bicubic", "nearest"])
def test_pos_interpolation_matches_jax(models, mode):
    """Backbone tokens at 168^2 (a 12x12 grid, not the stored 37x37)."""
    jm, variables, tm = models
    jcfg = dataclasses.replace(jm.module.vit, pos_interpolation=mode)
    x = np.random.default_rng(2).standard_normal((1, 3, 168, 168)).astype(np.float32)
    tok_j, grid_j = JaxBackbone(jcfg).apply(
        {"params": variables["params"]["backbone"]},
        jnp.asarray(x.transpose(0, 2, 3, 1)), deterministic=True,
    )
    tcfg = dataclasses.replace(tm.vit, pos_interpolation=mode)
    bb = Dinov2Backbone(tcfg).eval()
    bb.load_state_dict(
        {k[len("backbone."):]: v for k, v in tm.state_dict().items() if k.startswith("backbone.")},
        strict=True,
    )
    with torch.inference_mode():
        tok_t, grid_t = bb(torch.from_numpy(x))
    assert grid_t == tuple(grid_j) == (12, 12)
    np.testing.assert_allclose(tok_t.numpy(), np.asarray(tok_j), atol=1e-4, rtol=0)


def test_loading_a_state_dict_drops_the_packed_parameters(models):
    _, _, tm = models
    blk = tm.backbone.encoder.layer[0]
    before = blk.packed(torch.float32).wqkv.clone()
    sd = tm.state_dict()
    sd["backbone.encoder.layer.0.attention.attention.query.weight"] = torch.zeros(64, 64)
    fresh = tregistry.create_model_from_config(dict(CONFIG), device="cpu")
    fresh.backbone.encoder.layer[0].packed(torch.float32)
    fresh.load_state_dict(sd, strict=True)
    after = fresh.backbone.encoder.layer[0].packed(torch.float32).wqkv
    assert torch.equal(after[:, :64], torch.zeros(64, 64))
    assert torch.equal(after[:, 64:], before[:, 64:])


def test_state_dict_keys_are_the_reference_schema(models):
    _, _, tm = models
    keys = set(tm.state_dict())
    assert "backbone.encoder.layer.1.attention.original_attention.attention.query.weight" in keys
    assert "backbone.encoder.layer.1.attention.lora_output.lora_A" in keys
    assert "backbone.encoder.layer.0.attention.attention.query.weight" in keys
    assert "pose_heads.heatmap_head.feature_refine.3.bottleneck.4.running_var" in keys
    assert "pose_heads.z_head.mlp.9.weight" in keys


@pytest.mark.parametrize("fn", ["cubic_resize_matrix", "linear_resize_matrix",
                                "nearest_resize_matrix"])
@pytest.mark.parametrize("sizes", [(37, 16), (37, 12), (16, 48), (47, 48)])
def test_resize_matrices_match_jax(fn, sizes):
    np.testing.assert_array_equal(getattr(tlayers, fn)(*sizes), getattr(jlayers, fn)(*sizes))


def test_bilinear_resize_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 5, 13, 11)).astype(np.float32)
    want = np.asarray(jlayers.bilinear_resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (20, 7)))
    got = tlayers.bilinear_resize(torch.from_numpy(x), (20, 7)).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sizes", [(16, 48), (12, 48), (8, 64), (4, 48)])
def test_upsampling_plan_matches_jax(sizes):
    assert theads.upsampling_plan(*sizes) == jheads.upsampling_plan(*sizes)


def test_hourglass_refuses_grids_not_divisible_by_4():
    hg = theads.HourglassModule(8, 8).eval()
    with pytest.raises(ValueError, match="divisible by 4"):
        hg(torch.zeros(1, 8, 6, 6))


def test_lora_and_unfreeze_are_mutually_exclusive():
    with pytest.raises(ValueError, match="mutually exclusive"):
        Dinov2Backbone(ViTConfig(hidden_size=64, num_layers=2, num_heads=2,
                                 lora_layers=(1,), num_unfrozen_layers=1))


def test_registry_names_and_families():
    assert tregistry.resolve_model_name("dinov2") == "facebook/dinov2-small"
    assert tregistry.resolve_model_name("fastvit") == jregistry.resolve_model_name("fastvit")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tregistry.create_model_from_config({"model_name": "timm/fastvit_t8.apple_in1k"},
                                           device="cpu")
    with pytest.raises(ValueError, match="Unsupported"):
        tregistry.create_model_from_config({"model_name": "not/a-model"}, device="cpu")
    assert set(tregistry.BACKBONE_REGISTRY) == set(jregistry.BACKBONE_REGISTRY)


def test_training_mode_is_refused():
    tm = tregistry.create_model_from_config(dict(CONFIG), device="cpu").train()
    with pytest.raises(NotImplementedError, match="training"):
        tm(torch.zeros(1, 3, 224, 224))
