"""The port's dinov2 + LoRA pose model against the JAX package's.

The JAX model's variables are carried into the port by ``io/convert.py``.
LoRA B, the BatchNorm running stats and the LayerScales are randomised first
so that no path is an identity. Float32 on the CPU; heatmaps and z agree to
1e-4 abs (summation order across the whole network).
"""

import dataclasses
import importlib

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


@pytest.fixture(scope="module")
def plain_models():
    """test/vit-tiny without LoRA (the unfreeze configurations' tree)."""
    config = {"model_name": "test/vit-tiny"}
    jm = jregistry.create_model_from_config(dict(config), pretrained=False)
    variables = _randomise(jax.device_get(jm.variables), np.random.default_rng(5))
    tm = tregistry.create_model_from_config(dict(config), device="cpu")
    tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
    return jm, variables, tm


@pytest.mark.parametrize("attention", ["xla", "pallas"])
@pytest.mark.parametrize("lora", [True, False])
def test_pose_model_at_504_matches_jax(models, plain_models, lora, attention, monkeypatch):
    """dinov2 at 504² (a 36x36 grid, S = 1297): the JAX package's own route
    there is block_math around ``attention()`` in every layer, set on the
    CPU by ``DINO_POSE_TPU_BLOCK=unfused``; ``pallas`` runs its flash kernel
    in each layer (interpret mode), ``xla`` its unfused attention. The heads
    take a one-stage upsampling plan at this grid."""
    jm, variables, tm = models if lora else plain_models
    monkeypatch.setenv("DINO_POSE_TPU_BLOCK", "unfused")
    monkeypatch.setenv("DINO_POSE_TPU_ATTENTION", attention)
    jattention = importlib.import_module("dino_pose_tpu.ops.attention")
    calls = []
    flash = jattention._flash_kernel
    monkeypatch.setattr(jattention, "_flash_kernel", lambda *a, **k: calls.append(1) or flash(*a, **k))
    x = np.random.default_rng(6).standard_normal((1, 3, 504, 504)).astype(np.float32)
    with jdispatch.local():
        hm_j, z_j = jm.module.apply(variables, jnp.asarray(x), train=False)
    assert len(calls) == (2 if attention == "pallas" else 0)
    with torch.inference_mode():
        hm_t, z_t = tm(torch.from_numpy(x))
    assert hm_t.shape == (1, 24, 48, 48) and z_t.shape == (1, 24)
    np.testing.assert_allclose(hm_t.numpy(), np.asarray(hm_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-4, rtol=0)


@pytest.mark.parametrize("grid", [16, 20, 24, 28, 36])
def test_heads_take_their_plan_from_the_grid(models, grid):
    """The heads against JAX's built for the grid they are given (JAX passes
    ``spatial_input_size=hp`` at call time): 16 runs both upsampling stages
    (strides 3, 1), 20 both (2, 1), 24-36 the first alone (stride 2 or 1),
    with the parameters built for 16."""
    _, variables, tm = models
    fmap = np.random.default_rng(grid).standard_normal((2, grid, grid, 64)).astype(np.float32)
    heads = jheads.SpatialAwarePoseHeads(num_keypoints=24, heatmap_size=48,
                                         spatial_input_size=grid)
    hm_j, z_j = heads.apply({"params": variables["params"]["pose_heads"],
                             "batch_stats": variables["batch_stats"]["pose_heads"]},
                            jnp.asarray(fmap), train=False)
    with torch.inference_mode():
        hm_t, z_t = tm.pose_heads(torch.from_numpy(fmap.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(hm_t.numpy(), np.asarray(hm_j).transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-5, rtol=0)


def test_heads_refuse_a_plan_longer_than_built(models):
    """An 8x8 grid needs three upsampling stages; the heads hold two (as the
    JAX parameters do), so the call raises."""
    _, _, tm = models
    with pytest.raises(ValueError, match="needs 3 upsampling stages"):
        tm.pose_heads(torch.zeros(1, 64, 8, 8))


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
    fastvit = tregistry.create_model_from_config({"model_name": "timm/fastvit_sa12.apple_in1k"},
                                                 device="cpu")
    assert fastvit.model_name == "timm/fastvit_sa12.apple_in1k"
    assert fastvit.cfg.token_mixers[-1] == "attention" and fastvit.input_size == 256
    with pytest.raises(ValueError, match="Unsupported"):
        tregistry.create_model_from_config({"model_name": "not/a-model"}, device="cpu")
    assert set(tregistry.BACKBONE_REGISTRY) == set(jregistry.BACKBONE_REGISTRY)


def test_train_mode_forward_runs():
    """Train mode: BatchNorm on batch statistics, gradients reach the LoRA
    adapter and the heads, and no frozen backbone weight."""
    tm = tregistry.create_model_from_config(dict(CONFIG), device="cpu").train()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 3, 224, 224)).astype(np.float32))
    hm, z = tm(x, generator=torch.Generator().manual_seed(0))
    (hm.square().mean() + z.square().mean()).backward()
    lora = tm.backbone.encoder.layer[1].attention.lora_output
    assert lora.lora_A.grad is not None and lora.lora_B.grad.abs().max() > 0
    assert all(p.grad is None for n, p in tm.backbone.named_parameters() if "lora_output" not in n)
    assert all(p.grad is not None for p in tm.pose_heads.parameters())
    assert tm.pose_heads.heatmap_head.feature_refine[1].num_batches_tracked.item() == 1


def test_train_mode_refuses_what_the_port_cannot_train():
    """A LoRA layer's backward gives its base weights no gradient, so a base
    weight that requires grad is refused under grad mode. A plain block whose
    weight requires grad trains through block_train."""
    from dino_pose_tpu_torch.train.partition import apply_partition

    tm = tregistry.create_model_from_config(dict(CONFIG), device="cpu").train()
    x = torch.zeros(1, 3, 224, 224)
    base = tm.backbone.encoder.layer[1].attention.original_attention.attention.query.weight
    base.requires_grad_(True)
    with pytest.raises(ValueError, match="LoRA layer's base weight requires grad"):
        tm(x)
    with torch.no_grad():
        tm(x)                       # nothing to differentiate: runs
    config = {"model_name": "test/vit-tiny", "unfreeze_last_n_layers": 1}
    model = tregistry.create_model_from_config(config, device="cpu").train()
    assert apply_partition(model, config) >= {"backbone.encoder.layer.1.mlp.fc1.weight"}
    hm, z = model(x)
    (hm.square().mean() + z.square().mean()).backward()
    fc1 = model.backbone.encoder.layer[1].mlp.fc1.weight
    assert fc1.grad is not None and fc1.grad.abs().max() > 0
