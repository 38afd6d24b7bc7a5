"""The port's serving path: decode, preprocessing, the predictor entry point,
device resolution, and the rule that the port imports no JAX."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dino_pose_tpu.data import preprocess as jpre
from dino_pose_tpu.ops import decode as jdecode
from dino_pose_tpu_torch.core.device import resolve_device
from dino_pose_tpu_torch.data import preprocess as tpre
from dino_pose_tpu_torch.models import registry as tregistry
from dino_pose_tpu_torch.ops import block as tblock
from dino_pose_tpu_torch.ops import decode as tdecode
from dino_pose_tpu_torch.serve import make_predictor

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def heatmaps():
    hm = np.random.default_rng(0).random((2, 3, 48, 48)).astype(np.float32)
    hm[0, 1] = 0.0                      # all-zero channel -> 0/0
    hm[1, 2, :4, :4] += 5.0             # peak at the corner (clamped window)
    return hm


def test_decode_matches_jax(heatmaps):
    want = np.asarray(jdecode.decode_heatmaps(jnp.asarray(heatmaps), (224, 224)))
    got = tdecode.decode_heatmaps(torch.from_numpy(heatmaps), (224, 224),
                                  guard_zero_window=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6, equal_nan=True)
    assert np.isnan(got[0, 1]).all() and np.isfinite(np.delete(got.reshape(-1, 2), 1, 0)).all()


def test_decode_guard_matches_jax(heatmaps, monkeypatch):
    monkeypatch.setattr(jdecode, "_GUARD_ZERO_WINDOW", True)
    want = np.asarray(jdecode.decode_heatmaps(jnp.asarray(heatmaps), (320, 240)))
    got = tdecode.decode_heatmaps(torch.from_numpy(heatmaps), (320, 240),
                                  guard_zero_window=True).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(got[0, 1], [0.5 / 48 * 320, 0.5 / 48 * 240])  # cell (0, 0)


def test_heatmap_confidences_match_jax(heatmaps):
    want = np.asarray(jdecode.heatmap_confidences(jnp.asarray(heatmaps)))
    np.testing.assert_array_equal(tdecode.heatmap_confidences(torch.from_numpy(heatmaps)).numpy(), want)


@pytest.mark.parametrize("name", ["facebook/dinov2-small", "timm/fastvit_t8.apple_in1k",
                                  "test/fastvit-tiny"])
@pytest.mark.parametrize("hw", [(300, 200), (180, 500), (100, 90)])
def test_preprocessor_matches_jax(name, hw):
    arr = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    image = Image.fromarray(arr)
    want = jpre.create_preprocessor(name)(image)["pixel_values"]
    got = tpre.create_preprocessor(name)(image)["pixel_values"]
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def tiny_model():
    return tregistry.create_model_from_config({"model_name": "test/vit-tiny", "use_lora": True},
                                              device="cpu")


def test_predictor_end_to_end_on_cpu(tiny_model):
    predict = make_predictor(tiny_model, device="cpu")
    rng = np.random.default_rng(4)
    images = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for h, w in ((300, 200), (224, 224))]
    tblock.reset_launches()
    kp, z, hm = predict(images)
    assert kp.shape == (2, 24, 2) and z.shape == (2, 24) and hm.shape == (2, 24, 48, 48)
    assert np.isfinite(kp).all() and np.isfinite(z).all() and np.isfinite(hm).all()
    assert all(n == 0 for n in tblock.LAUNCHES.values())   # the CPU runs the plain versions

    pixels = tpre.create_preprocessor("test/vit-tiny")(images)["pixel_values"]
    kp2, z2, hm2 = predict(pixels)                          # array input, same answer
    np.testing.assert_array_equal(kp2, kp)
    with torch.inference_mode():
        hm_ref, z_ref = tiny_model(torch.from_numpy(pixels))
    np.testing.assert_array_equal(hm, hm_ref.numpy())
    np.testing.assert_array_equal(z, z_ref.numpy())
    np.testing.assert_array_equal(kp, tdecode.decode_heatmaps(hm_ref, (224, 224)).numpy())
    with pytest.raises(ValueError, match="B, 3, H, W"):
        predict(pixels[:, :2])
    # Parameters packed under the predictor's inference_mode still serve a
    # forward outside it, with grad mode on.
    hm3, _ = tiny_model(torch.from_numpy(pixels))
    np.testing.assert_array_equal(hm3.detach().numpy(), hm)
    # Pixels that require grad would need a backward through the frozen
    # blocks, which the block kernels do not have: refused, not cut.
    with pytest.raises(ValueError, match="no backward"):
        tiny_model(torch.from_numpy(pixels).requires_grad_())


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(tiny_model):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card; the no-card refusal cannot be shown here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_predictor(tiny_model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tregistry.create_model_from_config({"model_name": "test/vit-tiny"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_no_jax():
    files = sorted((ROOT / "dino_pose_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    banned = {"jax", "flax", "optax", "dino_pose_tpu"}
    for path in files:
        bad = _imports(path) & banned
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
