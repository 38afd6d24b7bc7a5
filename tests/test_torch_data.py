"""The port's data pipeline against the JAX package's, on the CPU.

COCO-format images and annotations are written by the tests, from a seed:
mixed image sizes (portrait and landscape), mixed visibility, keypoints
near the borders. Tolerances: the annotations, the augmentation draws and
chains, and the loader's batches (host path and device-warp fields) are
bit-equal (the same numpy and PIL operations in the same order); the device
warp (f32 torch against JAX's XLA program) agrees to 1e-5 abs in normalised
pixel units on affines whose entries lie on a 1/64 grid, where every product
and sum before the normalisation is exact in f32. On the chain's own affines
XLA:CPU contracts ``a*x + b*y + c`` into fused multiply-adds, differently in
each fusion, so a sample coordinate moves by up to an ulp of the canvas
size (6.1e-5 at 512) and a pixel by that times the neighbouring pixels'
difference: held there to 2 such ulps times 255, in normalised units. The
heatmap targets ``prepare_batch`` renders agree to 1e-6 (the step tests'
render tolerance).
"""

import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dino_pose_tpu.config import get_default_configs as jax_default_configs
from dino_pose_tpu.data import augment as jaugment
from dino_pose_tpu.data import coco as jcoco
from dino_pose_tpu.data import dataset as jdataset
from dino_pose_tpu.data import keypoints as jkeypoints
from dino_pose_tpu.data import warp as jwarp
from dino_pose_tpu.train import step as jstep
from dino_pose_tpu_torch.config import get_default_configs
from dino_pose_tpu_torch.data import augment as taugment
from dino_pose_tpu_torch.data import coco as tcoco
from dino_pose_tpu_torch.data import dataset as tdataset
from dino_pose_tpu_torch.data import keypoints as tkeypoints
from dino_pose_tpu_torch.data import warp as twarp
from dino_pose_tpu_torch.train import step as tstep

K = 24
# (height, width): landscape, portrait, square, odd sizes.
SIZES = ((240, 320), (640, 480), (224, 224), (333, 500), (300, 256))
MODEL = {"model_name": "test/vit-tiny", "num_keypoints": K, "output_heatmap_size": 48}
WARP_ATOL = 1e-5
# Two ulps of a canvas coordinate near 512 (2**-14 each) times the largest
# pixel step (255), in normalised units (/ 255 / the smallest ImageNet std).
WARP_ULP_ATOL = 2 * 2.0**-14 * 255 / (255 * 0.225)
AFFINE_KEYS = ("affine", "f3_affine", "f2_affine")


def on_grid(batch: dict) -> dict:
    """``batch`` with its affines rounded to multiples of 1/64."""
    return {k: np.round(v * 64) / 64 if k in AFFINE_KEYS else v for k, v in batch.items()}


def write_coco(root, n: int, seed: int, sizes=SIZES, image_ext: str = "jpg"):
    """Write ``n`` seeded images and a COCO keypoint annotation file under
    ``root``; returns (images dir, annotation path)."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / "images" / f"{i}.{image_ext}")
        kps = np.stack([rng.uniform(0.15 * w, 0.85 * w, K), rng.uniform(0.15 * h, 0.85 * h, K),
                        rng.choice([0.0, 1.0, 2.0], K, p=[0.2, 0.3, 0.5])], 1)
        kps[i % K, :2] = (w - 1, h - 1)  # one keypoint on the far corner
        images.append({"id": i, "file_name": f"{i}.{image_ext}", "width": w, "height": h})
        annotations.append({"id": i, "image_id": i, "num_keypoints": K,
                            "keypoints": kps.reshape(-1).tolist(),
                            "keypoints_z": rng.uniform(-40, 40, K).tolist()})
    (root / "ann.json").write_text(json.dumps({"images": images, "annotations": annotations}))
    return root / "images", root / "ann.json"


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    return write_coco(tmp_path_factory.mktemp("coco"), 10, seed=0)


def test_default_configs_match_jax():
    assert get_default_configs() == jax_default_configs()


def test_coco_records_match_jax(coco_dir):
    _, ann = coco_dir
    got, want = tcoco.CocoPoseAnnotations(ann), jcoco.CocoPoseAnnotations(ann)
    assert len(got) == len(want) == 10 and got.num_keypoints == want.num_keypoints == K
    for g, w in zip(got.records, want.records):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            else:
                assert a == b
        assert tcoco.image_path("d", g) == jcoco.image_path("d", w)


@pytest.mark.parametrize("overrides", [{}, {"pre_crop": False, "is_scale": False},
                                       {"is_crop": False, "is_occultation": False},
                                       {"is_resize_shortest_edge": False}])
def test_augment_chain_matches_jax(overrides):
    _, _, preproc, _ = get_default_configs()
    preproc.update(overrides)
    rng = np.random.default_rng(3)
    for seed in range(12):
        h, w = SIZES[seed % len(SIZES)]
        kps = np.stack([rng.uniform(0, w, K), rng.uniform(0, h, K),
                        rng.choice([0.0, 1.0, 2.0], K)], 1)
        z = rng.uniform(-40, 40, K)
        pt = taugment.AugmentParams.draw(np.random.default_rng(seed), preproc)
        pj = jaugment.AugmentParams.draw(np.random.default_rng(seed), preproc)
        assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
        st, kt, zt = taugment.build_chain(kps, z, (w, h), pt, preproc)
        sj, kj, zj = jaugment.build_chain(kps, z, (w, h), pj, preproc)
        assert dataclasses.asdict(st) == dataclasses.asdict(sj)
        assert np.array_equal(kt, kj) and np.array_equal(zt, zj)
        image = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        assert np.array_equal(np.asarray(taugment.augment_image_host(image, st, preproc)),
                              np.asarray(jaugment.augment_image_host(image, sj, preproc)))


def test_keypoint_normalisation_matches_jax():
    rng = np.random.default_rng(4)
    kps = np.stack([rng.uniform(0, 224, (6, K)), rng.uniform(0, 224, (6, K)),
                    rng.choice([0.0, 2.0], (6, K))], -1).astype(np.float32)
    kps[0, :, 2] = 0  # no visible keypoint: the eps scale
    z = rng.uniform(-40, 40, (6, K)).astype(np.float32)
    pred = rng.standard_normal((6, K)).astype(np.float32)
    got = tkeypoints.normalize_z(torch.from_numpy(kps), torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, np.asarray(jkeypoints.normalize_z(kps, z)), rtol=1e-6, atol=0)
    assert np.array_equal(tkeypoints.normalize_z_np(kps, z), jkeypoints.normalize_z_np(kps, z))
    got = tkeypoints.denormalize_z(*(torch.from_numpy(a) for a in (pred, z, kps))).numpy()
    np.testing.assert_allclose(got, np.asarray(jkeypoints.denormalize_z(pred, z, kps)),
                               rtol=1e-6, atol=1e-5)


def _loaders(coco_dir, device_warp: bool, **kw):
    images, ann = coco_dir
    _, _, preproc, _ = get_default_configs()
    common = dict(batch_size=4, num_workers=2, device_warp=device_warp,
                  render_targets=not device_warp, seed=7, **kw)
    return (tdataset.create_dataloaders(preproc, MODEL, images, ann, **common),
            jdataset.create_dataloaders(preproc, MODEL, images, ann, **common))


@pytest.mark.parametrize("device_warp", [False, True])
def test_loader_batches_bit_equal_to_jax(coco_dir, device_warp):
    """Epochs 0 and 1 (new shuffles and draws), then a fast-forward to
    epoch 3, as auto-resume does; the host path's pixels and heatmap
    targets, or the device-warp fields."""
    tl, jl = _loaders(coco_dir, device_warp)
    assert len(tl) == len(jl) == 2
    keys = ({"canvas", "affine", "pad_color", "src_wh", "occ", "f3_affine", "f2_affine",
             "frame", "2d_keypoints", "z_coords"} if device_warp
            else {"image", "2d_heatmaps", "2d_keypoints", "z_coords"})
    for epoch in (0, 1, 3):
        if epoch == 3:
            tl.set_epoch(3)
            jl.set_epoch(3)
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) == 2
        for t, j in zip(tb, jb):
            assert set(t) == set(j) == keys
            for k in keys:
                assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
                assert np.array_equal(t[k], j[k]), (epoch, k)


def test_eval_loader_and_pad_batch_match_jax(coco_dir):
    tl, jl = _loaders(coco_dir, False, drop_last=False, shuffle=False)
    tb, jb = list(tl), list(jl)
    assert len(tb) == len(jb) == 3
    (t, tv), (j, jv) = tdataset.pad_batch(tb[-1], 4), jdataset.pad_batch(jb[-1], 4)
    assert np.array_equal(tv, jv) and tv.tolist() == [True, True, False, False]
    for k in j:
        assert np.array_equal(t[k], j[k]), k


def test_device_warp_refusals():
    _, _, preproc, _ = get_default_configs()
    with pytest.raises(ValueError, match="standard augmentation chain"):
        tdataset.PoseDataset("d", "a.json", None, K, dict(preproc, is_crop=False), MODEL,
                             device_warp=True, render_targets=False)
    with pytest.raises(ValueError, match="render_targets=False"):
        tdataset.PoseDataset("d", "a.json", None, K, preproc, MODEL, device_warp=True)


def _warp_inputs(coco_dir):
    """Device-warp samples from the loader, plus three built here: a 30°
    rotation with a flip, a flip alone on a portrait image, and an affine
    that lands exactly on the canvas's last row and column (the
    clipped-corner weights)."""
    tl, _ = _loaders(coco_dir, True)
    batch = next(iter(tl))
    samples = [{k: v[i] for k, v in batch.items()} for i in range(len(batch["affine"]))]
    images, ann = coco_dir
    rec = tcoco.CocoPoseAnnotations(ann)[1]
    img = Image.open(images / rec.file_name).convert("RGB")
    _, _, preproc, _ = get_default_configs()
    for params, cfg in (
        (taugment.AugmentParams(degrees=30.0, flip=True, pad_color=(10, 200, 30)), preproc),
        (taugment.AugmentParams(flip=True),
         dict(preproc, pre_crop=False, is_rotate=False, is_scale=False)),
    ):
        spec, _, _ = taugment.build_chain(rec.keypoints, rec.keypoints_z, img.size, params, cfg)
        canvas, scale = twarp.letterbox_canvas(img)
        w = twarp.chain_affine(spec, img.size, scale, model_input=224, shortest_edge=256)
        samples.append({"canvas": canvas, "affine": w.affine, "pad_color": w.pad_color,
                        "src_wh": np.array([w.src_w, w.src_h], np.float32), "occ": w.occ,
                        "f3_affine": w.f3_affine, "f2_affine": w.f2_affine, "frame": w.frame})
    assert samples[-1]["frame"][2] == 0 and samples[-2]["frame"][2] == 30.0
    ident = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
    canvas = np.random.default_rng(5).integers(0, 256, (512, 512, 3), dtype=np.uint8)
    samples.append({"canvas": canvas,
                    "affine": np.array([[1, 0, 288], [0, 1, 288]], np.float32),
                    "pad_color": np.full(3, -1.0, np.float32),
                    "src_wh": np.array([512, 512], np.float32), "occ": np.full(4, -1.0, np.float32),
                    "f3_affine": ident, "f2_affine": ident,
                    "frame": np.array([224, 224, 0], np.float32)})
    return {k: np.stack([s[k] for s in samples]) for k in twarp.WARP_KEYS}


@pytest.mark.parametrize("grid", [True, False])
def test_warp_batch_matches_jax(coco_dir, grid):
    warp = _warp_inputs(coco_dir)
    if grid:
        warp = on_grid(warp)
    args = [warp[k] for k in twarp.WARP_KEYS]
    got = twarp.warp_batch(*(torch.from_numpy(a) for a in args), model_input=224).numpy()
    want = np.asarray(jwarp.warp_batch(*(jnp.asarray(a) for a in args), model_input=224))
    assert got.shape == want.shape == (len(args[0]), 3, 224, 224) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=WARP_ATOL if grid else WARP_ULP_ATOL, rtol=0)
    # The edge case reads the canvas's last pixel with weight 1.
    canvas = warp["canvas"][-1].astype(np.float32) / 255.0
    last = (canvas[511, 511] - twarp.IMAGENET_MEAN) / twarp.IMAGENET_STD
    np.testing.assert_allclose(got[-1, :, 223, 223], last, atol=WARP_ATOL)


def test_prepare_batch_warps_canvas_batches_like_jax(coco_dir):
    """A device-warp batch through both ``prepare_batch`` wrappers around an
    identity step: the warped pixels and the rendered targets."""
    tl, _ = _loaders(coco_dir, True)
    batch = on_grid(next(iter(tl)))

    def identity(state, b):
        return b

    got = tstep.prepare_batch(identity, (224, 48))(None, {k: torch.from_numpy(v)
                                                          for k, v in batch.items()})
    want = jstep._prepare_batch(identity, (224, 48))(None, {k: jnp.asarray(v)
                                                            for k, v in batch.items()})
    assert "canvas" not in got and set(got) == set(want)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]),
                               atol=WARP_ATOL, rtol=0)
    np.testing.assert_allclose(got["2d_heatmaps"].numpy(), np.asarray(want["2d_heatmaps"]),
                               atol=1e-6, rtol=0)
    for k in ("2d_keypoints", "z_coords"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    bf16 = tstep.prepare_batch(identity, (224, 48), torch.bfloat16)(
        None, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert bf16["image"].dtype == torch.bfloat16
    for prep, arrays in ((tstep.prepare_batch, torch.from_numpy), (jstep._prepare_batch, jnp.asarray)):
        with pytest.raises(ValueError, match="device_targets"):
            prep(identity, None)(None, {k: arrays(v) for k, v in batch.items()})


def test_letterbox_and_chain_affine_match_jax(coco_dir):
    images, ann = coco_dir
    _, _, preproc, _ = get_default_configs()
    for rec in tcoco.CocoPoseAnnotations(ann).records[:5]:
        img = Image.open(images / rec.file_name).convert("RGB")
        ct, st = twarp.letterbox_canvas(img)
        cj, sj = jwarp.letterbox_canvas(img)
        assert np.array_equal(ct, cj) and st == sj
        params = taugment.AugmentParams.draw(np.random.default_rng(rec.image_id), preproc)
        spec, _, _ = taugment.build_chain(rec.keypoints, rec.keypoints_z, img.size, params, preproc)
        wt = twarp.chain_affine(spec, img.size, st, 224, 256)
        wj = jwarp.chain_affine(spec, img.size, sj, 224, 256)
        for f in dataclasses.fields(wj):
            a, b = getattr(wt, f.name), getattr(wj, f.name)
            assert np.array_equal(a, b) if isinstance(b, np.ndarray) else math.isclose(a, b, rel_tol=0)
