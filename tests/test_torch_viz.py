"""The port's ``viz`` against the JAX package's, on the CPU (Agg backend).

Both draw the same image from the same heatmaps (or keypoints); what each
figure draws — Circle centres, line data (2-D and 3-D), the 3-D scatter's
points and the label texts — is compared artist by artist. Both decode in
f32 on the CPU in another summation order: coordinates agree to 1e-3 px
(1e-6 of the 400 px width, a few f32 ulps of a weighted centroid).
"""

import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from dino_pose_tpu import viz as jviz  # noqa: E402
from dino_pose_tpu_torch import viz as tviz  # noqa: E402

ATOL_PX = 1e-3


def _drawn(fig) -> list:
    """Per axis: Circle centres, line data, 3-D scatter points, texts."""
    out = []
    for ax in fig.axes:
        lines = [np.asarray(ln.get_data_3d() if hasattr(ln, "get_data_3d") else ln.get_xydata(),
                            np.float64) for ln in ax.lines]
        scatter = [np.asarray(c._offsets3d, np.float64) for c in ax.collections
                   if hasattr(c, "_offsets3d")]
        texts = [(t.get_text(), *np.asarray(t.get_position(), np.float64)) for t in ax.texts]
        out.append({"circles": np.asarray([p.center for p in ax.patches], np.float64),
                    "lines": lines, "scatter": scatter, "texts": texts})
    plt.close(fig)
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["circles"], w["circles"], atol=ATOL_PX, rtol=0)
        assert len(g["lines"]) == len(w["lines"]) and len(g["scatter"]) == len(w["scatter"])
        for a, b in zip(g["lines"] + g["scatter"], w["lines"] + w["scatter"]):
            np.testing.assert_allclose(a, b, atol=ATOL_PX, rtol=0)
        assert [t[0] for t in g["texts"]] == [t[0] for t in w["texts"]]
        np.testing.assert_allclose(np.asarray([t[1:] for t in g["texts"]]).reshape(-1, 2),
                                   np.asarray([t[1:] for t in w["texts"]]).reshape(-1, 2),
                                   atol=ATOL_PX, rtol=0)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).integers(0, 256, (300, 400, 3), dtype=np.uint8)


def _heatmaps(shape, seed=1):
    """Peaked heatmaps (one Gaussian per channel), so that the decoded
    keypoints spread over the image and the skeleton's links are drawn."""
    rng = np.random.default_rng(seed)
    k, h, w = shape
    ys, xs = np.mgrid[0:h, 0:w]
    cy, cx = rng.uniform(0.2, 0.8, (2, k, 1, 1)) * np.array([h, w]).reshape(2, 1, 1, 1)
    hm = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * (0.05 * h) ** 2))
    return (hm + 0.05 * rng.random((k, h, w))).astype(np.float32)


# (K, H, W): the model's 48² maps, maps smaller than K, and the all-equal
# (K == H == W) case that both read as (K, H, W).
SHAPES = [(24, 48, 48), (24, 8, 8), (24, 24, 24)]
MODES = ["2d", "2d_labels", "3d", "combined"]


def _plot(mod, mode, image, hm, z):
    if mode == "2d":
        return mod.plot_keypoints(image, hm, keypoint_label=False)
    if mode == "2d_labels":
        return mod.plot_keypoints(image, hm, keypoint_label=True)
    if mode == "3d":
        return mod.plot_3d_keypoints(image, hm, z, keypoint_label=True)
    return mod.plot_keypoints_combined(image, hm, z)


# Each shape as (K, H, W), and as (H, W, K) where that is not ambiguous.
LAYOUTS = [(s, "khw") for s in SHAPES] + [(s, "hwk") for s in SHAPES[:2]]


@pytest.mark.parametrize("shape, layout", LAYOUTS,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
@pytest.mark.parametrize("mode", MODES)
def test_plots_draw_what_jax_draws(image, mode, shape, layout):
    hm = _heatmaps(shape)
    if layout == "hwk":
        hm = np.transpose(hm, (1, 2, 0))
    z = np.random.default_rng(2).standard_normal(shape[0]).astype(np.float32)
    _assert_same(_drawn(_plot(tviz, mode, image, hm, z)), _drawn(_plot(jviz, mode, image, hm, z)))


@pytest.mark.parametrize("mode", MODES)
def test_plots_of_keypoints_and_chw_float_images(mode):
    """(K, 2) keypoints are drawn as given; a CHW float image in [0, 1]."""
    rng = np.random.default_rng(3)
    img = rng.random((3, 120, 160)).astype(np.float32)
    kps = rng.uniform(0, 150, (24, 2)).astype(np.float32)
    z = rng.standard_normal(24).astype(np.float32)
    _assert_same(_drawn(_plot(tviz, mode, img, kps, z)), _drawn(_plot(jviz, mode, img, kps, z)))


def test_visualize_pose_and_fig_to_array(image):
    rng = np.random.default_rng(4)
    kps = np.concatenate([rng.uniform(0, 300, (24, 2)), rng.choice([0.0, 1.0, 2.0], (24, 1))], 1)
    _assert_same(_drawn(tviz.visualize_pose(image, kps)), _drawn(jviz.visualize_pose(image, kps)))
    fig = tviz.plot_keypoints(image, _heatmaps((24, 48, 48)), keypoint_label=False)
    arr = tviz.fig_to_array(fig)
    plt.close(fig)
    assert arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[-1] == 3


def test_refuses_what_it_cannot_read(image):
    with pytest.raises(ValueError, match="Cannot interpret"):
        tviz.plot_keypoints(image, np.zeros((24, 48)))


def test_viz_imports_without_matplotlib():
    """``import dino_pose_tpu_torch.viz`` (and the demo CLI) where matplotlib
    is not installed, as on the card machine."""
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import dino_pose_tpu_torch.viz, dino_pose_tpu_torch.cli.demo\n"
            "try:\n"
            "    dino_pose_tpu_torch.viz.plot_keypoints(None, None)\n"
            "except ImportError:\n"
            "    print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
