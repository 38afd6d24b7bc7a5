"""The port's evaluation, schedule, training loop and training CLI, on the CPU.

Tolerances: the PCKh metrics agree with the JAX package's to 1e-6 abs (f32
counts over the same thresholds); the plateau schedule is equal; the
dataset PCKh of ``test/vit-tiny`` + LoRA (JAX's variables, randomised,
carried by ``io/convert.py``, f32) equals JAX's on images whose crop margins
are even, where JAX's float crop offset and the port's integer one agree.
``fit(device="cpu")`` runs end to end on images and annotations the tests
write (``test_torch_data.write_coco``).
"""

import csv
import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dino_pose_tpu.config import load_config_file as jax_load_config_file
from dino_pose_tpu.models import registry as jregistry
from dino_pose_tpu.train import evaluate as jevaluate
from dino_pose_tpu.train import loop as jloop
from dino_pose_tpu.train import metrics as jmetrics
from dino_pose_tpu.train import schedule as jschedule
from dino_pose_tpu_torch.cli import train as tcli
from dino_pose_tpu_torch.config import get_default_configs, load_config_file
from dino_pose_tpu_torch.core.mesh import MeshSpec, create_mesh
from dino_pose_tpu_torch.data.preprocess import create_preprocessor
from dino_pose_tpu_torch.io import checkpoint as tck
from dino_pose_tpu_torch.io.convert import state_dict_from_jax
from dino_pose_tpu_torch.models import registry as tregistry
from dino_pose_tpu_torch.ops import dispatch
from dino_pose_tpu_torch.train import evaluate as tevaluate
from dino_pose_tpu_torch.train import loop as tloop
from dino_pose_tpu_torch.train import metrics as tmetrics
from dino_pose_tpu_torch.train import schedule as tschedule
from dino_pose_tpu_torch.utils import profiling
from test_torch_data import write_coco
from test_torch_model import _randomise

K = 24
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (height, width) with even crop margins: shortest edge to 256, centre crop 224.
EVEN_SIZES = ((256, 256), (256, 300), (320, 256), (320, 448), (256, 384))
# fit draws the loss plot where matplotlib imports.
PLOTS = importlib.util.find_spec("matplotlib") is not None


# ---------------------------------------------------------------------------
# Metrics and schedule
# ---------------------------------------------------------------------------

def _metric_inputs(seed: int, b: int = 16):
    rng = np.random.default_rng(seed)
    target = np.stack([rng.uniform(0, 224, (b, K)), rng.uniform(0, 224, (b, K)),
                       rng.choice([0.0, 1.0, 2.0], (b, K), p=[0.3, 0.3, 0.4])], -1)
    pred = target[..., :2] + rng.normal(0, 20, (b, K, 2))
    target[0, [0, 1], 2] = 0            # no head: the hips' threshold
    target[1, [0, 1, 8, 11], 2] = 0     # neither pair: 0
    target[2, :, 2] = 0                 # nothing visible
    target_z = rng.uniform(-40, 40, (b, K))
    target_z[3, :] = 0                  # z fallback over no non-zero value
    pred_z = rng.standard_normal((b, K))
    return [a.astype(np.float32) for a in (pred, target, pred_z, target_z)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    pred, target, pred_z, target_z = _metric_inputs(seed)
    t = [torch.from_numpy(a) for a in (pred, target, pred_z, target_z)]
    for ratio in (0.5, 0.2):
        np.testing.assert_allclose(tmetrics.pckh_2d(t[0], t[1], ratio).numpy(),
                                   np.asarray(jmetrics.pckh_2d(pred, target, ratio)), atol=1e-6)
        np.testing.assert_allclose(tmetrics.pck_bbox(t[0], t[1], ratio).numpy(),
                                   np.asarray(jmetrics.pck_bbox(pred, target, ratio)), atol=1e-6)
    got = tmetrics.pckh_z(t[2], t[3], t[1]).numpy()
    np.testing.assert_allclose(got, np.asarray(jmetrics.pckh_z(pred_z, target_z, target)),
                               atol=1e-6)
    assert tmetrics.pckh_2d(t[0], t[1])[1] == 0 and tmetrics.pckh_2d(t[0], t[1])[2] == 0


def test_plateau_schedule_matches_jax():
    losses = [1.0, 0.9, 0.9, 0.95, 0.9, 0.91, 0.5, 0.5, 0.5, 0.5, 0.5, 0.49995, 0.4] + [0.4] * 100
    ts, js = tschedule.PlateauState(lr=1e-3), jschedule.PlateauState(lr=1e-3)
    for loss in losses:
        ts, js = tschedule.plateau_step(ts, loss), jschedule.plateau_step(js, loss)
        assert ts.state_dict() == js.state_dict()
    assert ts.lr == 1e-6  # decayed to the floor
    assert tschedule.PlateauState.from_state_dict({**ts.state_dict(), "x": 1}) == ts


# ---------------------------------------------------------------------------
# Dataset PCKh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    config = {"model_name": "test/vit-tiny", "use_lora": True}
    jm = jregistry.create_model_from_config(dict(config), pretrained=False)
    jm.variables = _randomise(jax.device_get(jm.variables), np.random.default_rng(0))
    tm = tregistry.create_model_from_config(dict(config), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jm.variables, tm), strict=True)
    return jm, tm


def test_dataset_pckh_matches_jax(models, tmp_path):
    jm, tm = models
    images, ann = write_coco(tmp_path, 7, seed=3, sizes=EVEN_SIZES)
    got = tevaluate.compute_pckh_dataset(tm, images, ann, batch_size=4, num_workers=2,
                                         return_all=True)
    want = jevaluate.compute_pckh_dataset(jm, images, ann, batch_size=4, num_workers=2,
                                          return_all=True)
    assert got == pytest.approx(want, abs=1e-6)
    assert 0 < got["pckh"] < 1 and not tm.training
    assert tevaluate.compute_pckh_dataset(tm, images, ann, batch_size=4) == (
        got["pckh"], got["pckh_z"])


def test_crop_offset_is_the_preprocessors_integer_one(tmp_path):
    """On an odd margin (320x240: resized to 341x256, 117 columns to crop)
    the offset is (341 - 224) // 2 = 58, where the preprocessor's crop
    starts; JAX's evaluate computes 58.5 there (a reference fault)."""
    proc = create_preprocessor("test/vit-tiny")
    image = Image.fromarray(np.random.default_rng(0).integers(0, 256, (240, 320, 3), np.uint8))
    frame = tevaluate.crop_frame(proc, 320, 240)
    assert np.array_equal(frame, np.float32([58, 16, 320 / 341, 240 / 256]))
    resized = np.asarray(image.resize((341, 256), Image.BICUBIC), np.float32)
    crop = resized[16:16 + 224, 58:58 + 224] / np.float32(255.0)
    want = np.transpose((crop - proc.mean) / proc.std, (2, 0, 1))
    assert np.array_equal(proc(image)["pixel_values"][0], want)


# ---------------------------------------------------------------------------
# fit and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    train = write_coco(root / "train", 16, seed=10)
    val = write_coco(root / "val", 6, seed=11)
    return train, val


def _configs(data, checkpoint_dir, **training):
    (ti, ta), (vi, va) = data
    d, t, p, m = get_default_configs()
    d.update(train_images_dir=str(ti), train_annotation_json=str(ta),
             val_images_dir=str(vi), val_annotation_json=str(va))
    t.update(batch_size=4, num_epochs=2, save_freq=1, checkpoint_dir=str(checkpoint_dir),
             multiprocessing_num=2, learning_rate=1e-3)
    t.update(training)
    m.update(model_name="test/vit-tiny")
    return d, t, p, m


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_fit_end_to_end_with_resume(data, tmp_path):
    ck = tmp_path / "ck"
    cfgs = _configs(data, ck)
    baseline = tevaluate.compute_pckh_dataset(
        tregistry.create_model_from_config(cfgs[3], device="cpu"), *data[1], batch_size=4)
    history = tloop.fit(*cfgs, device="cpu", progress=False)
    assert len(history["train_loss"]) == len(history["val_loss"]) == 2
    assert all(np.isfinite(history["train_loss"] + history["val_loss"]))
    assert history["state"].step == 8 and len(history["pckh_seconds"]) == 3
    rows = _csv(ck / "metrics.csv")
    assert list(rows[0]) == tloop.MetricsWriter.FIELDS == jloop.MetricsWriter.FIELDS
    assert [r["epoch"] for r in rows] == ["1", "2"]
    # The PCKh gate: a best_model_k.pth where either PCKh beat every earlier one.
    best = list(baseline)
    for r in rows:
        p = (float(r["pckh_2d"]), float(r["pckh_3d"]))
        gated = p[0] > best[0] or p[1] > best[1]
        assert (ck / f"best_model_{r['epoch']}.pth").exists() == gated, (r, best)
        best = [max(a, b) for a, b in zip(best, p)]
    assert (ck / "final_model.pth").exists() and (ck / "loss_plot.png").exists() == PLOTS
    final = tck.load_checkpoint(ck / "final_model.pth")
    assert final["epoch"] == 2 and final["step"] == 8
    assert final["optimizer_state_dict"]["state"]
    shutil.copy(ck / "final_model.pth", tmp_path / "epoch2.pth")

    # Auto-resume: the latest .pth in checkpoint_dir, one more epoch.
    again = tloop.fit(*cfgs, device="cpu", progress=False, num_epochs=3)
    assert len(again["train_loss"]) == 1 and again["state"].step == 12
    opt_steps = {float(s["step"]) for s in again["state"].optimizer.state_dict()["state"].values()}
    assert opt_steps == {12.0}
    assert [r["epoch"] for r in _csv(ck / "metrics.csv")] == ["1", "2", "3"]

    # load_model: start from a named checkpoint in a fresh directory.
    cfgs2 = _configs(data, tmp_path / "ck2")
    cfgs2[3]["load_model"] = str(tmp_path / "epoch2.pth")
    third = tloop.fit(*cfgs2, device="cpu", progress=False, num_epochs=3)
    assert len(third["train_loss"]) == 1 and third["state"].step == 12
    assert [r["epoch"] for r in _csv(tmp_path / "ck2" / "metrics.csv")] == ["3"]


def test_fit_device_warp_and_async_saves(data, tmp_path):
    cfgs = _configs(data, tmp_path, device_warp=True, async_checkpoint=True, save_freq=5)
    cfgs[0].update(val_images_dir="", val_annotation_json="")
    history = tloop.fit(*cfgs, device="cpu", progress=False, num_epochs=1)
    assert np.isfinite(history["train_loss"][0]) and history["val_loss"] == []
    assert history["state"].step == 4 and history["pckh_seconds"] == []
    assert sorted(os.listdir(tmp_path)) == ["final_model.pth"] + ["loss_plot.png"] * PLOTS + [
        "metrics.csv"]


def test_fit_refusals(data, tmp_path, monkeypatch):
    """An incomplete launch (two processes asked for, no rank or address)
    and a data axis in one process raise before anything is written; a
    model axis across ranks and dp * tp != world are held by
    test_torch_dist_fit.py, where two processes run."""
    cfgs = _configs(data, tmp_path)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="incomplete torchrun launch"):
        tloop.fit(*cfgs, device="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        tloop.fit(*cfgs, device="cpu")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="incomplete JAX launch"):
        tloop.fit(*cfgs, device="cpu")
    monkeypatch.delenv("JAX_NUM_PROCESSES")
    with dispatch.scoped():
        with pytest.raises(ValueError, match="dp must be 1"):
            tloop.fit(*cfgs, device="cpu", mesh=MeshSpec(2, 1))
        assert dispatch.target_mesh() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.fit(*cfgs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--num_epochs", "1"])
    assert not os.listdir(tmp_path)


def test_cli_hands_the_parsed_config_to_fit(data, tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(tloop, "fit", lambda *a, **k: calls.append((a, k)) or {"ok": 1})
    path = tmp_path / "my_config.py"
    path.write_text(
        "def get_default_configs():\n"
        "    return ({'train_images_dir': 't'}, {'num_epochs': 9}, {'is_flipping': False},\n"
        "            {'model_name': 'test/vit-tiny'})\n")
    assert tcli.main(["--config_file", str(path), "--num_epochs", "5", "--no_pth_export"]) == {"ok": 1}
    assert calls[-1] == (load_config_file(str(path)), {"export_pth": False, "num_epochs": 5})
    tcli.main([])
    assert calls[-1] == (load_config_file(tcli.DEFAULT_CONFIG_FILE),
                         {"export_pth": True, "num_epochs": None})
    # The port's default file holds the repository default's values.
    assert calls[-1][0] == jax_load_config_file(os.path.join(ROOT, "config", "config.py"))
    with pytest.raises(FileNotFoundError):
        tcli.main(["--config_file", str(tmp_path / "missing.py")])


def test_default_config_file_imports_no_jax_package():
    code = (
        "import sys\n"
        "from dino_pose_tpu_torch.cli.train import DEFAULT_CONFIG_FILE\n"
        "from dino_pose_tpu_torch.config import load_config_file\n"
        "cfg = load_config_file(DEFAULT_CONFIG_FILE)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('dino_pose_tpu', 'flax', 'optax')]\n"
        "assert not bad, bad\n"
        "print(cfg[1]['checkpoint_dir'])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "checkpoints/dinov2_hg_skip"


def test_profiling_utilities(tmp_path):
    timer = profiling.StepTimer()
    for _ in timer.iter(range(3)):
        with timer.step():
            pass
    timer.drain("cpu")
    s = timer.summary()
    assert s["steps"] == 3 and set(s) == {"steps", "input_wait_s", "dispatch_s", "drain_s",
                                          "input_bound"}
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    try:
        profiling.enable_nan_checks()
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
