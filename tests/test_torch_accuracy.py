"""The port's accuracy harnesses (``dino_pose_tpu_torch/scripts/``) against
the JAX scripts and the JAX package, on the CPU.

- ``make_dataset`` writes the same bytes as ``scripts/accuracy_trajectory.py``'s.
- The trajectory protocol (its preprocessing and training overrides, f32,
  no dropout: LoRA dropout 0 in the checkpoint's config, the z head's
  dropout patched out on both sides as the step tests do, since the two
  frameworks cannot share its RNG): JAX's ``fit`` on a one-device mesh and
  the port's ``fit``
  train ``test/vit-tiny`` + LoRA from one ``.pth`` written from JAX's
  variables for 3 epochs on 8 of those images at bs=4. The two loaders give
  the same batches in the same order (the port keeps JAX's RNG draws), so
  each epoch's losses, loss weight, learning rate and PCKh are held. The z
  losses and the loss weight to 1e-4 relative (measured below 2.5e-5); the
  keypoint losses, and the totals they enter, to 1e-4 in epoch 1's training
  (its second step is one AdamW step in, measured 1.9e-5) and to 5e-3 after
  it (measured up to 2.9e-3, epoch 3's validation): AdamW's first steps are about lr * sign(g), so a heatmap-head
  gradient element within roundoff of zero, below the ReLU gates that
  ``tests/test_torch_train.py`` holds to 1e-2, may step the other way; the
  PCKh to 1e-6 (the same keypoints on either side of every threshold).
- Both entry points end to end with ``--device cpu``; the parity report's
  ``reference`` metrics equal JAX's ``evaluate_checkpoint`` on the same
  ``.pth`` to 1e-6.
"""

import csv
import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from dino_pose_tpu.config import get_default_configs as jax_default_configs
from dino_pose_tpu.core.mesh import create_mesh as jax_create_mesh
from dino_pose_tpu.models import registry as jregistry
from dino_pose_tpu.nn import layers as jlayers
from dino_pose_tpu.train import loop as jloop
from dino_pose_tpu_torch.config import get_default_configs
from dino_pose_tpu_torch.io import checkpoint as tck
from dino_pose_tpu_torch.io.convert import state_dict_from_jax
from dino_pose_tpu_torch.models import registry as tregistry
from dino_pose_tpu_torch.nn import layers as tlayers
from dino_pose_tpu_torch.scripts import accuracy_trajectory as tacc
from dino_pose_tpu_torch.scripts import real_dataset_parity as tparity
from dino_pose_tpu_torch.train import loop as tloop
from scripts import accuracy_trajectory as jacc
from scripts import real_dataset_parity as jparity
from test_torch_model import _randomise
from test_torch_train import _NoDropout

CONFIG = {"model_name": "test/vit-tiny", "use_lora": True, "lora_dropout": 0.0}
# metrics.csv's columns held between the two loops: relative tolerance in
# epoch 1 and after it (the module docstring says why).
RTOL = {"train_z_loss": (1e-4, 1e-4), "val_z_loss": (1e-4, 1e-4), "weight": (1e-4, 1e-4),
        "train_loss": (1e-4, 5e-3), "train_kp_loss": (1e-4, 5e-3),
        "val_loss": (5e-3, 5e-3), "val_kp_loss": (5e-3, 5e-3)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the models are tiny, and JAX's XLA threads and
    the other test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def start_pth(tmp_path_factory):
    """One ``.pth`` both loops start from: JAX's ``test/vit-tiny`` + LoRA
    variables (randomised, so LoRA B is not zero), written by the port."""
    jm = jregistry.create_model_from_config(dict(CONFIG), pretrained=False)
    variables = _randomise(jax.device_get(jm.variables), np.random.default_rng(0))
    tm = tregistry.create_model_from_config(dict(CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
    path = tmp_path_factory.mktemp("start") / "start.pth"
    tck.save_checkpoint(path, tm)
    return str(path)


@pytest.fixture(scope="module")
def data8(tmp_path_factory):
    root = tmp_path_factory.mktemp("acc8")
    tacc.make_dataset(str(root), 8)
    return str(root)


def test_make_dataset_writes_jax_scripts_bytes(tmp_path):
    tacc.make_dataset(str(tmp_path / "port"), 4, seed=0)
    jacc.make_dataset(str(tmp_path / "jax"), 4, seed=0)
    names = ["ann.json"] + [f"images/{i}.jpg" for i in range(4)]
    assert sorted(os.listdir(tmp_path / "port" / "images")) == sorted(
        os.listdir(tmp_path / "jax" / "images"))
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "port", tmp_path / "jax", names,
                                               shallow=False)
    assert match == names and not mismatch and not errors


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_fit_matches_jax_on_the_trajectory_protocol(start_pth, data8, tmp_path, monkeypatch):
    monkeypatch.setattr(jlayers, "Dropout", _NoDropout)
    monkeypatch.setattr(tlayers, "dropout", lambda x, rate, generator: x)
    port_cfgs = tacc.trajectory_configs(data8, str(tmp_path / "port"), model="test/vit-tiny",
                                        epochs=3, batch_size=4, lr=1e-3, save_freq=3)
    port_cfgs[3]["load_model"] = start_pth
    # JAX's side: its own defaults with the same updates.
    jax_cfgs = jax_default_configs()
    assert jax_cfgs == get_default_configs()
    for mine, theirs in zip(jax_cfgs, port_cfgs):
        mine.update(theirs)
    jax_cfgs[1]["checkpoint_dir"] = str(tmp_path / "jax")

    history = tloop.fit(*port_cfgs, device="cpu", progress=False, export_pth=False)
    one_device = jax_create_mesh(devices=jax.devices()[:1])
    jhistory = jloop.fit(*jax_cfgs, mesh=one_device, progress=False, export_pth=False)

    got, want = _rows(tmp_path / "port" / "metrics.csv"), _rows(tmp_path / "jax" / "metrics.csv")
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == ["1", "2", "3"]
    for g, w in zip(got, want):
        for k, (first, later) in RTOL.items():
            rel = first if g["epoch"] == "1" else later
            assert float(g[k]) == pytest.approx(float(w[k]), rel=rel), (g["epoch"], k)
        assert float(g["lr"]) == float(w["lr"]) == 1e-3  # min_lr = lr holds it
        for k in ("pckh_2d", "pckh_3d"):  # evaluated at epoch 3 (save_freq)
            assert (g[k] == "") == (w[k] == "") == (g["epoch"] != "3"), (g["epoch"], k)
            if g[k]:
                assert float(g[k]) == pytest.approx(float(w[k]), abs=1e-6), k
    np.testing.assert_allclose(history["train_loss"], jhistory["train_loss"], rtol=5e-3)
    np.testing.assert_allclose(history["val_loss"], jhistory["val_loss"], rtol=5e-3)
    assert history["state"].step == 6
    assert len(history["pckh"]) == 2  # the baseline, then epoch 3


def test_accuracy_trajectory_main_on_the_cpu(tmp_path):
    out = tmp_path / "out"
    record = tacc.main(["--device", "cpu", "--model", "test/vit-tiny", "--epochs", "2",
                        "--n-images", "4", "--batch-size", "4", "--save-freq", "1",
                        "--out", str(out)])
    with open(out / "trajectory.json") as f:
        written = json.load(f)
    assert list(written) == ["final_metrics", "train_loss", "val_loss", "config",
                             "pckh_history"]
    assert set(written["final_metrics"]) >= {"pckh", "pckh_z", "pck_bbox"}
    assert len(written["train_loss"]) == len(written["val_loss"]) == 2
    assert all(np.isfinite(written["train_loss"] + written["val_loss"]))
    assert written["config"] == {"model": "test/vit-tiny", "lora": True, "epochs": 2,
                                 "batch_size": 4, "lr": 1e-3, "n_images": 4}
    assert [p["epoch"] for p in written["pckh_history"]] == [0, 1, 2]
    # The loop's last PCKh is the final pass's: same weights, same protocol.
    last = written["pckh_history"][-1]
    assert last["pckh_2d"] == pytest.approx(written["final_metrics"]["pckh"], abs=1e-6)
    assert last["pckh_3d"] == pytest.approx(written["final_metrics"]["pckh_z"], abs=1e-6)
    assert record["history"]["state"].step == 2
    rows = _rows(out / "ckpt" / "metrics.csv")
    assert [float(r["lr"]) for r in rows] == [1e-3, 1e-3]
    assert (out / "ckpt" / "final_model.pth").exists()


def test_accuracy_trajectory_main_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tacc.main(["--out", str(tmp_path), "--epochs", "1"])
    assert not (tmp_path / "data").exists()  # nothing written before the refusal
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tparity.main(["--synthetic-dry-run", "--eval-only", "--reference-checkpoint", "x.pth",
                      "--out-dir", str(tmp_path / "parity")])
    assert not (tmp_path / "parity").exists()


def test_real_dataset_parity_dry_run_matches_jax_reference(start_pth, tmp_path):
    out = tmp_path / "parity"
    report = tparity.main(["--device", "cpu", "--synthetic-dry-run", "--model", "test/vit-tiny",
                           "--batch-size", "8", "--num-workers", "2",
                           "--reference-checkpoint", start_pth, "--out-dir", str(out)])
    for name in ("parity_report.json", "parity_report.md"):
        assert (out / name).exists()
    with open(out / "parity_report.json") as f:
        assert json.load(f) == report
    assert list(report) == ["dataset", "train", "framework", "reference", "delta"]
    assert report["train"]["epochs"] == 2
    images, ann = str(out / "data" / "images"), str(out / "data" / "ann.json")
    assert report["dataset"] == {"val_images": images, "val_ann": ann}
    want = jparity.evaluate_checkpoint(start_pth, images, ann, batch_size=8)
    assert report["reference"] == pytest.approx(want, abs=1e-6)
    assert set(report["delta"]) == set(report["framework"]) == set(want)
    md = (out / "parity_report.md").read_text()
    assert "| metric | framework | reference | delta |" in md and "Trained 2 epochs" in md


def test_real_dataset_parity_refuses_msgpack(tmp_path):
    with pytest.raises(ValueError, match=".msgpack"):
        tparity.main(["--device", "cpu", "--synthetic-dry-run", "--eval-only",
                      "--checkpoint", str(tmp_path / "model.msgpack"),
                      "--out-dir", str(tmp_path / "parity")])
