"""``fit`` across two gloo processes against ``fit`` in one, on the CPU.

test/vit-tiny + LoRA with the default config's dropout on, a global batch
of 8: each epoch trains on one global batch of the 8 training images and
validates on 6 (each rank holds 3 of them, padded to its local batch of 4),
so that the ranks' shards make up the one process's batches and the loss
trajectories agree to JAX's ``test_multiprocess.py`` tolerance (rtol 2e-4):
the dropout masks are the ranks' rows of the global batch's. The PCKh
evaluation splits the 6 validation images 3 + 3; on the same weights (the
baseline) it equals the one process's to 1e-5. Only the primary writes.
Auto-resume on a filesystem the ranks do not share (the other rank acts as
if the checkpoint were absent) leaves both ranks bit-identical and
continues as one process resumed from the same file does (losses to rtol
2e-4, parameters within 2*lr); a checkpoint whose structure differs from
the run's config raises on both ranks before anything is broadcast.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from dino_pose_tpu_torch.config import get_default_configs
from dino_pose_tpu_torch.train import evaluate as tevaluate
from dino_pose_tpu_torch.train import loop as tloop
from test_torch_data import write_coco
from test_torch_distributed import load_npz, run_ranks

GLOBAL_BS = 8


def _configs(data, checkpoint_dir="", **model):
    (ti, ta), (vi, va) = data
    d, t, p, m = get_default_configs()
    d.update(train_images_dir=str(ti), train_annotation_json=str(ta),
             val_images_dir=str(vi), val_annotation_json=str(va))
    t.update(batch_size=GLOBAL_BS, num_epochs=2, save_freq=1, checkpoint_dir=str(checkpoint_dir),
             multiprocessing_num=2, learning_rate=1e-3)
    m.update(model_name="test/vit-tiny", **model)
    return d, t, p, m


def _fit_ranks(tmp, data, dirs, **job):
    """fit on two ranks into ``dirs``; returns (logs, histories, states)."""
    logs = run_ranks(tmp, [{"name": "fit", "configs": list(_configs(data)),
                            "checkpoint_dirs": [str(d) for d in dirs], **job}])
    out = tmp / "out"
    return ([log for _, log in logs],
            [json.loads((out / f"fit_{r}.json").read_text()) for r in range(2)],
            [load_npz(out / f"fit_state_{r}.npz") for r in range(2)])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_fit")
    return write_coco(root / "train", GLOBAL_BS, seed=50), write_coco(root / "val", 6, seed=51)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_fit_runs")
    one = tloop.fit(*_configs(data, tmp / "ck_one"), device="cpu", progress=False)
    one_info = dict(tevaluate.last_eval_info)
    dirs = [tmp / "ck_0", tmp / "ck_1"]
    logs, two, states = _fit_ranks(tmp / "two", data, dirs)
    files = [sorted(os.listdir(d)) if d.exists() else [] for d in dirs]
    return tmp, one, one_info, logs, two, states, files


def test_two_rank_fit_matches_one_process(runs):
    _, one, _, _, two, _, _ = runs
    for h in two:
        assert h["step"] == one["state"].step == 2
        np.testing.assert_allclose(h["train_loss"], one["train_loss"], rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(h["val_loss"], one["val_loss"], rtol=2e-4, atol=1e-6)
    assert two[0]["train_loss"] == two[1]["train_loss"]


def test_pckh_is_split_over_the_ranks(runs):
    """3 images a rank; the baseline, on the same weights, equals the one
    process's to 1e-5. The two gated evaluations after training are the
    same on both ranks; they are not held to the one process's, whose
    weights differ by AdamW's first steps on gradients within roundoff of
    zero (up to 2*lr an element), enough to move a keypoint across the PCKh
    threshold."""
    _, one, one_info, _, two, _, _ = runs
    assert one_info == {"local_images": 6, "total_images": 6}
    for h in two:
        assert h["eval_info"] == {"local_images": 3, "total_images": 6}
        np.testing.assert_allclose(h["pckh"][0], one["pckh"][0], rtol=1e-5, atol=1e-7)
    assert two[0]["pckh"] == two[1]["pckh"] and len(two[0]["pckh"]) == len(one["pckh"]) == 3


def test_only_the_primary_writes(runs):
    _, _, _, _, _, states, (files0, files1) = runs
    assert files1 == []
    assert "final_model.pth" in files0 and "metrics.csv" in files0
    for k in states[0]:
        assert np.array_equal(states[0][k], states[1][k]), k


def test_auto_resume_across_unshared_filesystems(runs, data):
    """Rank 0 resumes from its final_model.pth; rank 1, which cannot see
    the file, builds a placeholder and receives the primary's state: one
    more epoch, both ranks bit-identical, as one process resumed from the
    same file."""
    tmp, _, _, _, _, _, _ = runs
    ck0 = tmp / "resume_0"
    shutil.copytree(tmp / "ck_0", ck0)
    shutil.copytree(tmp / "ck_0", tmp / "resume_one")
    one = tloop.fit(*_configs(data, tmp / "resume_one"), device="cpu", progress=False,
                    num_epochs=3)
    logs, two, states = _fit_ranks(tmp / "resume", data, [ck0, tmp / "resume_1"],
                                   pretend_no_ckpt=True, num_epochs=3)
    assert "Auto-resuming from latest checkpoint" in logs[0]
    assert "will receive resumed state from the primary" in logs[1]
    assert "will receive" not in logs[0]
    for h in two:
        assert len(h["train_loss"]) == 1 and h["step"] == one["state"].step == 3
        np.testing.assert_allclose(h["train_loss"], one["train_loss"], rtol=2e-4, atol=1e-6)
    for k in states[0]:
        assert np.array_equal(states[0][k], states[1][k]), k
    # One AdamW step from the same state: within 2*lr an element.
    one_sd = one["model"].state_dict()
    for k, v in states[0].items():
        if one_sd[k].is_floating_point():
            np.testing.assert_allclose(v, one_sd[k].numpy(), rtol=0, atol=2e-3, err_msg=k)


def test_resume_structure_guard(runs, data):
    """The checkpoint's LoRA rank (8) is not the run's (4): the primary
    restores the checkpoint's model, the placeholder follows the run's
    config, and both ranks raise before the broadcast."""
    tmp, _, _, _, _, _, _ = runs
    ck0 = tmp / "guard_0"
    ck0.mkdir()
    shutil.copy(tmp / "ck_0" / "final_model.pth", ck0)
    assert torch.load(ck0 / "final_model.pth", weights_only=False)["config_model"]["lora_rank"] == 8
    d, t, p, m = _configs(data, lora_rank=4)
    results = run_ranks(tmp / "guard", [{"name": "fit", "configs": [d, t, p, m],
                                         "checkpoint_dirs": [str(ck0), str(tmp / "guard_1")],
                                         "pretend_no_ckpt": True, "num_epochs": 3}],
                        expect_ok=False)
    for rc, log in results:
        assert rc != 0 and "the structure differs across processes" in log, log[-2000:]
    assert os.listdir(ck0) == ["final_model.pth"]
