"""The port's ``.pth`` checkpoints against the JAX package's, on the CPU.

``test/vit-tiny`` + LoRA with its LoRA B, BatchNorm statistics and
LayerScales randomised (``test_torch_model._randomise``), so that no path is
an identity. A file written by either side loads in the other with no
missing or unexpected key; the forwards agree to 1e-4 abs (f32, the model
parity tolerance of ``test_torch_model.py``). Everything the port writes and
reads back itself — weights, AdamW state, step, loss-weight and scheduler
state, the async writer's snapshot — is held bit-equal.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_pose_tpu.io import checkpoint as jck
from dino_pose_tpu.models import registry as jregistry
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu.train import schedule as jschedule
from dino_pose_tpu_torch.io import checkpoint as tck
from dino_pose_tpu_torch.io.convert import state_dict_from_jax
from dino_pose_tpu_torch.models import registry as tregistry
from dino_pose_tpu_torch.train import schedule as tschedule
from dino_pose_tpu_torch.train.state import create_train_state
from dino_pose_tpu_torch.train.step import make_train_step, prepare_batch
from test_torch_model import _randomise

CONFIG = {"model_name": "test/vit-tiny", "use_lora": True}
TRAINING = {"batch_size": 2, "learning_rate": 1e-3, "checkpoint_dir": "ck"}
PREPROC = {"is_rotate": True}
FWD_ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_model():
    jm = jregistry.create_model_from_config(dict(CONFIG), pretrained=False)
    jm.variables = _randomise(jax.device_get(jm.variables), np.random.default_rng(0))
    return jm


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(1).standard_normal((2, 3, 224, 224)).astype(np.float32)


def _jax_forward(jm, pixels):
    with jdispatch.local():
        hm, z = jm.module.apply(jm.variables, jnp.asarray(pixels), train=False)
    return np.asarray(hm), np.asarray(z)


def _forward(model, pixels):
    model.eval()
    with torch.inference_mode():
        hm, z = model(torch.from_numpy(pixels))
    return hm.numpy(), z.numpy()


def _port_model(jm):
    tm = tregistry.create_model_from_config(dict(CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jm.variables, tm), strict=True)
    return tm


def _batch(seed: int, b: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    kps = rng.uniform(10, 214, (b, 24, 3)).astype(np.float32)
    kps[..., 2] = rng.choice([0.0, 1.0, 2.0], (b, 24))
    return {"image": torch.from_numpy(rng.standard_normal((b, 3, 224, 224)).astype(np.float32)),
            "2d_keypoints": torch.from_numpy(kps),
            "z_coords": torch.from_numpy(rng.standard_normal((b, 24)).astype(np.float32))}


def _trained(tm, steps: int = 2):
    """``tm``'s train state after ``steps`` steps (AdamW moments non-zero)."""
    state, optimizer, partition = create_train_state(tm, CONFIG)
    step = prepare_batch(make_train_step(tm, optimizer, partition), (224, 48))
    for i in range(steps):
        state, _ = step(state, _batch(i), 1e-3, 0)
    return state, step


def _assert_nested_equal(a, b, where=""):
    if isinstance(b, torch.Tensor):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(b, dict):
        assert set(a) == set(b), where
        for k in b:
            _assert_nested_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_nested_equal(x, y, f"{where}/{i}")
    else:
        assert a == b or (a != a and b != b), where


def test_jax_pth_loads_in_the_port(jax_model, pixels, tmp_path, capsys):
    path = str(tmp_path / "jax.pth")
    jck.save_checkpoint(path, jax_model, epoch=3, train_loss=1.5, valid_loss=0.25,
                        config_training=TRAINING, config_preproc=PREPROC,
                        scheduler=jschedule.PlateauState(lr=2e-4, num_bad_epochs=2))
    ckpt = tck.load_checkpoint(path)
    fresh = tregistry.create_model_from_config(dict(CONFIG), device="cpu")
    fresh.load_state_dict(ckpt["model_state_dict"], strict=True)  # every key, both ways
    assert all(v.dtype == torch.float32 for k, v in ckpt["model_state_dict"].items()
               if not k.endswith("num_batches_tracked"))
    capsys.readouterr()
    tm = tck.load_model_smart(path, device="cpu")
    assert "Warning" not in capsys.readouterr().out
    assert not tm.training and tm.model_name == "test/vit-tiny"
    for got, want in zip(_forward(tm, pixels), _jax_forward(jax_model, pixels)):
        np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)
    assert tck.get_model_info(path) == jck.get_model_info(path)

    # A JAX-written file resumes weights, epoch, loss weight and scheduler;
    # its optimizer dict is empty, so AdamW starts fresh.
    state, optimizer, _ = create_train_state(tm, tm.config_model)
    sched = tschedule.PlateauState(lr=1e-3)
    state, sched, epoch = tck.restore_train_state(ckpt, state, sched)
    assert epoch == 3 and state.step == 0 and not optimizer.state
    assert sched == tschedule.PlateauState(lr=2e-4, num_bad_epochs=2)


def test_port_pth_loads_in_jax(jax_model, pixels, tmp_path, capsys):
    tm = _port_model(jax_model)
    state, _ = _trained(tm)
    path = str(tmp_path / "port.pth")
    tck.save_checkpoint(path, tm, state=state, epoch=2, train_loss=0.5, valid_loss=0.125,
                        config_training=TRAINING, config_preproc=PREPROC,
                        scheduler=tschedule.PlateauState(lr=3e-4))
    ckpt = tck.load_checkpoint(path)
    rules = {r.torch_key for r in jck.rules_for_model(jax_model)}
    keys = set(ckpt["model_state_dict"])
    assert {k for k in keys if not k.endswith("num_batches_tracked")} == rules
    assert ckpt["optimizer_state_dict"]["state"] and ckpt["step"] == 2
    capsys.readouterr()
    jm = jck.load_model_smart(path)
    out = capsys.readouterr().out
    assert "Warning" not in out and "Loaded weights from epoch 2" in out
    for got, want in zip(_forward(tm, pixels), _jax_forward(jm, pixels)):
        np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)
    assert tck.get_model_info(path) == jck.get_model_info(path)
    info = tck.get_model_info(path)
    assert info["class_name"] == "Dinov2PoseModelLoRA" and info["family"] == "dinov2"
    assert info["epoch"] == 2 and info["loss_weight"] == float(state.loss_weight.best_weight)


def test_latest_checkpoint_and_refusals(tmp_path):
    assert tck.latest_checkpoint(tmp_path / "missing") is None
    assert tck.latest_checkpoint(tmp_path) is None
    for i, name in enumerate(["a.pth", "b.pth", "c.msgpack", "d.pth.tmp"]):
        (tmp_path / name).write_bytes(b"")
        t = 1_000_000 + (100 if name == "c.msgpack" else 10 * i)
        os.utime(tmp_path / name, (t, t))
    assert tck.latest_checkpoint(tmp_path) == str(tmp_path / "b.pth")
    with pytest.raises(ValueError, match=".pth"):
        tck.load_checkpoint(tmp_path / "c.msgpack")
    with pytest.raises(ValueError, match="Invalid checkpoint path"):
        tck.get_model_info(str(tmp_path / "c.msgpack"))
    with pytest.raises(ValueError, match="Invalid model path"):
        tck.load_model_smart("not/a-model", device="cpu")
    model = tck.load_model_smart("dinov2", device="cpu")
    assert model.model_name == "facebook/dinov2-small"
    with pytest.raises(ValueError, match=".pth"):
        tck.save_checkpoint(tmp_path / "x.msgpack", model)


def test_load_model_smart_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tck.load_model_smart("test/vit-tiny")


def test_async_writer_snapshots_before_it_returns(jax_model, tmp_path):
    """The write is held back until a further optimizer step has changed the
    parameters and moments in place; the file equals a synchronous save
    made before that step."""
    tm = _port_model(jax_model)
    state, step = _trained(tm, steps=1)
    sched = tschedule.PlateauState(lr=1e-3)
    tck.save_checkpoint(tmp_path / "sync.pth", tm, state=state, epoch=1, scheduler=sched)
    writer = tck.AsyncCheckpointWriter()
    gate = threading.Event()
    # Untimed: the write may land only after the gate opens, however slow the
    # step below runs; the finally opens it should an assertion fail first.
    writer.submit(gate.wait)
    try:
        tck.save_checkpoint(tmp_path / "async.pth", tm, state=state, epoch=1,
                            scheduler=sched, async_writer=writer)
        before = {k: v.clone() for k, v in tm.state_dict().items()}
        state, _ = step(state, _batch(5), 1e-3, 0)
        assert any(not torch.equal(before[k], v) for k, v in tm.state_dict().items())
        assert not (tmp_path / "async.pth").exists()
    finally:
        gate.set()
    writer.wait()
    _assert_nested_equal(tck.load_checkpoint(tmp_path / "async.pth"),
                         tck.load_checkpoint(tmp_path / "sync.pth"))

    def fail():
        raise OSError("disk full")

    writer.submit(fail)
    with pytest.raises(OSError, match="disk full"):
        writer.wait()


def test_resume_restores_the_train_state_exactly(jax_model, tmp_path):
    tm = _port_model(jax_model)
    state, step = _trained(tm, steps=2)
    state.loss_weight = type(state.loss_weight)(
        **{**vars(state.loss_weight), "best_val_loss": torch.tensor(0.75)})
    sched = tschedule.plateau_step(tschedule.PlateauState(lr=1e-3), 0.5)
    path = str(tmp_path / "resume.pth")
    tck.save_checkpoint(path, tm, state=state, epoch=4, scheduler=sched)

    ckpt = tck.load_checkpoint(path)
    tm2 = tck.load_model_smart(path, eval_mode=False, ckpt=ckpt, device="cpu")
    assert tm2.training
    state2, optimizer2, partition2 = create_train_state(tm2, tm2.config_model)
    state2, sched2, epoch = tck.restore_train_state(ckpt, state2, tschedule.PlateauState(lr=1.0))
    assert epoch == 4 and state2.step == 2 and sched2 == sched
    _assert_nested_equal(optimizer2.state_dict(), state.optimizer.state_dict())
    _assert_nested_equal(vars(state2.loss_weight), vars(state.loss_weight))
    _assert_nested_equal(tm2.state_dict(), tm.state_dict())

    # The next step is the same step on both.
    step2 = prepare_batch(make_train_step(tm2, optimizer2, partition2), (224, 48))
    state, stats = step(state, _batch(9), 1e-3, 0)
    state2, stats2 = step2(state2, _batch(9), 1e-3, 0)
    _assert_nested_equal(stats2, stats)
    _assert_nested_equal(tm2.state_dict(), tm.state_dict())


def test_fastvit_fold_cache_is_rebuilt_after_a_load(tmp_path):
    """The eval forward's folded-conv cache (``models/fastvit_fold``) gives
    the loaded weights' outputs, not the cached ones."""
    config = {"model_name": "test/fastvit-tiny", "use_lora": True}
    a = tregistry.create_model_from_config(dict(config), seed=0, device="cpu")
    b = tregistry.create_model_from_config(dict(config), seed=1, device="cpu")
    with torch.no_grad():
        for m in b.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    x = np.random.default_rng(2).standard_normal((2, 3, 128, 128)).astype(np.float32)
    old = _forward(a, x)
    assert any(hasattr(m, "_fold_cache") for m in a.modules())
    tck.save_checkpoint(tmp_path / "b.pth", b)
    state_dict = tck.load_checkpoint(tmp_path / "b.pth")["model_state_dict"]
    missing, unexpected = tck.load_weights(a, state_dict)
    assert not missing and not unexpected
    got, want = _forward(a, x), _forward(b, x)
    assert not np.array_equal(got[0], old[0])
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
