"""Pretrained DINOv2 weights from the local hub cache, port against JAX, on the CPU.

Nothing is downloaded: each test writes its own cache under ``tmp_path`` in
the hub's layout (``models--facebook--dinov2-small/refs/main`` naming a
snapshot whose files link to ``blobs/``), from a narrow seeded
``transformers.Dinov2Model`` (D = 64, 3 layers, 2 heads) saved with
``save_pretrained``. ``facebook/dinov2-small``'s preset is narrowed to that
shape in both packages (``monkeypatch.setitem`` on both ``VIT_PRESETS``),
so the registry takes its real, non-``test/`` path.

- ``io/hf_cache`` reads back, bit for bit, what ``save_pretrained`` wrote:
  ``model.safetensors``, its sharded index, ``pytorch_model.bin``, a bf16
  file (cast to f32) and keys under the ``dinov2.`` base-model prefix.
- ``create_model_from_config(..., pretrained=True)`` equals JAX's, bit for
  bit, on every backbone tensor (through ``io/convert.state_dict_from_jax``),
  with LoRA (``original_attention`` names) and unfreeze-last-2; the heads
  and LoRA A/B keep the seeded values.
- An empty cache, or one whose weights cannot be read, warns in JAX's
  words and keeps the seeded weights; a
  ``test/`` name reads no cache; FastViT warns in JAX's words; a cached
  config of another shape raises ``ValueError``.
- Each caller passes JAX's flag: ``load_model_smart`` on a ``.pth`` False, on
  a registry or family name True, a fresh ``fit`` True, the placeholder of a
  rank that cannot see the resumed file False.
"""

import hashlib
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from dino_pose_tpu.models import registry as jregistry
from dino_pose_tpu.models import vit as jvit
from dino_pose_tpu_torch.config import get_default_configs
from dino_pose_tpu_torch.io import checkpoint as tck
from dino_pose_tpu_torch.io import hf_cache
from dino_pose_tpu_torch.io.convert import state_dict_from_jax
from dino_pose_tpu_torch.models import registry as tregistry
from dino_pose_tpu_torch.models import vit as tvit
from dino_pose_tpu_torch.train import loop as tloop
from test_torch_data import write_coco

transformers = pytest.importorskip("transformers")

NAME = "facebook/dinov2-small"
COMMIT = "0123456789abcdef0123456789abcdef01234567"
NARROW = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 2,
          "patch_size": 14, "image_size": 518}
UNAVAILABLE = ("Pre-trained weights for {} unavailable (OSError); initialising backbone "
               "randomly. Provide a checkpoint via config_model['load_model'] for real training.")
TIMM = ("Pre-trained timm weights for {} are not available in this environment; initialising "
        "the FastViT backbone randomly. Provide a checkpoint via config_model['load_model'] for "
        "real training.")


@pytest.fixture
def narrow(monkeypatch, tmp_path):
    """Both packages' dinov2-small preset at the narrow shape, and the hub
    cache (for the port and for transformers, which read its root at
    import) pointed at an empty folder under ``tmp_path``."""
    for presets, config in ((jvit.VIT_PRESETS, jvit.ViTConfig), (tvit.VIT_PRESETS, tvit.ViTConfig)):
        monkeypatch.setitem(presets, NAME, config(hidden_size=64, num_layers=3, num_heads=2,
                                                  pos_grid=37))
    cache = tmp_path / "hub"
    cache.mkdir()
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setattr(transformers.utils.hub, "TRANSFORMERS_CACHE", str(cache))
    return cache


def _hf_model(seed: int = 7, **config):
    """A narrow ``Dinov2Model`` whose every tensor is seeded noise (no
    LayerNorm or LayerScale left at its constant init)."""
    torch.manual_seed(seed)
    model = transformers.Dinov2Model(transformers.Dinov2Config(**{**NARROW, **config}))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    return model.eval()


def _write_cache(cache, model, **save_kw):
    """``save_pretrained`` into the hub layout: the snapshot's files are
    links to content-named blobs, ``refs/main`` names the snapshot."""
    repo = cache / ("models--" + NAME.replace("/", "--"))
    snapshot = repo / "snapshots" / COMMIT
    model.save_pretrained(snapshot, **save_kw)
    (repo / "blobs").mkdir(exist_ok=True)
    for f in sorted(snapshot.iterdir()):
        blob = repo / "blobs" / hashlib.sha256(f.read_bytes()).hexdigest()
        f.rename(blob)
        f.symlink_to(os.path.relpath(blob, snapshot))
    (repo / "refs").mkdir(exist_ok=True)
    (repo / "refs" / "main").write_text(COMMIT)
    return snapshot


@pytest.mark.parametrize("form", ["safetensors", "sharded", "bin", "bin_sharded", "bf16"])
def test_reader_returns_what_save_pretrained_wrote(narrow, form):
    model = _hf_model()
    if form == "bf16":
        model = model.to(torch.bfloat16)
    kw = {"safe_serialization": not form.startswith("bin")}
    if "sharded" in form:
        kw["max_shard_size"] = "40KB"
    snapshot = _write_cache(narrow, model, **kw)
    files = set(os.listdir(snapshot))
    stem = "pytorch_model.bin" if form.startswith("bin") else "model.safetensors"
    assert (stem + ".index.json" in files) == ("sharded" in form) and (stem in files) != (
        "sharded" in form), files
    got = hf_cache.load_dinov2(NAME, NARROW)
    want = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v.float()), k


def test_reader_strips_the_base_model_prefix(narrow):
    from safetensors.torch import save_file

    model = _hf_model()
    snapshot = _write_cache(narrow, model)
    state = {("dinov2." + k): v.contiguous() for k, v in model.state_dict().items()}
    state["classifier.weight"] = torch.ones(3, 128)
    (snapshot / "model.safetensors").unlink()
    save_file(state, str(snapshot / "model.safetensors"))
    got = hf_cache.load_dinov2(NAME, NARROW)
    assert got.keys() == set(model.state_dict()) | {"classifier.weight"}
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k


def test_cache_root_follows_the_hub(monkeypatch, tmp_path):
    for var in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE", "HF_HOME", "XDG_CACHE_HOME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert hf_cache.hub_cache_dir() == str(tmp_path / ".cache" / "huggingface" / "hub")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert hf_cache.hub_cache_dir() == str(tmp_path / "xdg" / "huggingface" / "hub")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    assert hf_cache.hub_cache_dir() == str(tmp_path / "hf" / "hub")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert hf_cache.hub_cache_dir() == str(tmp_path / "hub")


def _backbone(model) -> dict:
    return {k: v for k, v in model.state_dict().items() if k.startswith("backbone.")}


@pytest.mark.parametrize("config", [{"use_lora": True},
                                    {"use_lora": False, "unfreeze_last_n_layers": 2}],
                         ids=["lora", "unfreeze2"])
def test_pretrained_matches_jax_bit_for_bit(narrow, config):
    hf = _hf_model()
    _write_cache(narrow, hf)
    cfg = {"model_name": NAME, **config}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jm = jregistry.create_model_from_config(dict(cfg), pretrained=True)
        tm = tregistry.create_model_from_config(dict(cfg), device="cpu", pretrained=True)
    seeded = tregistry.create_model_from_config(dict(cfg), device="cpu", pretrained=False)
    want = state_dict_from_jax(jax.device_get(jm.variables), tm)
    got, hf_sd = tm.state_dict(), hf.state_dict()
    lora = "attention.original_attention." if config["use_lora"] else "attention."
    for k, v in _backbone(tm).items():
        if "lora_output" in k:
            # LoRA keeps its seeded init, B = 0 (JAX draws its own A).
            assert torch.equal(v, seeded.state_dict()[k]), k
            continue
        assert torch.equal(v, want[k]), k
        plain = k[len("backbone."):].replace("layer.2." + lora, "layer.2.attention.")
        assert torch.equal(v, hf_sd[plain]), k
    assert not tm.backbone.encoder.layer[2].use_lora or (
        tm.backbone.encoder.layer[2].attention.lora_output.lora_B == 0).all()
    for k, v in got.items():
        if not k.startswith("backbone."):
            assert torch.equal(v, seeded.state_dict()[k]), k
    assert [n for n, p in tm.named_parameters() if p.requires_grad] == \
        [n for n, p in seeded.named_parameters() if p.requires_grad]


def test_empty_cache_warns_in_jax_words(narrow):
    cfg = {"model_name": NAME, "use_lora": True}
    with pytest.warns(UserWarning) as jw:
        jregistry.create_model_from_config(dict(cfg), pretrained=True)
    with pytest.warns(UserWarning) as tw:
        tm = tregistry.create_model_from_config(dict(cfg), device="cpu")
    jtext = [str(w.message) for w in jw if "unavailable" in str(w.message)]
    ttext = [str(w.message) for w in tw]
    assert ttext == jtext == [UNAVAILABLE.format(NAME)]
    seeded = tregistry.create_model_from_config(dict(cfg), device="cpu", pretrained=False)
    for k, v in seeded.state_dict().items():
        assert torch.equal(tm.state_dict()[k], v), k


@pytest.mark.parametrize("damage", ["truncated", "header", "no_weights", "bin"])
def test_unreadable_cache_warns_and_keeps_the_seed(narrow, damage):
    """A cache entry whose weights cannot be read counts as absent: JAX's
    warning, the seeded weights."""
    snapshot = _write_cache(narrow, _hf_model(), safe_serialization=damage != "bin")
    weights = snapshot / ("pytorch_model.bin" if damage == "bin" else "model.safetensors")
    data = weights.read_bytes()
    weights.unlink()
    if damage == "truncated":
        weights.write_bytes(data[:4])
    elif damage == "header":
        weights.write_bytes((16).to_bytes(8, "little") + b"{not json at all" + data[24:])
    elif damage == "bin":
        weights.write_bytes(data[: len(data) // 2])
    cfg = {"model_name": NAME, "use_lora": True}
    with pytest.warns(UserWarning) as w:
        tm = tregistry.create_model_from_config(dict(cfg), device="cpu")
    assert [str(x.message) for x in w] == [UNAVAILABLE.format(NAME)]
    seeded = tregistry.create_model_from_config(dict(cfg), device="cpu", pretrained=False)
    for k, v in seeded.state_dict().items():
        assert torch.equal(tm.state_dict()[k], v), k


def test_pretrained_false_and_test_names_read_no_cache(narrow, monkeypatch):
    _write_cache(narrow, _hf_model())
    cfg = {"model_name": NAME, "use_lora": True}
    with_cache = tregistry.create_model_from_config(dict(cfg), device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("the cache was read")

    monkeypatch.setattr(hf_cache, "load_dinov2", refuse)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        seeded = tregistry.create_model_from_config(dict(cfg), device="cpu", pretrained=False)
        tregistry.create_model_from_config({"model_name": "test/vit-tiny"}, device="cpu")
        tregistry.create_model_from_config({"model_name": "test/fastvit-tiny"}, device="cpu")
    assert not torch.equal(with_cache.state_dict()["backbone.layernorm.weight"],
                           seeded.state_dict()["backbone.layernorm.weight"])


def test_fastvit_warns_in_jax_words():
    name = "timm/fastvit_t8.apple_in1k"
    with pytest.warns(UserWarning) as w:
        model = tregistry.create_model_from_config({"model_name": "fastvit"}, device="cpu")
    assert [str(x.message) for x in w] == [TIMM.format(name)]
    seeded = tregistry.create_model_from_config({"model_name": name}, device="cpu",
                                                pretrained=False)
    for k, v in seeded.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("field, value", [("hidden_size", 96), ("num_hidden_layers", 4),
                                          ("num_attention_heads", 4), ("patch_size", 16),
                                          ("image_size", 224)])
def test_mismatched_config_raises(narrow, field, value):
    snapshot = _write_cache(narrow, _hf_model())
    path = snapshot / "config.json"
    config = json.loads(path.read_text())
    config[field] = value
    path.unlink()
    path.write_text(json.dumps(config))
    with pytest.raises(ValueError, match=field):
        tregistry.create_model_from_config({"model_name": NAME}, device="cpu")


class _Stop(Exception):
    pass


@pytest.fixture
def recorded(monkeypatch):
    """``create_model_from_config`` recording the ``pretrained`` its caller
    passes (JAX's default True when it passes none); ``stop`` names model
    names after which the call raises ``_Stop`` instead of building."""
    calls, build = [], tregistry.create_model_from_config
    stop = set()

    def wrapper(config_model, **kw):
        calls.append(kw.get("pretrained", True))
        if config_model["model_name"] in stop or tregistry.resolve_model_name(
                config_model["model_name"]) in stop:
            raise _Stop
        return build(config_model, **kw)

    monkeypatch.setattr(tregistry, "create_model_from_config", wrapper)
    return calls, stop


def test_load_model_smart_passes_jax_flags(recorded, tmp_path):
    calls, stop = recorded
    model = tregistry.create_model_from_config({"model_name": "test/vit-tiny", "use_lora": True},
                                               device="cpu")
    path = tmp_path / "m.pth"
    tck.save_checkpoint(path, model)
    calls.clear()
    tck.load_model_smart(str(path), device="cpu")
    tck.load_model_smart("test/vit-tiny", device="cpu")
    stop.add(NAME)
    with pytest.raises(_Stop):
        tck.load_model_smart("dinov2", device="cpu")
    assert calls == [False, True, True]


def _fit_configs(tmp_path):
    d, t, p, m = get_default_configs()
    (ti, ta), (vi, va) = (write_coco(tmp_path / s, 2, seed=60 + i)
                          for i, s in enumerate(("train", "val")))
    d.update(train_images_dir=str(ti), train_annotation_json=str(ta),
             val_images_dir=str(vi), val_annotation_json=str(va))
    t.update(batch_size=2, num_epochs=1, checkpoint_dir=str(tmp_path / "ck"),
             multiprocessing_num=0)
    m.update(model_name="test/vit-tiny")
    return d, t, p, m


def test_fit_passes_jax_flags(recorded, tmp_path, monkeypatch):
    """A fresh ``fit`` builds with the default (True); a rank that cannot
    see the checkpoint the primary resumes builds its placeholder with
    False (two ranks simulated in one process up to that build)."""
    calls, stop = recorded
    stop.add("test/vit-tiny")
    configs = _fit_configs(tmp_path)
    with pytest.raises(_Stop):
        tloop.fit(*configs, device="cpu", progress=False)
    assert calls == [True]
    calls.clear()

    class TwoShards:
        data_size, tp = 2, 1

    monkeypatch.setattr(tloop.distributed, "world_size", lambda: 2)
    monkeypatch.setattr(tloop, "create_mesh", lambda mesh, device=None: TwoShards())
    monkeypatch.setattr(tloop, "create_dataloaders", lambda *a, **k: [])
    monkeypatch.setattr(tloop.ck, "latest_checkpoint",
                        lambda d: str(tmp_path / "elsewhere" / "final_model.pth"))
    with pytest.raises(_Stop):
        tloop._fit(*configs, dev=torch.device("cpu"), mesh=None, progress=False,
                   num_epochs=None)
    assert calls == [False]
