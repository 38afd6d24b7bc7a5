"""The port's five other CLIs and the registry's family surface against the
JAX package's, on the CPU.

``test/vit-tiny`` + LoRA with its LoRA B, BatchNorm statistics and
LayerScales randomised with numpy from a seed (``test_torch_model._randomise``)
and written as a ``.pth`` that both packages load. Printed text is compared
line for line; forwards and the heatmaps the demos draw from agree to 1e-4
abs (f32, the model parity tolerance of ``test_torch_model.py``); parameter
counts exactly. The departures: the port refuses ``.msgpack``, measures
``compare_models --device-time`` itself, and self-checks an export in the
device's compute dtype.
"""

import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from dino_pose_tpu.cli import demo as jdemo  # noqa: E402
from dino_pose_tpu.cli import export_coreml as jexport  # noqa: E402
from dino_pose_tpu.cli import model_info as jinfo  # noqa: E402
from dino_pose_tpu.io import checkpoint as jck  # noqa: E402
from dino_pose_tpu.models import registry as jregistry  # noqa: E402
from dino_pose_tpu.models.fastvit import FASTVIT_PRESETS as JFASTVIT  # noqa: E402
from dino_pose_tpu.models.fastvit_pose import FastVitPoseModule as JFastVitPose  # noqa: E402
from dino_pose_tpu.models.pose import DinoPoseModule as JDinoPose  # noqa: E402
from dino_pose_tpu.models.pose import PoseModel  # noqa: E402
from dino_pose_tpu.models.vit import VIT_PRESETS as JVIT  # noqa: E402
from dino_pose_tpu.ops import dispatch as jdispatch  # noqa: E402
from dino_pose_tpu_torch.cli import benchmark_model as tbench  # noqa: E402
from dino_pose_tpu_torch.cli import compare_models as tcompare  # noqa: E402
from dino_pose_tpu_torch.cli import demo as tdemo  # noqa: E402
from dino_pose_tpu_torch.cli import export_coreml as texport  # noqa: E402
from dino_pose_tpu_torch.cli import model_info as tinfo  # noqa: E402
from dino_pose_tpu_torch.io import checkpoint as tck  # noqa: E402
from dino_pose_tpu_torch.io.convert import state_dict_from_jax  # noqa: E402
from dino_pose_tpu_torch.models import registry as tregistry  # noqa: E402
from test_torch_model import _randomise  # noqa: E402

CONFIG = {"model_name": "test/vit-tiny", "use_lora": True}
FWD_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = jregistry.create_model_from_config(dict(CONFIG), pretrained=False)
    jm.variables = _randomise(jax.device_get(jm.variables), np.random.default_rng(0))
    tm = tregistry.create_model_from_config(dict(CONFIG), device="cpu")
    tm.load_state_dict(state_dict_from_jax(jm.variables, tm), strict=True)
    return jm, tm


@pytest.fixture(scope="module")
def ckpt_dir(models, tmp_path_factory):
    """The port's ``model.pth`` (epoch 5) and the JAX package's
    ``model.msgpack`` of the same weights."""
    jm, tm = models
    d = tmp_path_factory.mktemp("cli")
    with contextlib.redirect_stdout(io.StringIO()):
        tck.save_checkpoint(d / "model.pth", tm, epoch=5, train_loss=0.3, valid_loss=0.4,
                            config_training={"batch_size": 2}, loss_weight=0.25)
        jck.save_checkpoint(d / "model.msgpack", jm, epoch=5, train_loss=0.3, valid_loss=0.4)
    return d


@pytest.fixture(scope="module")
def image_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("img") / "person.jpg"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (300, 400, 3), dtype=np.uint8)
                    ).save(p)
    return str(p)


def _stdout(fn, *args, **kwargs) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kwargs)
    return out.getvalue()


def _jax_forward(jm, pixels):
    with jdispatch.local():
        hm, z = jm.module.apply(jm.variables, jnp.asarray(pixels), train=False)
    return np.asarray(hm), np.asarray(z)


def _forward(tm, pixels):
    with torch.inference_mode():
        hm, z = tm.eval()(torch.from_numpy(pixels))
    return hm.numpy(), z.numpy()


# ---------------------------------------------------------------------------
# The registry's family surface and the parameter counts
# ---------------------------------------------------------------------------

def _entries(entries: dict) -> dict:
    return {k: dataclasses.asdict(v) for k, v in entries.items()}


def _families(reg) -> dict:
    return {f: {**d, "models": list(d["models"])} for f, d in reg.list_families().items()}


def test_registry_family_surface_matches_jax(monkeypatch):
    assert tregistry.FAMILY_INFO == jregistry.FAMILY_INFO
    assert tregistry.FAMILY_DEFAULTS == jregistry.FAMILY_DEFAULTS
    assert _families(tregistry) == _families(jregistry)
    assert _entries(tregistry.list_supported_backbones()) == \
        _entries(jregistry.list_supported_backbones())
    for family in (*jregistry.FAMILY_DEFAULTS, "nope"):
        assert _entries(tregistry.get_family_models(family)) == \
            _entries(jregistry.get_family_models(family))

    # A family registered at run time, on both sides; the tables are restored.
    for reg in (tregistry, jregistry):
        monkeypatch.setattr(reg, "BACKBONE_REGISTRY", dict(reg.BACKBONE_REGISTRY))
        monkeypatch.setattr(reg, "FAMILY_DEFAULTS", dict(reg.FAMILY_DEFAULTS))
        reg.register_backbone("acme/pose-net", "acme", {"num_keypoints": 17}, "v1")
        reg.register_family_default("acme", "acme/pose-net")
        assert reg.resolve_model_name("acme") == "acme/pose-net"
    assert _families(tregistry) == _families(jregistry)
    assert _families(tregistry)["acme"] == {"info": {}, "default": "acme/pose-net",
                                             "models": ["acme/pose-net"]}
    assert _stdout(tinfo.main, ["--backbones"]) == _stdout(jinfo.main, ["--backbones"])
    assert "(custom)" in _stdout(tinfo.main, ["--backbones"])
    assert _stdout(tinfo.main, ["--families"]) == _stdout(jinfo.main, ["--families"])


COUNT_CONFIGS = [
    {"model_name": "facebook/dinov2-small", "use_lora": True},
    {"model_name": "facebook/dinov2-small", "use_lora": False, "unfreeze_last_n_layers": 4},
    {"model_name": "timm/fastvit_t8.apple_in1k", "use_lora": True},
]


def _jax_shapes_model(config: dict) -> PoseModel:
    """The JAX PoseModel of ``config`` with its variables as
    ``jax.eval_shape`` gives them (no init), built as the JAX registry
    builds it."""
    name = config["model_name"]
    entry = jregistry.BACKBONE_REGISTRY[name]
    merged = {**entry.default_config, **config}
    lora = merged["use_lora"]
    if entry.family == "dinov2":
        preset = JVIT[name]
        vit = dataclasses.replace(
            preset, lora_layers=(preset.num_layers - 1,) if lora else (),
            num_unfrozen_layers=0 if lora else merged["unfreeze_last_n_layers"])
        module, size = JDinoPose(vit=vit, num_keypoints=24, heatmap_size=48), 224
    else:
        cfg = dataclasses.replace(JFASTVIT[entry.variant], lora_rank=8 if lora else 0)
        module, size = JFastVitPose(cfg=cfg, num_keypoints=24, heatmap_size=48), 256
    shapes = jax.eval_shape(lambda k: module.init(k, jnp.zeros((1, 3, size, size))),
                            jax.random.key(0))
    return PoseModel(module=module, variables=shapes, model_name=name, family=entry.family,
                     config_model=merged, input_size=size)


@pytest.mark.parametrize("config", COUNT_CONFIGS,
                         ids=["dinov2-small-lora", "dinov2-small-unfreeze4", "fastvit_t8-lora"])
def test_count_parameters_match_jax(config):
    jm = _jax_shapes_model(config)
    tm = tregistry.create_model_from_config(dict(config), device="cpu", pretrained=False)
    for trainable_only in (True, False):
        assert tm.count_parameters(trainable_only) == jm.count_parameters(trainable_only)
    assert tm.count_parameters() < tm.count_parameters(trainable_only=False)

    def printed(fn):
        lines = _stdout(fn).splitlines()
        assert all(re.fullmatch(r"Trainable: \S+, Shape: \([\d, ]*\), Parameters: [\d,]+", ln)
                   for ln in lines)
        return len(lines), sum(int(ln.rsplit(" ", 1)[1].replace(",", "")) for ln in lines)

    assert printed(tm.print_trainable_parameters) == printed(jm.print_trainable_parameters)


# ---------------------------------------------------------------------------
# model_info
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--backbones"], ["--families"], ["-b"], ["-f"]])
def test_model_info_listings_match_jax(argv):
    assert _stdout(tinfo.main, argv) == _stdout(jinfo.main, argv)


def test_model_info_checkpoint_matches_jax(ckpt_dir):
    pth = str(ckpt_dir / "model.pth")
    got = _stdout(tinfo.main, ["--checkpoint", pth])
    assert got == _stdout(jinfo.main, ["--checkpoint", pth])
    assert "class_name: Dinov2PoseModelLoRA" in got and "epoch: 5" in got
    listing = ["--list-checkpoints", str(ckpt_dir)]
    got = _stdout(tinfo.main, listing)
    assert got == _stdout(jinfo.main, listing)
    assert "model.pth" in got and "model.msgpack" in got
    empty = ckpt_dir / "empty"
    empty.mkdir(exist_ok=True)
    assert _stdout(tinfo.main, ["-l", str(empty)]).endswith("(none found)\n")


def test_model_info_refuses_msgpack_and_missing_files(ckpt_dir, capsys):
    """The departure: JAX reads its flax ``.msgpack``; the port reports it
    cannot and exits 1, as for any unreadable checkpoint."""
    with pytest.raises(SystemExit) as exc:
        tinfo.main(["--checkpoint", str(ckpt_dir / "model.msgpack")])
    assert exc.value.code == 1
    assert capsys.readouterr().out.startswith("Could not read checkpoint: ")
    with pytest.raises(SystemExit) as exc:
        tinfo.main(["--checkpoint", str(ckpt_dir / "missing.pth")])
    assert exc.value.code == 1 and "Checkpoint file not found" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tinfo.main([])


# ---------------------------------------------------------------------------
# export_coreml
# ---------------------------------------------------------------------------

def _sd(**shapes) -> dict:
    return {k.replace("__", "."): np.zeros(s, np.float32) for k, s in shapes.items()}


DETECT_CASES = {
    "dinov2-small": _sd(backbone__embeddings__cls_token=(1, 1, 384)),
    "dinov2-base": _sd(backbone__embeddings__cls_token=(1, 1, 768),
                       backbone__encoder__layer__0__norm1__weight=(768,)),
    "dinov2-large": _sd(backbone__embeddings__cls_token=(1, 1, 1024)),
    "dinov2-unknown-width": _sd(backbone__embeddings__cls_token=(1, 1, 512)),
    "lora-flax-form": {**_sd(backbone__embeddings__cls_token=(1, 1, 768)),
                       "backbone.encoder.layer.11.attention.query.lora_A": np.zeros((768, 4))},
    "lora-torch-form": {**_sd(backbone__embeddings__cls_token=(1, 1, 1024)),
                        "backbone.encoder.layer.23.attention.query.lora_A.weight":
                            np.zeros((16, 1024))},
    "fastvit": _sd(backbone__stages__0__blocks__0__mlp__fc1__weight=(144, 48, 1, 1)),
    "fastvit-lora": _sd(backbone__patch_embed__0__weight=(48, 3, 3, 3),
                        backbone__stages__0__blocks__0__mlp__lora_A=(48, 8)),
    "unknown": _sd(encoder__weight=(4, 4)),
}


@pytest.mark.parametrize("case", list(DETECT_CASES))
def test_detect_model_family_matches_jax(case):
    sd = DETECT_CASES[case]
    assert texport.detect_model_family(sd) == jexport.detect_model_family(sd)


def test_detect_model_family_of_the_ports_state_dict(models):
    sd = models[1].state_dict()
    family, config = texport.detect_model_family(sd)
    assert (family, config) == jexport.detect_model_family({k: v.numpy() for k, v in sd.items()})
    assert family == "dinov2_lora" and config["lora_rank"] == 8


def test_export_both_ways(models, ckpt_dir, tmp_path):
    """The port's export loads in JAX's ``load_model_smart`` and JAX's in the
    port's; the forwards agree, and epoch, losses and loss weight ride
    across."""
    jm, tm = models
    pixels = np.random.default_rng(1).standard_normal((2, 3, 224, 224)).astype(np.float32)
    src = str(ckpt_dir / "model.pth")
    out = str(tmp_path / "port_export.pth")
    text = _stdout(texport.main, ["-c", src, "-o", out], device="cpu")
    assert "Self-check forward: heatmaps (1, 24, 48, 48), depths (1, 24)" in text
    with contextlib.redirect_stdout(io.StringIO()):
        jloaded = jck.load_model_smart(out)
    for got, want in zip(_jax_forward(jloaded, pixels), _forward(tm, pixels)):
        np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)
    info = jck.get_model_info(out)
    assert (info["epoch"], info["train_loss"], info["valid_loss"], info["loss_weight"]) == \
        (5, 0.3, 0.4, 0.25)
    assert tck.load_checkpoint(out)["config_training"] == {"batch_size": 2}

    jout = str(tmp_path / "jax_export.pth")
    _stdout(jexport.main, ["-c", src, "-o", jout])
    with contextlib.redirect_stdout(io.StringIO()):
        tloaded = tck.load_model_smart(jout, device="cpu")
    for got, want in zip(_forward(tloaded, pixels), _jax_forward(jm, pixels)):
        np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)
    assert tck.get_model_info(jout) == tck.get_model_info(out)


def test_export_mlpackage_writes_the_pth_and_the_command(ckpt_dir, tmp_path):
    ml = str(tmp_path / "m.mlpackage")
    text = _stdout(texport.main, ["-c", str(ckpt_dir / "model.pth"), "-o", ml], device="cpu")
    jtext = _stdout(jexport.main, ["-c", str(ckpt_dir / "model.pth"), "-o", ml])
    assert (tmp_path / "m.pth").exists()
    tail = f"  python export_coreml.py -c {tmp_path / 'm.pth'} -o {ml}\n"
    assert tail in text and tail in jtext
    assert text.split("Wrote the reference-schema")[1] == jtext.split("Wrote the reference-schema")[1]
    with pytest.raises(ValueError, match=".msgpack"):
        texport.export(str(ckpt_dir / "model.msgpack"), str(tmp_path / "x.pth"), device="cpu")


# ---------------------------------------------------------------------------
# demo
# ---------------------------------------------------------------------------

def _capturing(module, monkeypatch) -> list:
    """Record the (heatmaps, z) every figure of ``module``'s demo draws."""
    drawn = []
    render = module.render_figure

    def capture(image, heatmaps, z, plot_mode, keypoint_label):
        drawn.append((np.asarray(heatmaps), np.asarray(z)))
        return render(image, heatmaps, z, plot_mode, keypoint_label)

    monkeypatch.setattr(module, "render_figure", capture)
    return drawn


def _assert_drawn_alike(got, want):
    assert len(got) == len(want)
    for (hm, z), (jhm, jz) in zip(got, want):
        assert hm.shape == jhm.shape == (24, 48, 48) and z.shape == jz.shape == (24,)
        np.testing.assert_allclose(hm, jhm, atol=FWD_ATOL, rtol=0)
        np.testing.assert_allclose(z, jz, atol=FWD_ATOL, rtol=0)


def test_demo_image_matches_jax(ckpt_dir, image_file, tmp_path, monkeypatch):
    pth = str(ckpt_dir / "model.pth")
    got = _capturing(tdemo, monkeypatch)
    want = _capturing(jdemo, monkeypatch)
    out = tmp_path / "out.png"
    text = _stdout(tdemo.main, ["--input", image_file, "--model", pth, "--output", str(out),
                                "--plot_mode", "combined", "--show_info"], device="cpu")
    assert out.exists() and out.stat().st_size > 0
    assert "Model info:" in text and f"Visualization saved to {out}" in text
    _stdout(jdemo.main, ["--input", image_file, "--model", pth, "--output",
                         str(tmp_path / "jax.png"), "--plot_mode", "combined"])
    _assert_drawn_alike(got, want)


def test_demo_gif_matches_jax(ckpt_dir, tmp_path, monkeypatch):
    import imageio

    pth = str(ckpt_dir / "model.pth")
    rng = np.random.default_rng(1)
    gif_in = tmp_path / "in.gif"
    imageio.mimsave(gif_in, [rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
                             for _ in range(3)], fps=5)
    got = _capturing(tdemo, monkeypatch)
    want = _capturing(jdemo, monkeypatch)
    out = tmp_path / "out.gif"
    argv = ["--input", str(gif_in), "--model", pth, "--max_frames", "2", "--batch_size", "2"]
    text = _stdout(tdemo.main, argv + ["--output", str(out)], device="cpu")
    assert "Extracted 2 frames" in text and "Processed 2/2 frames" in text
    assert len(imageio.mimread(out)) == 2
    _stdout(jdemo.main, argv + ["--output", str(tmp_path / "jax.gif")])
    _assert_drawn_alike(got, want)


def test_demo_chunks_pad_the_last_batch(models):
    """Chunks of ``--batch_size`` frames, the last padded with zero frames:
    each forward takes a full batch, and the padding's outputs are dropped."""
    from dino_pose_tpu_torch.data.preprocess import create_preprocessor

    seen = []

    def predict(pixels):
        seen.append(pixels.shape[0])
        n = len(pixels)
        return np.zeros((n, 24, 2)), np.arange(n, dtype=np.float32)[:, None], np.zeros((n, 1))

    frames = [Image.new("RGB", (64, 48)) for _ in range(5)]
    chunks = list(tdemo.predict_chunks(frames, predict, create_preprocessor("test/vit-tiny"), 2))
    assert seen == [2, 2, 2] and [len(c) for c, _, _ in chunks] == [2, 2, 1]
    assert [z[:, 0].tolist() for _, _, z in chunks] == [[0, 1], [0, 1], [0]]


def test_demo_flags_match_jax(capsys):
    def actions(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.const, a.choices)
                for a in parser._actions}

    for t, j in ((tdemo, jdemo), (tinfo, jinfo)):
        assert actions(t.build_parser()) == actions(j.build_parser())
    assert {k: v[:2] for k, v in actions(texport.build_parser()).items()} == \
        {k: v[:2] for k, v in actions(jexport.build_parser()).items()}
    parse = tdemo.build_parser().parse_args
    assert parse(["--keypoint_label"]).keypoint_label is True
    assert parse(["--keypoint_label", "False"]).keypoint_label is False
    with pytest.raises(SystemExit, match="--input is required"):
        tdemo.main([], device="cpu")


# ---------------------------------------------------------------------------
# benchmark_model, compare_models, the device rule
# ---------------------------------------------------------------------------

BENCH_KEYS = {"model", "avg_ms", "p50_ms", "fps", "device_ms", "device_p50_ms", "device_fps",
              "params"}


def test_benchmark_model_reports_jaxs_keys(ckpt_dir, models):
    pth = str(ckpt_dir / "model.pth")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        result = tbench.benchmark_model(pth, warmup=1, iters=2, device="cpu")
    assert set(result) == BENCH_KEYS and result["model"] == "test/vit-tiny"
    assert all(result[k] > 0 for k in BENCH_KEYS - {"model"})
    assert result["params"] == models[1].count_parameters(trainable_only=False)
    assert f"  Parameters:            {result['params']:,}" in text.getvalue()


def test_compare_models_prints_the_comparison():
    argv = ["--model_a", "test/vit-tiny", "--model_b", "test/fastvit-tiny", "--iters", "2"]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        a, b = tcompare.main(argv + ["--device-time"], device="cpu")
    lines = text.getvalue().split("\nComparison (end-to-end):\n")[1].splitlines()
    assert re.fullmatch(r"  test/vit-tiny: [\d.]+ ms \([\d.]+ FPS\), [\d,]+ params, "
                        r"[\d.]+ ms on-device", lines[0])
    assert re.fullmatch(r"  test/fastvit-tiny: .* ms on-device", lines[1])
    assert re.fullmatch(r"  test/\S+ is [\d.]+x faster than test/\S+", lines[2])
    assert re.fullmatch(r"  on-device: test/\S+ is [\d.]+x faster than test/\S+", lines[3])
    assert all(r["device_ms"] > 0 and r["avg_ms"] > 0 for r in (a, b))


def test_clis_need_a_card_unless_asked_for_the_cpu(ckpt_dir, image_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card; the no-card refusal cannot be shown here")
    pth = str(ckpt_dir / "model.pth")
    for main, argv in ((tdemo.main, ["--input", image_file, "--model", pth]),
                       (texport.main, ["-c", pth, "-o", str(tmp_path / "x.pth")]),
                       (tbench.main, ["--model", "test/vit-tiny"]),
                       (tcompare.main, ["--model_a", "test/vit-tiny", "--model_b",
                                        "test/vit-tiny"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    assert "Dinov2PoseModelLoRA" in _stdout(tinfo.main, ["--checkpoint", pth])
