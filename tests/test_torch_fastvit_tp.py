"""FastViT under a model axis, and ``fit`` with a model axis across ranks,
against the JAX package on the CPU in f32; the MLP-variant heads.

``test/fastvit-tiny`` + LoRA rank 4 (``test_torch_fastvit_train.py``'s JAX
variables, drawn once per module) under ``MeshSpec(1, 2)`` in one process:
every ConvFFN runs as two shards of H/2 hidden units and the attention
stage as two shards of nh/2 heads, summed by ``Mesh.all_reduce``. JAX's
FastViT split is a layout over the same function (``tests/
test_fastvit_tp.py`` holds its sharded step against its replicated one);
the port's forward is held against JAX's replicated one as one card is,
its train step against JAX's by the one-card rules (``GATED``) and against
its own one-card step with that test's tolerances: loss rtol 1e-5, every
parameter after the step atol 2e-5 / rtol 1e-4 (more than 50 leaves; the
roundoff-level gradients excepted, see the step test). The same under JAX's
fold switches
``DINO_POSE_TPU_FASTVIT_FOLD=0`` and ``DINO_POSE_TPU_FASTVIT_TRAIN_FFN=fold``
(read at call time on both sides). The splits engage: each ConvFFN call
sees width H/2 and each attention call nh/2 heads, twice a layer.

One launch of two gloo ranks runs ``fit`` with ``MeshSpec(1, 2)`` across
them on ``test/vit-tiny`` + LoRA (dinov2's tensor-parallel halves) and on
``test/fastvit-tiny`` + LoRA (the shards above), 2 steps each, with a
validation set (the eval step on the mesh, PCKh rank-local): both ranks end
bit-identical, and equal, bit for bit, to ``fit`` with ``MeshSpec(1, 2)``
in this process (a sum of two partials is the same in either order; the
reference runs on the workers' two threads).

``HeatmapHead``/``PoseHeads`` (the MLP variant) against JAX's at heatmap
sizes 48 and 40 (the overshoot case: ``adjust`` and the adaptive pool),
eval, f32, atol 1e-5.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from dino_pose_tpu.models import heads as jheads
from dino_pose_tpu.nn import layers as jlayers
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu_torch.config import get_default_configs
from dino_pose_tpu_torch.core import distributed as tdistributed
from dino_pose_tpu_torch.core.mesh import MeshSpec, create_mesh
from dino_pose_tpu_torch.io.convert import state_dict_from_jax
from dino_pose_tpu_torch.models import fastvit as tfastvit
from dino_pose_tpu_torch.models import heads as theads
from dino_pose_tpu_torch.ops import convffn as tconvffn
from dino_pose_tpu_torch.ops import dispatch
from dino_pose_tpu_torch.train import loop as tloop
import test_torch_convffn_plan as plan_tests
from test_torch_data import write_coco
from test_torch_distributed import load_npz, run_ranks
from test_torch_fastvit_train import CONFIG, batch, jax_model  # noqa: F401  (fixtures)
from test_torch_fastvit_train import GATED
from test_torch_train import (_NoDropout, _check_two_steps, _jax_two_steps, _port_model,
                              _port_two_steps)

TP = 2
ARMS = {"default": {}, "fold0": {"DINO_POSE_TPU_FASTVIT_FOLD": "0"},
        "ffn_fold": {"DINO_POSE_TPU_FASTVIT_TRAIN_FFN": "fold"}}


# Step-1 running statistics against JAX's: under FASTVIT_FOLD=0 and
# TRAIN_FFN=fold the one-card port itself reads up to 1.19e-7 against JAX
# (a RepMixer's skip-BN running mean; a heads' BatchNorm), f32 summation
# order, so those arms take test_torch_dist_fastvit.py's 1e-6.
STATS_ATOL = {"fold0": 1e-6, "ffn_fold": 1e-6}


def _arm(monkeypatch, arm: str) -> None:
    """JAX's and the port's switches together (both read os.environ), and
    JAX's default ConvFFN route off a TPU."""
    for env in ARMS.values():
        for k in env:
            monkeypatch.delenv(k, raising=False)
    for k, v in ARMS[arm].items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("DINO_POSE_TPU_CONVFFN", raising=False)


def _record_splits(monkeypatch) -> dict:
    """The hidden width of every ConvFFN call and the heads of every
    attention call the port's FastViT makes."""
    seen = {"ffn": [], "heads": []}
    for name in ("convffn_train", "convffn_math", "fused_convffn"):
        fn = getattr(tfastvit, name)
        monkeypatch.setattr(tfastvit, name, lambda y, p, *a, _f=fn, **k:
                            seen["ffn"].append(p.w1.shape[1]) or _f(y, p, *a, **k))
    for name in ("attention", "plain_attention"):
        fn = getattr(tfastvit, name)
        monkeypatch.setattr(tfastvit, name, lambda q, *a, _f=fn, **k:
                            seen["heads"].append(q.shape[1]) or _f(q, *a, **k))
    return seen


def _assert_split(tm, seen: dict, passes: int) -> None:
    """Every ConvFFN ran as TP shards of H/TP, every attention stage as TP
    shards of nh/TP heads, ``passes`` times (forward, or forward and
    backward recomputation)."""
    ffns = [m for m in tm.modules() if isinstance(m, tfastvit.ConvFFN)]
    attns = [m for m in tm.modules() if isinstance(m, tfastvit.SpatialAttention)]
    assert ffns and attns
    want_ffn = sorted(m.hidden // TP for m in ffns for _ in range(TP)) * passes
    assert sorted(seen["ffn"]) == sorted(want_ffn)
    assert seen["heads"] == [m.num_heads // TP for m in attns for _ in range(TP)] * passes


@pytest.mark.parametrize("arm", ["default", "fold0"])
def test_forward_under_model_axis_matches_jax(jax_model, batch, arm, monkeypatch):
    """The pose model in eval under ``MeshSpec(1, 2)`` against JAX's
    replicated forward: heatmaps and z to 1e-4, as one card is held
    (``test_torch_fastvit.py``); the split engages."""
    module, variables = jax_model
    _arm(monkeypatch, arm)
    with jdispatch.local():
        hm_j, z_j = jax.jit(lambda v, x: module.apply(v, x, train=False))(
            variables, jnp.asarray(batch["image"]))
    tm = _port_model(variables, CONFIG).eval()
    seen = _record_splits(monkeypatch)
    with dispatch.scoped(), torch.inference_mode():
        create_mesh(MeshSpec(1, TP), device="cpu")
        hm_t, z_t = tm(torch.from_numpy(batch["image"]))
    _assert_split(tm, seen, 1)
    np.testing.assert_allclose(hm_t.numpy(), np.asarray(hm_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-4, rtol=0)


@pytest.mark.parametrize("arm", list(ARMS))
def test_train_step_under_model_axis_matches_jax(jax_model, batch, arm, monkeypatch):
    """Two LoRA train steps under ``MeshSpec(1, 2)``: against JAX's
    replicated steps by the rules the one-card route is held to
    (``test_torch_fastvit_train.GATED``), and against the port's own
    one-card first step to ``tests/test_fastvit_tp.py``'s tolerances, which
    hold JAX's sharded step against its replicated one: the loss rtol 1e-5,
    every parameter after the step atol 2e-5 / rtol 1e-4 (more than 50
    leaves, the 16 adapters moved), and every step-1 gradient leaf to 1e-4
    relative Frobenius error. The elements whose gradient is at roundoff
    level (below 1e-5 of the largest on both routes, not exactly zero on
    both; all of each conv bias that a train-mode BatchNorm normalises
    away; 1.9% of the elements) are held to ``GATED``'s 2.01*lr: AdamW's
    first step maps a gradient to about +-lr whatever its size, so a sign
    that the split's f32 summation order flips moves its element 2*lr
    (measured: 3.3e-5 in an hourglass conv weight whose gradient read
    1.4e-8 on one card and -1.0e-8 split). Against JAX the strict
    tolerances do not hold on one card either: an adapter element whose
    gradient sits within the two frameworks' roundoff of zero flips its
    sign (measured: one element of 192 in a LoRA B, 5.99e-5).
    The ConvFFN forward runs once a shard and step, the attention once a
    shard and step."""
    module, variables = jax_model
    _arm(monkeypatch, arm)
    monkeypatch.setattr(jlayers, "Dropout", _NoDropout)
    want = _jax_two_steps(module, variables, CONFIG, batch, family="fastvit")
    one = _port_two_steps(_port_model(variables, CONFIG), CONFIG, batch)
    tm = _port_model(variables, CONFIG)
    seen = _record_splits(monkeypatch)
    with dispatch.scoped():
        create_mesh(MeshSpec(1, TP), device="cpu")
        got = _port_two_steps(tm, CONFIG, batch)
    _assert_split(tm, seen, 2)
    _check_two_steps(tm, want, got, **GATED, stats_atol=STATS_ATOL.get(arm, 1e-7))
    np.testing.assert_allclose(float(got["stats"][0]["loss"]), float(one["stats"][0]["loss"]),
                               rtol=1e-5)
    # Elements whose step-1 gradient is at roundoff level (below 1e-5 of
    # the largest gradient on both routes, chip_smoke.py's rule; all of each
    # conv bias that a train-mode BatchNorm normalises away, whose exact
    # gradient is zero): AdamW's first step moves an element by about lr
    # whatever its gradient's size, so a sign that the split's f32 order
    # flips moves it 2*lr. They are held to 2.01*lr.
    scale = max(np.abs(g).max() for g in one["grads"].values())
    checked = noise = total = 0
    for k in dict(tm.named_parameters()):
        v, w = got["states"][1][k].numpy(), one["states"][1][k].numpy()
        g = one["grads"].get(k)
        g2 = got["grads"].get(k)
        tiny = (np.zeros(v.shape, bool) if g is None else
                (np.maximum(np.abs(g), np.abs(g2)) < 1e-5 * scale) & ((g != 0) | (g2 != 0)))
        np.testing.assert_allclose(v[~tiny], w[~tiny], atol=2e-5, rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(v[tiny], w[tiny], atol=GATED["step_atol"], rtol=0,
                                   err_msg=k)
        if g is not None:
            rel = np.linalg.norm(g2 - g) / max(np.linalg.norm(g), 1e-30)
            assert rel < 1e-4 or np.abs(g).max() < 1e-5 * scale, (k, rel)
        checked += 1
        noise, total = noise + int(tiny.sum()), total + tiny.size
    assert noise < 0.25 * total, (noise, total)
    assert checked > 50
    lora = [k for k in got["grads"] if "lora_" in k]
    assert len(lora) == 16
    assert all(not torch.equal(got["states"][1][k], got["states"][0][k]) for k in lora)


def _shard_stage(stage: tuple) -> tuple:
    """A ConvFFN stage (model, C, H, S) at one model shard's hidden width
    H/TP, C and H/TP as the kernels take them (padded up to 16s)."""
    model, c, h, s = stage
    return model, c, tconvffn._up16(h // TP), s


SHARD_STAGES = [_shard_stage(st) for st in plan_tests.STAGES]


@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("stage", SHARD_STAGES, ids=lambda t: f"{t[0]}-C{t[1]}-H{t[2]}")
def test_convffn_plan_fits_every_shard_width(stage, bwd):
    """``convffn_plan`` at each t8/sa12/ma36 stage's shard width H/2 (t8's
    72 padded to 80, ma36's 152 to 160), batch 1 to 128, ranks 1 and 8: an
    existing instance, shared memory within the limit, every output slice
    covered (``test_torch_convffn_plan.py``'s checks)."""
    for batch in (1, 8, 32, 128):
        plan_tests.test_plan_fits_and_covers_every_stage(stage, batch, bwd)


# ---------------------------------------------------------------------------
# fit with a model axis across two ranks
# ---------------------------------------------------------------------------

FIT_BS = 4


def _fit_configs(data, checkpoint_dir, model_name: str) -> list:
    (ti, ta), (vi, va) = data
    d, t, p, m = get_default_configs()
    d.update(train_images_dir=str(ti), train_annotation_json=str(ta),
             val_images_dir=str(vi), val_annotation_json=str(va))
    t.update(batch_size=FIT_BS, num_epochs=1, save_freq=1, checkpoint_dir=str(checkpoint_dir),
             multiprocessing_num=2, learning_rate=1e-3)
    m.update(model_name=model_name, use_lora=True)
    return [d, t, p, m]


MODELS = {"vit": "test/vit-tiny", "fastvit": "test/fastvit-tiny"}


@pytest.fixture(scope="module")
def fit_runs(tmp_path_factory):
    """Both models' fit on two ranks under (1, 2), and in this process
    under (1, 2) on two threads."""
    tmp = tmp_path_factory.mktemp("fit_tp")
    data = (write_coco(tmp / "train", 2 * FIT_BS, seed=60), write_coco(tmp / "val", 2, seed=61))
    runs = {k: _fit_configs(data, tmp / f"ck_{k}", name) for k, name in MODELS.items()}
    run_ranks(tmp / "ranks", [{"name": "fit_tp", "runs": runs}], timeout=240)
    out = tmp / "ranks" / "out"
    ranks = {k: [(load_npz(out / f"fit_tp_{k}_{r}.npz"),
                  json.loads((out / f"fit_tp_{k}_{r}.json").read_text())) for r in range(TP)]
             for k in MODELS}
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = {}
        for k, (d, t, p, m) in runs.items():
            h = tloop.fit(d, {**t, "checkpoint_dir": str(tmp / f"one_{k}")}, p, m, device="cpu",
                          progress=False, mesh=MeshSpec(1, TP))
            one[k] = ({n: v.numpy() for n, v in h["model"].state_dict().items()}, h)
    finally:
        torch.set_num_threads(threads)
    return ranks, one


@pytest.mark.parametrize("model", list(MODELS))
def test_fit_across_model_ranks_is_one_process_bit_for_bit(fit_runs, model):
    """Two steps on each rank; the losses, PCKh and every tensor of the
    final state equal the one-process (1, 2) fit's bit for bit, and the two
    ranks hold identical parameters."""
    ranks, one = fit_runs
    sd_one, h_one = one[model]
    assert h_one["state"].step == 2
    (sd0, h0), (sd1, h1) = ranks[model]
    for h in (h0, h1):
        assert h["step"] == 2
        assert h["train_loss"] == h_one["train_loss"] and h["val_loss"] == h_one["val_loss"]
        assert h["pckh"] == [list(p) for p in h_one["pckh"]]
    assert set(sd0) == set(sd1) == set(sd_one)
    moved = 0
    for k in sd_one:
        assert np.array_equal(sd0[k], sd1[k]), k
        assert np.array_equal(sd0[k], sd_one[k]), k
        moved += "lora" in k
    assert moved and all(np.isfinite(h0["train_loss"]))


def test_fit_warns_of_unused_cards(monkeypatch, capsys):
    """More cards visible than the launch runs processes on the host: one
    line saying that the process trains on one card and how to launch one
    process a card; none where torchrun's local world covers them."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for k in ("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE"):
        monkeypatch.delenv(k, raising=False)
    msg = tdistributed.unused_cards_warning("cuda:0")
    assert "4 CUDA devices are visible" in msg and "trains on cuda:0 alone" in msg
    assert "torchrun --nproc_per_node=4" in msg
    assert tdistributed.unused_cards_warning("cuda:0", {"LOCAL_WORLD_SIZE": "4"}) is None
    assert tdistributed.unused_cards_warning("cuda:0", {"SLURM_NTASKS_PER_NODE": "4(x2)"}) is None
    assert "runs 2 processes" in tdistributed.unused_cards_warning(
        "cuda:1", {"LOCAL_WORLD_SIZE": "2"})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tdistributed.unused_cards_warning("cuda:0") is None


def test_fit_prints_the_unused_cards_warning_once(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    d, t, p, m = _fit_configs((write_coco(tmp_path / "train", FIT_BS, seed=62),
                               ("", "")), tmp_path / "ck", "test/vit-tiny")
    tloop.fit(d, t, p, m, device="cpu", progress=False)
    out = capsys.readouterr().out
    assert out.count("8 CUDA devices are visible") == 1


# ---------------------------------------------------------------------------
# The MLP-variant heads
# ---------------------------------------------------------------------------

FEATURES = 64


def _draw(shapes: dict, rng: np.random.Generator) -> dict:
    """Variables for the flattened ``shapes`` of an init (traced, not run):
    kernels and their biases U(+-1/sqrt(fan_in)), BatchNorm scale and bias
    near (1, 0), running statistics away from (0, 1) so that eval
    BatchNorm acts."""
    def draw(path, leaf):
        kernel = shapes.get(path[:-1] + ("kernel",))
        if path[-1] in ("kernel", "bias") and kernel is not None:
            bound = math.prod(kernel.shape[:-1]) ** -0.5
            return rng.uniform(-bound, bound, leaf.shape)
        if path[-1] in ("scale", "var"):
            return rng.uniform(0.5, 2.0, leaf.shape)
        return rng.normal(0, 0.1, leaf.shape)

    return traverse_util.unflatten_dict(
        {k: draw(k, v).astype(np.float32) for k, v in shapes.items()})


@pytest.fixture(scope="module", params=[48, 40], ids=["hm48", "hm40_overshoot"])
def mlp_heads(request):
    """JAX's ``PoseHeads`` at the heatmap size with drawn variables, and the
    port's with its weights."""
    hm = request.param
    feats = np.random.default_rng(70).standard_normal((2, FEATURES)).astype(np.float32)
    jm = jheads.PoseHeads(heatmap_size=hm)
    shapes = traverse_util.flatten_dict(jax.eval_shape(
        lambda x: jm.init(jax.random.key(0), x, train=False), jnp.asarray(feats)))
    variables = _draw(shapes, np.random.default_rng(71))
    tm = theads.PoseHeads(FEATURES, 24, hm)
    tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
    return hm, jm, variables, tm.eval(), feats


def test_pose_heads_match_jax(mlp_heads):
    """Heatmaps (NCHW against JAX's NHWC) and z, eval, f32, atol 1e-5; at
    40 the chain overshoots to 48 and ``adjust`` + the adaptive pool bring
    it back."""
    hm, jm, variables, tm, feats = mlp_heads
    h_j, z_j = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(feats))
    with torch.inference_mode():
        h_t, z_t = tm(torch.from_numpy(feats))
    assert h_t.shape == (2, 24, hm, hm) and z_t.shape == (2, 24)
    assert (tm.heatmap_head.adjust is not None) == (hm == 40) == tm.heatmap_head.overshoot
    np.testing.assert_allclose(h_t.permute(0, 2, 3, 1).numpy(), np.asarray(h_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-5, rtol=0)


def test_heatmap_head_alone_matches_jax(mlp_heads):
    """``HeatmapHead`` on its own variables (JAX's ``heatmap_head``
    subtree), and the adaptive pool against torch's ``AdaptiveAvgPool2d``."""
    hm, _, variables, _, feats = mlp_heads
    sub = {c: v["heatmap_head"] for c, v in variables.items()}
    jh = jheads.HeatmapHead(heatmap_size=hm)
    want = jax.jit(lambda v, x: jh.apply(v, x, train=False))(sub, jnp.asarray(feats))
    th = theads.HeatmapHead(FEATURES, 24, hm)
    th.load_state_dict(state_dict_from_jax(sub, th), strict=True)
    with torch.inference_mode():
        got = th.eval()(torch.from_numpy(feats))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    x = torch.from_numpy(np.random.default_rng(72).standard_normal((2, 5, 48, 48)).astype(
        np.float32))
    np.testing.assert_allclose(theads.adaptive_avg_pool(x, hm).numpy(),
                               torch.nn.AdaptiveAvgPool2d(hm)(x).numpy(), atol=1e-6)
    assert math.isclose(float(theads.adaptive_avg_pool(torch.ones(1, 1, 48, 48), 40).mean()),
                        1.0, rel_tol=1e-6)
