"""The port's FastViT training path against the JAX package's, on the CPU in f32.

``test/fastvit-tiny`` with LoRA rank 4 on every ConvFFN (dropout off on both
sides), built once on the JAX side with BatchNorm running stats, LayerScales
and LoRA B randomised (``test_torch_fastvit._randomise``) and carried into
the port through ``io/convert.state_dict_from_jax``. Inputs come from numpy
seeds, with a mean offset so that the one-pass moments of the coefficient
branches see a channel mean. Tolerances, f32 (summation order only):

- each train-mode block (stem0's gram-matrix scale branch, stem1's depthwise
  scale branch on the stride-2 grid, a PatchEmbed, a RepMixer, a ConvFFN,
  ``final_conv`` with its multiplier-2 coefficient, SpatialAttention) and the
  whole backbone against ``module.apply(..., train=True,
  mutable=["batch_stats"])``: outputs to 1e-5 of their largest magnitude,
  every running mean and var to 1e-5 relative (1e-7 absolute);
- the LoRA gradients of the backbone alone, under a seeded cotangent on the
  feature map, against JAX's vjp: 1e-5 relative Frobenius error (no ReLU
  gate lies between them);
- two train steps with LoRA and without (heads only), at 256², with the
  rules of ``test_torch_train._two_steps_match_jax``: losses of step 1 to
  1e-5, the heads' leaves above their last ReLU gates to 1e-4, parameters
  after AdamW within 2*lr a step. The leaves below the heads' gates (the
  LoRA adapters included), the step-2 losses and the step-2 running stats
  are held to what the gates allow: the backbone's feature maps differ by
  ~5e-6 relative between the frameworks (f32 summation order through the
  depth), and the heads' train-mode BatchNorms over 8x8 grids of two
  images amplify that until units within roundoff of a ReLU gate flip.
  Over eight weight draws at batches 2 and 4 those leaves differed by
  6.8e-5 to 1.4e-2, the step-2 losses by up to 1.75e-4 and the step-2
  running stats by up to 3.6e-4, so they are held to 5e-2, 1e-3 and 1e-3
  (at 128², with 4x4 grids, the leaves differed by up to 12%). A gradient
  whose sign flips moves its parameter 2*lr away in AdamW's first step,
  plus the rounding of p +- lr: parameters are held to 2.01*lr a step. The
  LoRA gradients with no gate in the way are held to 1e-5 above.

JAX's ConvFFN routes: ``xla`` (its default off a TPU: BatchNorm and 1x1
convs as XLA layers, LoRA as flax convs) and ``force`` (its Pallas kernels
in interpret mode: ``_convffn_fwd_kernel``, and ``_convffn_bwd_kernel`` in
a backward). The backbone and its LoRA gradients are held on both; the
LoRA step on ``force``; the step without LoRA on ``xla``, where JAX's gate
sends every ConvFFN without LoRA in training.
"""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_fastvit import _drop_lora, _randomise
from test_torch_train import LR, _NoDropout, _port_model, _t, _two_steps_match_jax

from dino_pose_tpu.models import fastvit as jfastvit
from dino_pose_tpu.models import fastvit_pose as jfastvit_pose
from dino_pose_tpu.nn import layers as jlayers
from dino_pose_tpu.ops import convffn as jconvffn
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu.train import state as jstate
from dino_pose_tpu.train import step as jstep
from dino_pose_tpu_torch.io.convert import state_dict_from_jax
from dino_pose_tpu_torch.models import fastvit as tfastvit
from dino_pose_tpu_torch.train import state as tstate
from dino_pose_tpu_torch.train import step as tstep

CONFIG = {"model_name": "test/fastvit-tiny", "use_lora": True, "lora_rank": 4,
          "lora_dropout": 0.0}
PLAIN_CONFIG = {**CONFIG, "use_lora": False}
# The heads' leaves above their last ReLU gates (test_torch_train's rule, at
# FastViT's key prefix).
ABOVE = ("backbone.head.z_head.", "backbone.head.heatmap_head.prediction.")
# The heads' gates: see the module docstring.
GATED = dict(above=ABOVE, below_tol=5e-2, step2_rtol=1e-3, step2_stats_atol=1e-3,
             step_atol=2.01 * LR)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX LoRA model and its variables, drawn with numpy from the
    shapes of its init (tracing it, not running it) as its initialisers
    draw them: kernels and their biases U(+-1/sqrt(fan_in)), BatchNorm scale
    1 and bias 0; then ``_randomise``."""
    module = jfastvit_pose.FastVitPoseModule(cfg=dataclasses.replace(
        jfastvit.FASTVIT_PRESETS["test-tiny"], lora_rank=4, lora_dropout=0.0))
    shapes = traverse_util.flatten_dict(
        jax.eval_shape(module.init, jax.random.key(0), jnp.zeros((1, 3, 128, 128))))
    rng = np.random.default_rng(20)

    def draw(path, leaf):
        kernel = shapes.get(path[:-1] + ("kernel",))
        if path[-1] in ("kernel", "bias") and kernel is not None:
            bound = math.prod(kernel.shape[:-1]) ** -0.5
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        return np.full(leaf.shape, path[-1] in ("scale", "var"), np.float32)

    flat = {k: draw(k, v) for k, v in shapes.items()}
    return module, _randomise(traverse_util.unflatten_dict(flat), rng)


def _route(monkeypatch, route: str) -> dict:
    """Select JAX's ConvFFN route; count its Pallas kernel bodies' traces."""
    if route == "force":
        monkeypatch.setenv("DINO_POSE_TPU_CONVFFN", "force")
    else:
        monkeypatch.delenv("DINO_POSE_TPU_CONVFFN", raising=False)
    calls = {"_convffn_fwd_kernel": 0, "_convffn_bwd_kernel": 0}
    for name in calls:
        orig = getattr(jconvffn, name)
        monkeypatch.setattr(jconvffn, name, lambda *a, _n=name, _o=orig, **k:
                            calls.__setitem__(_n, calls[_n] + 1) or _o(*a, **k))
    return calls


def _nhwc(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape) * 1.5 + 0.5
    return x.astype(np.float32)


def _to_port(x_nhwc: np.ndarray) -> torch.Tensor:
    return _t(x_nhwc.transpose(0, 3, 1, 2)).contiguous(memory_format=torch.channels_last)


def _sub(tree: dict, path: tuple) -> dict:
    for k in path:
        tree = tree[k]
    return tree


def _stats_with(variables: dict, path: tuple, mutated: dict) -> dict:
    """``variables`` with the batch stats under ``path`` replaced."""
    stats = copy.deepcopy(variables["batch_stats"])
    _sub(stats, path[:-1])[path[-1]] = mutated
    return {"params": variables["params"], "batch_stats": stats}


def _assert_stats_match(tm, want_variables: dict, *ran: torch.nn.Module) -> None:
    """Every running mean and var of the port model against JAX's; the
    BatchNorms of the modules that ``ran`` counted one batch, the others
    none."""
    want = state_dict_from_jax(want_variables, tm)
    inside = {id(m) for module in ran for m in module.modules()}
    n_bn = 0
    for name, m in tm.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            for stat in ("running_mean", "running_var"):
                np.testing.assert_allclose(getattr(m, stat).numpy(), want[f"{name}.{stat}"].numpy(),
                                           rtol=1e-5, atol=1e-7, err_msg=f"{name}.{stat}")
            assert m.num_batches_tracked.item() == (id(m) in inside), name
            n_bn += id(m) in inside
    assert n_bn > 0


def _jax_blocks(cfg):
    """(JAX module, its path under the variables, port module getter, port
    call, NHWC input shape) of each train-mode block of test/fastvit-tiny."""
    d = cfg.embed_dims
    return {
        "stem0": (jfastvit.MobileOneBlock(d[0], 3, strides=2), ("backbone", "stem0"),
                  lambda tm: tm.backbone.stem[0], None, (2, 128, 128, 3)),
        "stem1": (jfastvit.MobileOneBlock(d[0], 3, strides=2, groups=d[0]), ("backbone", "stem1"),
                  lambda tm: tm.backbone.stem[1], None, (2, 64, 64, d[0])),
        "patch_embed": (jfastvit.PatchEmbed(d[1]), ("backbone", "downsample1"),
                        lambda tm: tm.backbone.stages[1].downsample, None, (2, 32, 32, d[0])),
        "repmixer": (jfastvit.RepMixer(cfg.layer_scale_init),
                     ("backbone", "stage0_block0", "token_mixer"),
                     lambda tm: tm.backbone.stages[0].blocks[0].token_mixer, None,
                     (2, 32, 32, d[0])),
        "convffn": (jfastvit.ConvFFN(hidden=3 * d[1], lora_rank=cfg.lora_rank,
                                     lora_alpha=cfg.lora_alpha, lora_dropout=0.0),
                    ("backbone", "stage1_block0", "mlp"),
                    lambda tm: tm.backbone.stages[1].blocks[0].mlp, None, (2, 16, 16, d[1])),
        "final_conv": (jfastvit.MobileOneBlock(cfg.out_channels, 3, strides=1, groups=d[-1],
                                               use_se=cfg.final_se),
                       ("backbone", "final_conv"), lambda tm: tm.backbone.final_conv, None,
                       (2, 4, 4, d[-1])),
        "attention": (jfastvit.SpatialAttention(cfg.attn_head_dim),
                      ("backbone", "stage3_block0", "attn"),
                      lambda tm: tm.backbone.stages[3].blocks[0].token_mixer,
                      lambda tm, x: tm.backbone.stages[3].blocks[0].token_mixer(
                          x, tm.backbone.stages[3].blocks[0].norm),
                      (2, 4, 4, d[-1])),
    }


@pytest.mark.parametrize("name", ["stem0", "stem1", "patch_embed", "repmixer", "convffn",
                                  "final_conv", "attention"])
def test_train_mode_block_matches_jax(jax_model, name, monkeypatch):
    """The block's train-mode output and running statistics (the
    SpatialAttention's BatchNorm sits on its block in the port, ``norm``)."""
    module, variables = jax_model
    calls = _route(monkeypatch, "force" if name == "convffn" else "xla")
    jmod, path, get, call, shape = _jax_blocks(module.cfg)[name]
    x = _nhwc(shape, seed=len(name))
    sub = {c: _sub(variables[c], path) for c in ("params", "batch_stats")}
    with jdispatch.local():
        want, mutated = jmod.apply(sub, jnp.asarray(x), train=True, mutable=["batch_stats"])
    assert calls["_convffn_fwd_kernel"] == (name == "convffn")
    tm = _port_model(variables, CONFIG).train()
    tmod = get(tm)
    stats_owner = tm.backbone.stages[3].blocks[0].norm if name == "attention" else tmod
    with torch.no_grad():
        got = call(tm, _to_port(x)) if call else tmod(_to_port(x))
    want = np.asarray(want)
    assert got.shape == (shape[0], want.shape[-1], *want.shape[1:3])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    _assert_stats_match(tm, _stats_with(variables, path, mutated["batch_stats"]), stats_owner)


@pytest.mark.parametrize("route", ["xla", "force"])
def test_train_mode_backbone_matches_jax(jax_model, route, monkeypatch):
    """The whole backbone in train mode: the feature map and every running
    statistic after one batch."""
    module, variables = jax_model
    calls = _route(monkeypatch, route)
    x = _nhwc((2, 128, 128, 3), seed=1)
    backbone = jfastvit.FastViTBackbone(module.cfg)
    sub = {c: variables[c]["backbone"] for c in ("params", "batch_stats")}
    with jdispatch.local():
        want, mutated = backbone.apply(sub, jnp.asarray(x), train=True, mutable=["batch_stats"])
    assert calls["_convffn_fwd_kernel"] == (4 if route == "force" else 0)
    tm = _port_model(variables, CONFIG).train()
    with torch.no_grad():
        got = tm.backbone(_to_port(x))
    want = np.asarray(want)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    _assert_stats_match(tm, _stats_with(variables, ("backbone",), mutated["batch_stats"]),
                        tm.backbone.stem, tm.backbone.stages, tm.backbone.final_conv)


@pytest.mark.parametrize("route", ["xla", "force"])
def test_backbone_lora_grads_match_jax(jax_model, route, monkeypatch):
    """The 16 LoRA gradients of the train-mode backbone under a seeded
    cotangent on its feature map, against JAX's vjp (``force``: through
    ``_convffn_bwd_kernel`` in interpret mode). On the port's side they come
    through ``convffn_train``'s backward, not through the fold cache: each
    is non-zero and matches."""
    module, variables = jax_model
    calls = _route(monkeypatch, route)
    flat = {k: jnp.asarray(v) for k, v in
            traverse_util.flatten_dict(variables["params"]["backbone"]).items()}
    lora = {k: v for k, v in flat.items() if k[-2] in ("lora_A", "lora_B")}
    x = _nhwc((2, 128, 128, 3), seed=2)
    backbone = jfastvit.FastViTBackbone(module.cfg)
    stats = variables["batch_stats"]["backbone"]

    def fmap(leaves):
        params = traverse_util.unflatten_dict({**flat, **leaves})
        return backbone.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              train=True, mutable=["batch_stats"])[0]

    ct = np.random.default_rng(3).standard_normal((2, 4, 4, 128)).astype(np.float32)

    def dot(leaves):  # its gradient is the vjp of ``ct``
        out = fmap(leaves)
        return jnp.vdot(out, jnp.asarray(ct)), out

    with jdispatch.local():
        (_, out), jgrads = jax.jit(jax.value_and_grad(dot, has_aux=True))(lora)
    assert len(lora) == 16
    assert calls["_convffn_bwd_kernel"] == (4 if route == "force" else 0)

    tm = _port_model(variables, CONFIG).train()
    got = tm.backbone(_to_port(x))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5 * np.abs(np.asarray(out)).max())
    got.backward(_t(ct.transpose(0, 3, 1, 2)))
    gflat = traverse_util.flatten_dict(jax.tree.map(np.zeros_like, variables["params"]))
    gflat.update({("backbone",) + k: np.asarray(g) for k, g in jgrads.items()})
    want = state_dict_from_jax({"params": traverse_util.unflatten_dict(gflat),
                                "batch_stats": variables["batch_stats"]}, tm)
    params = dict(tm.named_parameters())
    names = [n for n, p in params.items() if p.grad is not None]
    assert len(names) == 16 and all("lora_" in n for n in names)
    for n in names:
        g, w = params[n].grad.numpy(), want[n].numpy()
        assert params[n].grad.dtype == torch.float32 and np.abs(g).max() > 0, n
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < 1e-5, f"{n}: relative Frobenius error {rel:.3e}"


@pytest.fixture(scope="module")
def batch():
    """Two 256² images (FastViT's input size): an 8x8 grid, so that the
    heads' first train-mode BatchNorm sums 128 positions a channel. At 128²
    (4x4, 32 positions) its ReLU gates sit within roundoff often enough that
    a flip moved the heads' gradients by up to 12% between the frameworks."""
    rng = np.random.default_rng(21)
    kps = rng.uniform(4, 252, (2, 24, 3)).astype(np.float32)
    kps[..., 2] = rng.choice([0.0, 1.0, 2.0], (2, 24))
    return {"image": rng.standard_normal((2, 3, 256, 256)).astype(np.float32),
            "2d_keypoints": kps,
            "z_coords": (rng.standard_normal((2, 24)) * 10).astype(np.float32)}


def test_lora_train_step_matches_jax(jax_model, batch, monkeypatch):
    """Two LoRA train steps against JAX's, its ConvFFNs on their Pallas
    kernels (the backward through ``_convffn_bwd_kernel``): losses, the
    step-1 gradient of every trainable leaf (the 16 adapters and the heads),
    the parameters after AdamW, every running statistic after each step.
    The adapters' gradients are non-zero: the step reaches them through the
    ConvFFN backward."""
    module, variables = jax_model
    monkeypatch.setattr(jlayers, "Dropout", _NoDropout)
    calls = _route(monkeypatch, "force")
    grads = _two_steps_match_jax(module, variables, CONFIG, batch, family="fastvit", **GATED)
    assert calls["_convffn_bwd_kernel"]
    lora = [n for n in grads if "lora_" in n]
    assert len(lora) == 16 and all(np.abs(grads[n]).max() > 0 for n in lora)


def test_heads_only_train_step_matches_jax(jax_model, batch, monkeypatch):
    """Two train steps without LoRA (JAX's gate sends every ConvFFN to XLA
    there; the port runs its forward kernel with no graph below the heads):
    only the heads train, every backbone BatchNorm still updates."""
    module, variables = jax_model
    monkeypatch.setattr(jlayers, "Dropout", _NoDropout)
    _route(monkeypatch, "xla")
    plain = module.clone(cfg=dataclasses.replace(module.cfg, lora_rank=0))
    grads = _two_steps_match_jax(plain, _drop_lora(variables), PLAIN_CONFIG, batch,
                                 family="fastvit", **GATED)
    assert grads and all(n.startswith("backbone.head.") for n in grads)


def _step1_grads_jax(module, variables, tm, batch, dtype) -> dict:
    """JAX's step-1 gradient of every trainable leaf, under the port's names,
    with pixels cast to ``dtype`` in the step (None: f32)."""
    js, tx, part = jstate.create_train_state(variables, CONFIG, "fastvit")
    fn = jax.jit(jstep._prepare_batch(jstep.make_train_step(module, tx, part), (256, 48), dtype))
    with jdispatch.local():
        js1, _ = fn(js, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(LR),
                    jax.random.key(0))
    _, frozen = part.split(js.params)
    grads = state_dict_from_jax(
        {"params": part.merge(jax.tree.map(lambda m: np.asarray(m) / (1 - 0.9),
                                           js1.opt_state[0].mu),
                              jax.tree.map(np.zeros_like, frozen)),
         "batch_stats": variables["batch_stats"]}, tm)
    return {n: grads[n].numpy() for n, p in tm.named_parameters() if p.requires_grad}


def _step1_grads_port(variables, batch, dtype) -> dict:
    tm = _port_model(variables, CONFIG)
    ts, opt, part = tstate.create_train_state(tm, CONFIG)
    step = tstep.prepare_batch(tstep.make_train_step(tm, opt, part), (256, 48), dtype)
    step(ts, {k: _t(v) for k, v in batch.items()}, LR, 0)
    return {n: p.grad.numpy().copy() for n, p in tm.named_parameters() if p.grad is not None}


def test_bf16_step_gradients_move_as_far_in_jax(jax_model, monkeypatch):
    """A witness for the card's step-1 gradient check (chip_smoke.py), where
    bf16 moves FastViT's gradients ~50% from an f32 step on either path:
    JAX's own bf16 step moves them as far. Eight 256² images, each side's
    bf16 step against its f32 step from the same weights (JAX's default
    ConvFFN route), over the 68 trainable leaves whose f32 gradient is not
    roundoff (conv biases a BatchNorm normalises away). Measured: median
    relative Frobenius error 0.34 in JAX, 0.42 in the port (held within
    1.5x JAX's); the adapters 0.32-0.60 (JAX) and 0.41-0.81 (port); the four
    leaves above the heads' last ReLU gates at most 3.6e-3 (JAX) and 7.5e-3
    (port), held to 1e-2. The cause is conditioning: in f32 alone, pixels
    moved by 1e-6 relative move the adapters' gradients 0.62-1.2% (median
    held above 1e-3), the heads' train-mode BatchNorms and ReLU gates
    amplifying any rounding below them. The port's larger share is its
    LayerScale departure (it casts to bf16 where JAX's f32 parameter
    promotes the activations after it to f32): with the promotion patched
    in, its median is 0.36 (held within 1.2x JAX's)."""
    module, variables = jax_model
    monkeypatch.setattr(jlayers, "Dropout", _NoDropout)
    _route(monkeypatch, "xla")
    rng = np.random.default_rng(22)
    kps = rng.uniform(20, 232, (8, 24, 3)).astype(np.float32)
    kps[..., 2] = 2.0
    batch = {"image": rng.standard_normal((8, 3, 256, 256)).astype(np.float32),
             "2d_keypoints": kps, "z_coords": rng.standard_normal((8, 24)).astype(np.float32)}
    tm = _port_model(variables, CONFIG)
    jf, jb = (_step1_grads_jax(module, variables, tm, batch, dt) for dt in (None, jnp.bfloat16))
    pf, pb = (_step1_grads_port(variables, batch, dt) for dt in (None, torch.bfloat16))
    assert set(jf) == set(pf)
    scale = max(np.abs(g).max() for g in jf.values())
    names = [n for n in jf if np.linalg.norm(jf[n]) > 1e-5 * scale]

    def rel(got, want):
        return np.linalg.norm(got - want) / np.linalg.norm(want)

    gap_jax = {n: rel(jb[n], jf[n]) for n in names}
    gap_port = {n: rel(pb[n], pf[n]) for n in names}
    median_jax = np.median(list(gap_jax.values()))
    assert np.median(list(gap_port.values())) < 1.5 * median_jax

    def promoted(self, x, kernels=True, generator=None):  # JAX's f32 LayerScale promotion
        if self.mixer == "repmixer":
            x, ls2 = self.token_mixer(x), self.layer_scale
        else:
            x = x + self.token_mixer(x, self.norm, kernels) * self.layer_scale_1
            ls2 = self.layer_scale_2
        return x + self.mlp(x, kernels, generator) * ls2

    with monkeypatch.context() as m:
        m.setattr(tfastvit.FastViTBlock, "forward", promoted)
        pb32 = _step1_grads_port(variables, batch, torch.bfloat16)
    assert np.median([rel(pb32[n], pf[n]) for n in names]) < 1.2 * median_jax
    above = [n for n in names
             if n.startswith(("backbone.head.z_head.mlp.9.",
                              "backbone.head.heatmap_head.prediction.3."))]
    assert len(above) == 4 and all(max(gap_jax[n], gap_port[n]) < 1e-2 for n in above)

    noise = 1 + 1e-6 * np.random.default_rng(5).standard_normal(batch["image"].shape)
    moved = _step1_grads_port(variables, {**batch, "image": (batch["image"] * noise)
                                          .astype(np.float32)}, None)
    lora = [n for n in names if "lora_" in n]
    assert len(lora) == 16 and np.median([rel(moved[n], pf[n]) for n in lora]) > 1e-3


def test_eval_after_a_train_step_sees_the_trained_weights(jax_model, batch):
    """The eval folds are keyed on parameter and buffer versions: an eval
    step after a train step (the eval step before it filled the caches)
    gives the bits a fresh model loaded with the trained state dict gives,
    and differs from the first eval."""
    _, variables = jax_model
    tm = _port_model(variables, CONFIG)
    ts, opt, part = tstate.create_train_state(tm, CONFIG)
    tbatch = {k: _t(v) for k, v in batch.items()}
    ebatch = {**tbatch, "2d_heatmaps": torch.zeros(2, 24, 48, 48)}
    evaluate = tstep.make_eval_step(tm)
    before = evaluate(ts, ebatch)
    train = tstep.prepare_batch(tstep.make_train_step(tm, opt, part), (256, 48))
    ts, _ = train(ts, tbatch, 1e-3, 0)
    after = evaluate(ts, ebatch)
    fresh = _port_model(variables, CONFIG)
    fresh.load_state_dict(tm.state_dict())
    want = tstep.make_eval_step(fresh)(ts, ebatch)
    for k in ("pred_heatmaps", "pred_z"):
        assert torch.equal(after[k], want[k]) and not torch.equal(after[k], before[k]), k


def test_convlora_dropout_follows_the_step_generator(jax_model):
    """With ConvLoRA dropout on, a train-mode forward draws its per-(sample,
    rank) masks from the step's generator: the same seed gives the same
    feature map, another step other masks; no dropout gives a third."""
    _, variables = jax_model
    tm = _port_model(variables, {**CONFIG, "lora_dropout": 0.5}).train()
    x = _to_port(_nhwc((2, 128, 128, 3), seed=4))
    dev = torch.device("cpu")
    with torch.no_grad():
        f0, f1, f2 = (tm.backbone(x, generator=tstep.step_generator(0, s, dev))
                      for s in (0, 0, 1))
        for m in tm.modules():
            if hasattr(m, "lora_dropout"):
                m.lora_dropout = 0.0
        f3 = tm.backbone(x, generator=tstep.step_generator(0, 0, dev))
    assert torch.equal(f0, f1) and not torch.equal(f0, f2) and not torch.equal(f0, f3)
