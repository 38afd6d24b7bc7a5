"""dinov2-large's rounding route: the port's weight-streamed halves against
the JAX package's ``_attn_stream_kernel``, ``_mlp_stream_kernel`` and
``_mlp_stream_dx_kernel`` (interpret mode on the CPU), and ``block_route``
against JAX's single-device TPU dispatch.

Width D = 128, 2 heads of 64, S = 57, batch 2, where JAX's streaming plans
exist (as tests/test_stream_kernel.py). The JAX kernels run jitted with
``xla_allow_excess_precision`` off: XLA:CPU otherwise drops the bf16 round
trips that the kernel writes (``x2 + (h2 * ls2).astype(bf16)`` becomes one
rounding), which Mosaic keeps on a TPU; with it off the kernels round where
their source does. Tolerances: f32 to 1e-5 abs/rel (summation order only;
the JAX suite's own f32 tolerance). bf16 within one ulp of the larger
magnitude elementwise, on at most 1e-3 of the elements (measured: 0 for
the attention half, 6.9e-5 for the MLP half: one element, one ulp, a GELU
rounding flip between the two erf implementations); the witness shows that
the resident rounding differs from the same JAX kernels on at least 10% of
the elements (measured ~20-40%), so these bf16 tests see the route. The
whole pose model with the D = 128 preset (``test/vit-tiny`` widened by
``monkeypatch.setitem`` on both packages' ``VIT_PRESETS``) runs its blocks
on the streamed route on both sides (``DINO_POSE_TPU_BLOCK=stream`` for
JAX, ``block_route`` forced for the port): f32 heatmaps and z to 1e-4 abs
(tests/test_torch_model.py's tolerance), bf16 backbone tokens as that
test states, and one f32 LoRA train step's losses to 1e-5 and gradients as
tests/test_torch_train.py holds them.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from dino_pose_tpu.models import registry as jregistry
from dino_pose_tpu.models import vit as jvit
from dino_pose_tpu.nn import layers as jlayers
from dino_pose_tpu.ops import block as jblock
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu.train import state as jstate
from dino_pose_tpu.train import step as jstep
from dino_pose_tpu_torch.io.convert import state_dict_from_jax
from dino_pose_tpu_torch.models import registry as tregistry
from dino_pose_tpu_torch.models import vit as tvit
from dino_pose_tpu_torch.ops import block as tblock
from dino_pose_tpu_torch.train import state as tstate
from dino_pose_tpu_torch.train import step as tstep

D, H, S, B = 128, 2, 57, 2
EPS = 1e-6
NO_EXCESS = {"xla_allow_excess_precision": False}
KERNELS = ("_block_kernel", "_attn_part_kernel", "_mlp_part_kernel", "_attn_stream_kernel",
           "_mlp_stream_kernel", "_mlp_stream_dx_kernel")


def _jit(fn, *args):
    """``fn`` compiled without excess precision, applied to ``args``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)(*args)


def _count_kernels(monkeypatch, names=KERNELS) -> dict:
    """Count the calls of JAX's Pallas kernel bodies ``names`` (one per
    pallas_call traced)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        orig = getattr(jblock, name)

        def counted(*a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(jblock, name, counted)
    return calls


def _ulp_check(got: np.ndarray, want: np.ndarray, max_share: float = 1e-3):
    """bf16: every element within one ulp of the larger magnitude, and at
    most ``max_share`` of them differing. Returns the share that differs."""
    got, want = got.astype(np.float32), want.astype(np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    share = float((got != want).mean())
    assert np.all(np.abs(got - want) <= ulp), f"max {np.max(np.abs(got - want) / ulp):.3g} ulps"
    assert share <= max_share, f"{share:.3g} of the elements differ"
    return share


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.05  # noqa: E731
    p = dict(g1=1 + r(D), b1=r(D), wqkv=r(D, 3 * D), bqkv=r(3 * D), wo=r(D, D), bo=r(D),
             ls1=1 + r(D), g2=1 + r(D), b2=r(D), w1=r(D, 4 * D), bf1=r(4 * D),
             w2=r(4 * D, D), bf2=r(D), ls2=1 + r(D))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    dy = rng.standard_normal((B, S, D)).astype(np.float32)
    return x, dy, p


def _jax_half(name, p):
    if name == "attn":
        return jblock.AttnParams(*(jnp.asarray(p[f]) for f in jblock.AttnParams._fields))
    return jblock.MlpParams(*(jnp.asarray(p[f]) for f in jblock.MlpParams._fields))


def _torch_params(p, dtype):
    return tblock.BlockParams(**{
        k: torch.from_numpy(v).to(dtype if v.ndim == 2 else torch.float32) for k, v in p.items()})


def _jax_stream(name, x, p, dtype):
    """JAX's weight-streamed half (interpret mode) in ``dtype``."""
    half = _jax_half(name, p)
    xj = jnp.asarray(x).astype(dtype)
    if name == "attn":
        out = _jit(lambda a: jblock.fused_attn_part_stream(a, half, H, EPS), xj)
    else:
        out = _jit(lambda a: jblock.fused_mlp_part_stream(a, half, EPS), xj)
    return np.asarray(out.astype(jnp.float32))


def _port(name, x, p, dtype, stream=True, kernel=False):
    tp = _torch_params(p, dtype)
    tx = torch.from_numpy(x).to(dtype)
    ap, mp = tblock.attn_params(tp), tblock.mlp_params(tp)
    if kernel:
        fn = tblock.fused_attn_part_stream if name == "attn" else tblock.fused_mlp_part_stream
        args = (tx, ap, H, EPS) if name == "attn" else (tx, mp, EPS)
        return fn(*args)
    if name == "attn":
        fn = tblock.attn_part_stream_math if stream else tblock.attn_part_math
        return fn(tx, ap, num_heads=H, eps=EPS)
    fn = tblock.mlp_part_stream_math if stream else tblock.mlp_part_math
    return fn(tx, mp, eps=EPS)


@pytest.mark.parametrize("name", ["attn", "mlp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_plain_versions_match_jax_kernels(arrays, name, dtype, monkeypatch):
    x, _, p = arrays
    calls = _count_kernels(monkeypatch)
    want = _jax_stream(name, x, p, jnp.dtype(dtype))
    assert calls["_attn_stream_kernel" if name == "attn" else "_mlp_stream_kernel"] == 1
    got = _port(name, x, p, getattr(torch, dtype)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        _ulp_check(got, want)


@pytest.mark.parametrize("name", ["attn", "mlp"])
def test_resident_rounding_differs_from_stream_kernels(arrays, name):
    """The witness: in bf16 the resident plain versions (``attn_part_math``,
    ``mlp_part_math``) differ from JAX's streamed kernels on >= 10% of the
    elements, so the bf16 test above can tell the two routes apart."""
    x, _, p = arrays
    want = _jax_stream(name, x, p, jnp.bfloat16)
    got = _port(name, x, p, torch.bfloat16, stream=False).float().numpy()
    assert (got != want).mean() >= 0.10


@pytest.mark.parametrize("name", ["attn", "mlp"])
def test_stream_wrappers_on_cpu_are_the_plain_versions(arrays, name):
    x, _, p = arrays
    tblock.reset_launches()
    got = _port(name, x, p, torch.bfloat16, kernel=True)
    assert torch.equal(got, _port(name, x, p, torch.bfloat16))
    assert all(n == 0 for n in tblock.LAUNCHES.values())


def test_mlp_part_frozen_stream_backward_matches_jax(arrays, monkeypatch):
    """dx2 of the LoRA layer's MLP half on the stream route against
    ``jax.vjp`` of ``fused_mlp_part_stream(..., assume_frozen_weights=True)``,
    which runs ``_mlp_stream_dx_kernel`` (interpret mode), in f32."""
    x, dy, p = arrays
    calls = _count_kernels(monkeypatch)
    mp = _jax_half("mlp", p)
    _, vjp = jax.vjp(lambda a: jblock.fused_mlp_part_stream(a, mp, EPS, True), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    assert calls["_mlp_stream_dx_kernel"] == calls["_mlp_stream_kernel"] == 1
    xt = torch.from_numpy(x).requires_grad_()
    tmp = tblock.mlp_params(_torch_params(p, torch.float32))
    y = tblock.mlp_part_frozen(xt, tmp, EPS, route="stream")
    with torch.no_grad():
        assert torch.equal(y, tblock.mlp_part_stream_math(torch.from_numpy(x), tmp, eps=EPS))
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The route against JAX's dispatch
# ---------------------------------------------------------------------------

def _jax_route(cfg, s, lora, training, calls) -> str:
    """The kernels JAX's vit ``Block`` traces on a single TPU (abstractly,
    ``jax.eval_shape``: nothing is lowered or run), as a route."""
    cfg = dataclasses.replace(cfg, lora_layers=(0,) if lora else ())
    blk = jvit.Block(cfg, use_lora=lora, frozen=not training)
    x = jnp.zeros((1, s, cfg.hidden_size), jnp.bfloat16)
    for k in calls:
        calls[k] = 0
    jax.eval_shape(lambda: blk.init(jax.random.key(0), x, deterministic=not training))
    if calls["_attn_stream_kernel"] or calls["_mlp_stream_kernel"]:
        assert calls["_attn_stream_kernel"] == calls["_mlp_stream_kernel"] == 1
        return "stream"
    if calls["_block_kernel"] or calls["_attn_part_kernel"]:
        return "block"
    assert not any(calls.values())
    return "math"


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("s", [257, 1297])
@pytest.mark.parametrize("model", ["facebook/dinov2-small", "facebook/dinov2-base",
                                   "facebook/dinov2-large"])
def test_block_route_matches_jax_dispatch(model, s, lora, training, monkeypatch):
    monkeypatch.setattr(jblock, "_dispatch_target", lambda: ("tpu", 1))
    monkeypatch.delenv("DINO_POSE_TPU_BLOCK", raising=False)
    calls = _count_kernels(monkeypatch)
    cfg = jvit.VIT_PRESETS[model]
    d = cfg.hidden_size
    want = _jax_route(cfg, s, lora, training, calls)
    got = tblock.block_route(d, s, cfg.num_heads, d * cfg.mlp_ratio, 2, lora=lora,
                             training=training)
    assert got == want
    if s == 257 and not training:
        assert got == {384: "block", 768: "block", 1024: "stream"}[d]


def _torch_shape(shape: tuple, kind: str) -> tuple:
    """The torch shape ``io/convert._to_torch`` makes of a JAX variable."""
    if kind == "linear":
        return shape[::-1]
    if kind == "conv":
        return (shape[3], shape[2], shape[0], shape[1])
    if kind == "convT":
        return (shape[2], shape[3], shape[0], shape[1])
    if kind == "scale2d":
        return (int(np.prod(shape)), 1, 1)
    return shape


@pytest.mark.parametrize("model", ["facebook/dinov2-base", "facebook/dinov2-large"])
def test_full_size_schema_and_partition_match_jax(model):
    """dinov2-base and -large + LoRA at their full widths and depths, built
    abstractly on both sides (``jax.eval_shape``, the ``meta`` device): every
    JAX variable maps to a port key of the carried shape (layer keys up to
    ``layer.11`` / ``layer.23``, the heads' D input channels), the LoRA
    adapter sits on the last layer, and the trainable set is the adapter and
    the heads, JAX's ``trainable_mask`` through the rules."""
    from dino_pose_tpu.models.pose import DinoPoseModule as JaxPoseModule
    from dino_pose_tpu.train import partition as jpartition
    from dino_pose_tpu_torch.io.convert import dinov2_pose_rules
    from dino_pose_tpu_torch.models.pose import DinoPoseModule
    from dino_pose_tpu_torch.train.partition import apply_partition

    config = {"model_name": model, "use_lora": True}
    vit = tregistry.vit_config_for(model, config)
    n, d = vit.num_layers, vit.hidden_size
    assert vit.lora_layers == (n - 1,) and (n, d) == {"facebook/dinov2-base": (12, 768),
                                                      "facebook/dinov2-large": (24, 1024)}[model]
    jv = dataclasses.replace(jvit.VIT_PRESETS[model], lora_layers=(n - 1,))
    shapes = jax.eval_shape(JaxPoseModule(vit=jv).init, jax.random.key(0),
                            jnp.zeros((1, 3, 224, 224)))
    flat = traverse_util.flatten_dict(jax.tree.map(lambda a: tuple(a.shape), shapes,
                                                   is_leaf=lambda a: hasattr(a, "shape")))
    with torch.device("meta"):
        tm = DinoPoseModule(vit, 24, 48)
    merged = {**tregistry.BACKBONE_REGISTRY[model].default_config, **config}
    trainable = apply_partition(tm, merged)
    sd = tm.state_dict()
    rules = dinov2_pose_rules(n, (n - 1,), len(tm.pose_heads.heatmap_head.upsampling))
    assert {r.jax_path for r in rules} == set(flat)
    keys = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert {r.torch_key for r in rules} == keys
    for r in rules:
        assert tuple(sd[r.torch_key].shape) == _torch_shape(flat[r.jax_path], r.kind), r
    assert f"backbone.encoder.layer.{n - 1}.attention.lora_output.lora_A" in keys
    assert not any(k.startswith(f"backbone.encoder.layer.{n}.") for k in keys)
    first = tm.pose_heads.heatmap_head.feature_refine[0]
    assert first.weight.shape[1] == d
    jmask = traverse_util.flatten_dict(jpartition.trainable_mask(shapes["params"], merged,
                                                                 "dinov2"))
    want = {r.torch_key for r in rules if r.jax_path[0] == "params" and jmask[r.jax_path[1:]]}
    assert trainable == want
    assert {k for k in want if k.startswith("backbone.")} == {
        f"backbone.encoder.layer.{n - 1}.attention.lora_output.lora_{m}" for m in "AB"}


def _port_block(p):
    """A frozen port ``Block`` of width D holding ``p``."""
    blk = tvit.Block(tvit.ViTConfig(hidden_size=D, num_layers=1, num_heads=H))
    pre = "attention."
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    wq, wk, wv = t["wqkv"].split(D, dim=1)
    bq, bk, bv = t["bqkv"].split(D)
    sd = {"norm1.weight": t["g1"], "norm1.bias": t["b1"], "layer_scale1.lambda1": t["ls1"],
          f"{pre}attention.query.weight": wq.t(), f"{pre}attention.query.bias": bq,
          f"{pre}attention.key.weight": wk.t(), f"{pre}attention.key.bias": bk,
          f"{pre}attention.value.weight": wv.t(), f"{pre}attention.value.bias": bv,
          f"{pre}output.dense.weight": t["wo"].t(), f"{pre}output.dense.bias": t["bo"],
          "norm2.weight": t["g2"], "norm2.bias": t["b2"], "layer_scale2.lambda1": t["ls2"],
          "mlp.fc1.weight": t["w1"].t(), "mlp.fc1.bias": t["bf1"],
          "mlp.fc2.weight": t["w2"].t(), "mlp.fc2.bias": t["bf2"]}
    blk.load_state_dict(sd)
    for w in blk.parameters():
        w.requires_grad_(False)
    return blk


def _jax_block_params(p):
    q, k, v = np.split(p["wqkv"], 3, axis=1)
    bq, bk, bv = np.split(p["bqkv"], 3)
    dense = lambda w, b: {"kernel": w, "bias": b}  # noqa: E731
    return {"params": {
        "norm1": {"scale": p["g1"], "bias": p["b1"]},
        "attention": {"query": dense(q, bq), "key": dense(k, bk), "value": dense(v, bv),
                      "out": dense(p["wo"], p["bo"])},
        "layerscale1": p["ls1"], "norm2": {"scale": p["g2"], "bias": p["b2"]},
        "fc1": dense(p["w1"], p["bf1"]), "fc2": dense(p["w2"], p["bf2"]),
        "layerscale2": p["ls2"]}}


@pytest.mark.parametrize("route", ["parts", "stream"])
def test_frozen_block_matches_jax_route_in_bf16(arrays, route, monkeypatch):
    """A frozen block in bf16 on each route of the bigger backbones:
    ``parts`` (dinov2-base: JAX's resident halves with its XLA stitch, which
    the port's ``fused_block`` (on the CPU ``block_math``) rounds like) and
    ``stream`` (dinov2-large: the streamed halves; the port's Block with its
    route forced), each against JAX's vit ``Block`` with
    ``DINO_POSE_TPU_BLOCK`` set so."""
    x, _, p = arrays
    monkeypatch.setenv("DINO_POSE_TPU_BLOCK", route)
    calls = _count_kernels(monkeypatch)
    cfg = dataclasses.replace(jvit.VIT_PRESETS["test/vit-tiny"], hidden_size=D, num_heads=H)
    blk = jvit.Block(cfg, frozen=True)
    variables = jax.tree.map(jnp.asarray, _jax_block_params(p))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    with jdispatch.local():
        want = _jit(lambda a: blk.apply(variables, a, deterministic=True), xj)
    want = np.asarray(want.astype(jnp.float32))
    if route == "parts":
        assert calls["_attn_part_kernel"] == calls["_mlp_part_kernel"] == 1
    else:
        assert calls["_attn_stream_kernel"] == calls["_mlp_stream_kernel"] == 1
        monkeypatch.setattr(tvit, "block_route", lambda *a, **k: "stream")
    assert calls["_block_kernel"] == 0
    tblock.reset_launches()
    with torch.no_grad():
        got = _port_block(p)(torch.from_numpy(x).to(torch.bfloat16))
    _ulp_check(got.float().numpy(), want)
    assert all(n == 0 for n in tblock.LAUNCHES.values())


# ---------------------------------------------------------------------------
# The whole pose model and a LoRA train step on the streamed route
# ---------------------------------------------------------------------------

CONFIG = {"model_name": "test/vit-tiny", "use_lora": True, "lora_dropout": 0.0}


@pytest.fixture(scope="module")
def wide_models():
    """``test/vit-tiny`` widened to D = 128 (2 heads of 64, 2 layers, LoRA on
    layer 1) in both packages, the JAX variables randomised (LoRA B, the
    LayerScales, the BatchNorm statistics) and carried into the port."""
    with pytest.MonkeyPatch.context() as mp:
        for presets, vit_config in ((jvit.VIT_PRESETS, jvit.ViTConfig),
                                    (tvit.VIT_PRESETS, tvit.ViTConfig)):
            mp.setitem(presets, "test/vit-tiny",
                       vit_config(hidden_size=D, num_layers=2, num_heads=H, pos_grid=37))
        jm = jregistry.create_model_from_config(dict(CONFIG), pretrained=False)
        rng = np.random.default_rng(3)
        variables = jax.device_get(jm.variables)
        flat = traverse_util.flatten_dict(variables)
        for k, v in flat.items():
            if k[-1] == "lora_B":
                flat[k] = rng.standard_normal(v.shape).astype(np.float32) * 0.05
            elif k[-1].startswith("layerscale"):
                flat[k] = rng.uniform(0.1, 1.0, v.shape).astype(np.float32)
            elif k[0] == "batch_stats":
                flat[k] = ((rng.standard_normal(v.shape) * 0.1) if k[-1] == "mean"
                           else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        variables = traverse_util.unflatten_dict(flat)
        tm = tregistry.create_model_from_config(dict(CONFIG), device="cpu")
        tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
        assert tm.vit.hidden_size == D
        yield jm, variables, tm


@pytest.fixture
def stream_route(monkeypatch):
    monkeypatch.setenv("DINO_POSE_TPU_BLOCK", "stream")
    monkeypatch.setattr(tvit, "block_route", lambda *a, **k: "stream")
    return _count_kernels(monkeypatch)


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(4).standard_normal((B, 3, 224, 224)).astype(np.float32)


def test_pose_model_on_the_stream_route_matches_jax_f32(wide_models, pixels, stream_route):
    jm, variables, tm = wide_models
    with jdispatch.local():
        hm_j, z_j = jm.module.apply(variables, jnp.asarray(pixels), train=False)
    assert stream_route["_attn_stream_kernel"] == stream_route["_mlp_stream_kernel"] == 2
    tblock.reset_launches()
    with torch.inference_mode():
        hm_t, z_t = tm(torch.from_numpy(pixels))
    assert hm_t.shape == (B, 24, 48, 48) and z_t.shape == (B, 24)
    np.testing.assert_allclose(hm_t.numpy(), np.asarray(hm_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-4, rtol=0)


def test_backbone_on_the_stream_route_matches_jax_bf16(wide_models, pixels, stream_route,
                                                      monkeypatch):
    """The backbone's tokens (both layers streamed, the LoRA adapter and the
    final LayerNorm) in bf16. Single roundings that flip between the
    frameworks (the patch-embedding conv's summation order, erf) propagate
    through two blocks and the final LayerNorm, so the tokens are held to
    one ulp of their largest magnitude, on at most 12% of the elements
    (measured 6.9%); the port on the resident route differs on 27% and is
    held to at least 20%, the witness that this test sees the route."""
    jm, variables, tm = wide_models
    backbone = jvit.Dinov2Backbone(jm.module.vit)
    params = {"params": variables["params"]["backbone"]}
    xj = jnp.transpose(jnp.asarray(pixels), (0, 2, 3, 1)).astype(jnp.bfloat16)
    with jdispatch.local():
        want = _jit(lambda a: backbone.apply(params, a, deterministic=True)[0], xj)
    want = np.asarray(want.astype(jnp.float32))
    assert stream_route["_attn_stream_kernel"] == stream_route["_mlp_stream_kernel"] == 2
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    shares = {}
    for route in ("stream", "block"):
        monkeypatch.setattr(tvit, "block_route", lambda *a, _r=route, **k: _r)
        with torch.inference_mode():
            got = tm.backbone(torch.from_numpy(pixels).to(torch.bfloat16))[0].float().numpy()
        assert np.abs(got - want).max() <= ulp
        shares[route] = (got != want).mean()
    assert shares["stream"] <= 0.12 and shares["block"] >= 0.20, shares


class _NoDropout:
    def __init__(self, rate=0.0, **kw):
        pass

    def __call__(self, x, deterministic=True):
        return x


def test_lora_train_step_on_the_stream_route_matches_jax(wide_models, pixels, stream_route,
                                                         monkeypatch):
    """One f32 LoRA train step (no dropout) against JAX's, whose LoRA layer
    carries the adapter's cotangent through ``_mlp_stream_dx_kernel``:
    losses to 1e-5, the gradients of the leaves above the heatmap head's
    last ReLU to 1e-4 and of the others (LoRA included) to 1e-2 relative
    Frobenius, as tests/test_torch_train.py holds them (ReLU gates within
    roundoff of zero flip between the frameworks)."""
    jm, variables, tm = wide_models
    rng = np.random.default_rng(5)
    kps = rng.uniform(10, 214, (B, 24, 3)).astype(np.float32)
    kps[..., 2] = 2.0
    batch = {"image": pixels, "2d_keypoints": kps,
             "z_coords": (rng.standard_normal((B, 24)) * 10).astype(np.float32)}
    lr, wd = 3e-5, 1e-6
    monkeypatch.setattr(jlayers, "Dropout", _NoDropout)
    js, tx, part = jstate.create_train_state(variables, CONFIG, "dinov2", weight_decay=wd)
    jfn = jax.jit(jstep._prepare_batch(jstep.make_train_step(jm.module, tx, part), (224, 48)))
    with jdispatch.local():
        js1, jstats = jfn(js, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(lr),
                          jax.random.key(0))
    assert stream_route["_mlp_stream_dx_kernel"] == 1

    tm = copy.deepcopy(tm)  # the step updates the weights
    for m in tm.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    ts, opt, tpart = tstate.create_train_state(tm, CONFIG, weight_decay=wd)
    tfn = tstep.prepare_batch(tstep.make_train_step(tm, opt, tpart), (224, 48))
    tblock.reset_launches()
    _, tstats = tfn(ts, {k: torch.from_numpy(v) for k, v in batch.items()}, lr, 0)
    grads = {n: p.grad.numpy().copy() for n, p in tm.named_parameters() if p.grad is not None}
    for k in jstats:
        np.testing.assert_allclose(tstats[k].item(), float(jstats[k]), rtol=1e-5, err_msg=k)
    mu = js1.opt_state[0].mu
    _, frozen = part.split(js.params)
    jgrads = state_dict_from_jax(
        {"params": part.merge(jax.tree.map(lambda m: np.asarray(m) / (1 - 0.9), mu),
                              jax.tree.map(np.zeros_like, frozen)),
         "batch_stats": variables["batch_stats"]}, tm)
    assert set(grads) == tpart and sum("lora" in n for n in grads) == 2
    for n, g in grads.items():
        w = jgrads[n].numpy()
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        above = n.startswith(("pose_heads.z_head.", "pose_heads.heatmap_head.prediction."))
        if np.linalg.norm(w) < 1e-5 * max(np.abs(v.numpy()).max() for v in jgrads.values()):
            continue  # a true-zero gradient: both sides hold roundoff
        assert rel < (1e-4 if above else 1e-2), f"{n}: relative Frobenius error {rel:.3e}"
