"""The tensor-parallel halves on one device: the port's shard functions and
``attn_part_tp``/``mlp_part_tp`` against the JAX package's
``_attn_part_partial_kernel``, ``_mlp_part_partial_kernel`` and
``_mlp_partial_dx_kernel`` (interpret mode on the CPU) and its
``attn_part_tp``/``mlp_part_tp`` on a ('data', 'model') mesh of virtual CPU
devices (``tests/conftest.py`` makes eight), the splits, ``block_route``
under a mesh against JAX's dispatch, and the tiny LoRA pose model with two
train steps under tp = 2.

Width D = 128, 4 heads of 32, S = 57, batch 2 (as tests/test_block_tp.py),
tp = 2 and 4. JAX runs jitted with ``xla_allow_excess_precision`` off
(tests/test_torch_stream.py's reason: XLA:CPU otherwise drops the kernels'
bf16 round trips). Tolerances: f32 to 1e-5 abs/rel (summation order only);
bf16 within one ulp of the larger magnitude elementwise, on at most 1e-3 of
the elements, for the halves (which add a bias, and x2's cotangent its
residual); a shard's partial output adds neither, and an element near zero
that sums terms of the tensor's scale moves by many of its own ulps when
one input rounds the other way between the frameworks (an exp or erf of
XLA's against torch's): partials are held to one ulp of the tensor's
largest magnitude, on at most 1e-2 of the elements (measured: at most half
that ulp, on at most 0.21% of the elements). XLA's all-reduce of
bf16 partials on the CPU sums them in f32 and rounds once, for the forward
psum and for the transpose of the replicated x2 (measured: the port's
all-reduce with one rounding agrees with it on every element at tp = 4,
where a bf16 sum in rank order differs on 13%), and ``core/mesh.py`` does
the same. The pose model in f32 as tests/test_torch_model.py (1e-4) and the
two LoRA steps as tests/test_torch_train.py holds them.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from dino_pose_tpu.core import mesh as jmesh
from dino_pose_tpu.models import vit as jvit
from dino_pose_tpu.models.pose import DinoPoseModule as JaxPoseModule
from dino_pose_tpu.nn import layers as jlayers
from dino_pose_tpu.ops import block as jblock
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu_torch.core.mesh import MeshSpec, create_mesh
from dino_pose_tpu_torch.ops import block as tblock
from dino_pose_tpu_torch.ops import dispatch as tdispatch
from test_torch_stream import _count_kernels, _jit, _ulp_check
from test_torch_train import CONFIG, _NoDropout, _port_model, _randomise, _two_steps_match_jax

D, H, S, B = 128, 4, 57, 2
EPS = 1e-6
PARTIAL = ("_attn_part_partial_kernel", "_mlp_part_partial_kernel", "_mlp_partial_dx_kernel",
           "_attn_part_kernel", "_mlp_part_kernel", "_block_kernel", "_mlp_dx_kernel",
           "_attn_stream_kernel", "_mlp_stream_kernel")


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(3)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.05  # noqa: E731
    p = dict(g1=1 + r(D), b1=r(D), wqkv=r(D, 3 * D), bqkv=r(3 * D), wo=r(D, D), bo=r(D),
             ls1=1 + r(D), g2=1 + r(D), b2=r(D), w1=r(D, 4 * D), bf1=r(4 * D),
             w2=r(4 * D, D), bf2=r(D), ls2=1 + r(D))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    ct = rng.standard_normal((B, S, D)).astype(np.float32)
    return x, ct, p


def _halves(p, dtype):
    """The port's (AttnParams, MlpParams): matrices in ``dtype``, vectors f32."""
    t = {k: torch.from_numpy(v).to(dtype if v.ndim == 2 else torch.float32)
         for k, v in p.items()}
    return (tblock.AttnParams(*(t[f] for f in tblock.AttnParams._fields)),
            tblock.MlpParams(*(t[f] for f in tblock.MlpParams._fields)))


def _jax_halves(p):
    return (jblock.AttnParams(*(jnp.asarray(p[f]) for f in jblock.AttnParams._fields)),
            jblock.MlpParams(*(jnp.asarray(p[f]) for f in jblock.MlpParams._fields)))


def _to_jax(pp):
    """A port shard's parameters as JAX's partial params (f32 arrays)."""
    cls = jblock.AttnPartialParams if isinstance(pp, tblock.AttnPartialParams) \
        else jblock.MlpPartialParams
    return cls(*(jnp.asarray(t.float().numpy()) for t in pp))


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.detach().float().numpy()


def _close(got, want, dtype, partial=False):
    """f32 to 1e-5; bf16 by ``_ulp_check`` or, for a shard's ``partial``
    output, within one ulp of the tensor's largest magnitude on at most 1e-2
    of the elements."""
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    elif partial:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp
        assert (got != want).mean() <= 1e-2
    else:
        _ulp_check(got, want)


@contextlib.contextmanager
def _meshes(tp: int):
    """JAX's mesh of ``tp`` virtual CPU devices and the port's of ``tp``
    shards on the CPU, each the target of its package inside the block."""
    with jdispatch.scoped(), tdispatch.scoped():
        jm = jmesh.create_mesh(jmesh.MeshSpec(dp=1, tp=tp), devices=jax.devices()[:tp])
        yield jm, create_mesh(MeshSpec(1, tp), device="cpu")


# ---------------------------------------------------------------------------
# One shard: the three plain versions against JAX's partial kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["attn", "mlp"])
def test_partial_plain_versions_match_jax_kernels(arrays, name, tp, dtype, monkeypatch):
    x, _, p = arrays
    calls = _count_kernels(monkeypatch, PARTIAL)
    ap, mp = _halves(p, getattr(torch, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(dtype)
    for r in range(tp):
        if name == "attn":
            pp = tblock.shard_attn(ap, tp, r)
            want = _jit(lambda a, q: jblock.fused_attn_part_partial(a, q, H // tp, EPS), xj,
                        _to_jax(pp))
            got = tblock.attn_part_math_partial(tx, pp, num_heads=H // tp, eps=EPS)
        else:
            pp = tblock.shard_mlp(mp, tp, r)
            want = _jit(lambda a, q: jblock.fused_mlp_part_partial(a, q, EPS), xj, _to_jax(pp))
            got = tblock.mlp_part_math_partial(tx, pp, eps=EPS)
        assert got.shape == (B, S, D) and got.dtype == tx.dtype
        _close(got, want, dtype, partial=True)
    kernel = "_attn_part_partial_kernel" if name == "attn" else "_mlp_part_partial_kernel"
    assert calls[kernel] == tp and sum(calls.values()) == tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [2, 4])
def test_mlp_partial_dx_matches_jax_vjp(arrays, tp, dtype, monkeypatch):
    """``mlp_partial_dx_math`` against ``jax.vjp`` of
    ``fused_mlp_part_partial(..., assume_frozen_weights=True)``, which runs
    ``_mlp_partial_dx_kernel`` (D = 128 fits ``_mlp_dx_fits``); the weights'
    cotangents are zero there, ``mlp_part_partial_frozen`` gives the same
    dx2, and it refuses a shard weight that requires grad."""
    x, ct, p = arrays
    calls = _count_kernels(monkeypatch, PARTIAL)
    _, mp = _halves(p, getattr(torch, dtype))
    tx, tct = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, ct))
    for r in range(tp):
        pp = tblock.shard_mlp(mp, tp, r)

        def vjp(a, c, q):
            _, f = jax.vjp(lambda a_, q_: jblock.fused_mlp_part_partial(a_, q_, EPS, True), a, q)
            return f(c)

        dx_j, dpp_j = _jit(vjp, jnp.asarray(x).astype(dtype), jnp.asarray(ct).astype(dtype),
                           _to_jax(pp))
        assert all(float(jnp.abs(g).max()) == 0.0 for g in dpp_j)
        got = tblock.mlp_partial_dx_math(tx, tct, pp, eps=EPS)
        _close(got, dx_j, dtype, partial=True)
        xg = tx.clone().requires_grad_()
        tblock.mlp_part_partial_frozen(xg, pp, EPS).backward(tct)
        assert torch.equal(xg.grad, got)
        with pytest.raises(ValueError, match="requires grad"):
            tblock.mlp_part_partial_frozen(xg, pp._replace(w1=pp.w1.clone().requires_grad_()),
                                           EPS)
    assert calls["_mlp_partial_dx_kernel"] == tp and calls["_mlp_part_partial_kernel"] == tp


def test_partial_wrappers_on_cpu_are_the_plain_versions(arrays):
    x, ct, p = arrays
    ap, mp = _halves(p, torch.bfloat16)
    tx, tct = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, ct))
    pa, pm = tblock.shard_attn(ap, 2, 1), tblock.shard_mlp(mp, 2, 1)
    tblock.reset_launches()
    assert torch.equal(tblock.fused_attn_part_partial(tx, pa, H // 2, EPS),
                       tblock.attn_part_math_partial(tx, pa, num_heads=H // 2, eps=EPS))
    assert torch.equal(tblock.fused_mlp_part_partial(tx, pm, EPS),
                       tblock.mlp_part_math_partial(tx, pm, eps=EPS))
    assert torch.equal(tblock.fused_mlp_partial_dx(tx, tct, pm, EPS),
                       tblock.mlp_partial_dx_math(tx, tct, pm, eps=EPS))
    assert all(n == 0 for n in tblock.LAUNCHES.values())
    with pytest.raises(ValueError, match="no backward"):
        tblock.fused_attn_part_partial(tx.clone().requires_grad_(), pa, H // 2, EPS)


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_match_jax_splits(arrays, tp):
    """``shard_attn``/``shard_mlp`` against the slices JAX's shard_map hands
    each shard under ``attn_part_tp``'s and ``mlp_part_tp``'s in_specs."""
    _, _, p = arrays
    ap_j, mp_j = _jax_halves(p)
    ap, mp = _halves(p, torch.float32)
    with _meshes(tp) as (jm, _):
        wq, wk, wv = jnp.split(ap_j.wqkv, 3, axis=1)
        bq, bk, bv = jnp.split(ap_j.bqkv, 3)

        def local(wq_l, wk_l, wv_l, bq_l, bk_l, bv_l, wo_l, w1_l, bf1_l, w2_l):
            return tuple(t[None] for t in (
                jnp.concatenate([wq_l, wk_l, wv_l], axis=1), jnp.concatenate([bq_l, bk_l, bv_l]),
                wo_l, w1_l, bf1_l, w2_l))

        cols, rows, vec = P(None, "model"), P("model", None), P("model")
        out = shard_map(local, mesh=jm,
                        in_specs=(cols, cols, cols, vec, vec, vec, rows, cols, vec, rows),
                        out_specs=P("model"), check_rep=False)(
            wq, wk, wv, bq, bk, bv, ap_j.wo, mp_j.w1, mp_j.bf1, mp_j.w2)
    for r in range(tp):
        pa, pm = tblock.shard_attn(ap, tp, r), tblock.shard_mlp(mp, tp, r)
        for got, want in zip((pa.wqkv, pa.bqkv, pa.wo, pm.w1, pm.bf1, pm.w2), out):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[r]))
        assert pa.g1 is ap.g1 and pm.b2 is mp.b2


# ---------------------------------------------------------------------------
# The halves over a mesh against JAX's attn_part_tp / mlp_part_tp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_halves_match_jax_on_a_mesh(arrays, tp, dtype, monkeypatch):
    """Values of both halves and, in bf16, x2's cotangent through
    ``mlp_part_tp`` (the shards' dx2 summed by the mesh, plus the
    residual's) against ``jax.vjp`` on JAX's CPU mesh."""
    x, ct, p = arrays
    calls = _count_kernels(monkeypatch, PARTIAL)
    ap_j, mp_j = _jax_halves(p)
    ap, mp = _halves(p, getattr(torch, dtype))
    tx, tct = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, ct))
    xj, cj = (jnp.asarray(a).astype(dtype) for a in (x, ct))
    with _meshes(tp) as (jm, tm):
        o_j = _jit(lambda a: jblock.attn_part_tp(a, ap_j, H, EPS, jm), xj)
        y_j = _jit(lambda a: jblock.mlp_part_tp(a, mp_j, EPS, True, jm), xj)
        dx_j = _jit(lambda a, c: jax.vjp(
            lambda a_: jblock.mlp_part_tp(a_, mp_j, EPS, True, jm), a)[1](c)[0], xj, cj)
        o = tblock.attn_part_tp(tx, ap, H, EPS, tm)
        xg = tx.clone().requires_grad_()
        y = tblock.mlp_part_tp(xg, mp, EPS, tm)
        y.backward(tct)
    # The shard_map body traces once a half: the MLP half's in y_j and in the vjp.
    assert calls["_attn_part_partial_kernel"] == calls["_mlp_partial_dx_kernel"] == 1
    assert calls["_mlp_part_partial_kernel"] == 2
    # o's small bias and x2's cotangent, a sum of the shards' partial dx2,
    # carry the partials' elementwise flips (measured: a quarter of the
    # tensor-scale ulp on 0.1% of dx2's elements); y has none.
    _close(o, o_j, dtype, partial=True)
    _close(y, y_j, dtype)
    _close(xg.grad, dx_j, dtype, partial=True)


def test_mlp_part_tp_frozen_adapter_gradient(arrays):
    """tests/test_block_tp.py's LoRA contract in the port, against JAX's: an
    upstream adapter scale's gradient flows through x2 and every shard's
    dx2, and the external bf2 and ls2 get their exact gradients (f32, 1e-5).
    JAX gives the MLP weights inside the shards zero cotangents; the port
    refuses such weights when they require grad (``mlp_part_frozen``'s
    contract: the frozen-weight backward gives them no gradient)."""
    x, _, p = arrays
    ap_j, mp_j = _jax_halves(p)
    with _meshes(2) as (jm, tm):
        def loss_j(a, mp_):
            return jnp.sum(jnp.square(jblock.mlp_part_tp(jnp.asarray(x) * a, mp_, EPS, True, jm)))

        ga_j, gmp_j = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(jnp.float32(1.0), mp_j)
        a = torch.tensor(1.0, requires_grad=True)
        mp = tblock.MlpParams(*(torch.from_numpy(p[f]).requires_grad_(f in ("bf2", "ls2"))
                                for f in tblock.MlpParams._fields))
        loss = tblock.mlp_part_tp(torch.from_numpy(x) * a, mp, EPS, tm).square().sum()
        loss.backward()
        trainable = mp._replace(w2=mp.w2.detach().requires_grad_())
        with pytest.raises(ValueError, match="requires grad"):
            tblock.mlp_part_tp(torch.from_numpy(x) * a, trainable, EPS, tm)
    np.testing.assert_allclose(a.grad.item(), float(ga_j), rtol=1e-5)
    for f in tblock.MlpParams._fields:
        want = np.asarray(getattr(gmp_j, f))
        if f in ("bf2", "ls2"):
            np.testing.assert_allclose(getattr(mp, f).grad.numpy(), want, atol=1e-5, rtol=1e-5,
                                       err_msg=f)
        else:
            assert not want.any() and getattr(mp, f).grad is None, f


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_dx_where_jax_takes_its_unfused_vjp(dtype, monkeypatch):
    """dinov2-large at tp = 2 (D = 1024, a shard's MLP 2048 wide), S = 257:
    JAX's ``_mlp_dx_fits`` turns the shard's resident dx kernel down (18.66
    MB of its 15 MiB) and ``fused_mlp_part_partial(..., True)`` takes the
    exact unfused vjp of the partial math; the port keeps its
    ``fused_mlp_partial_dx`` chain there (its plain version on the CPU). f32
    agrees to 1e-5 abs/rel; in bf16 the rounding points differ (the chain
    keeps gelu'(h1)·(W2_l^T dp) and the LayerNorm backward in f32, the vjp
    rounds after each op): every element within one ulp of the tensor's
    largest magnitude and the relative Frobenius distance under 1e-2
    (measured: 64% of the elements differ, by at most that ulp, at 4.6e-3)."""
    d, hidden, s, tp = 1024, 4096, 257, 2
    calls = _count_kernels(monkeypatch, PARTIAL)
    rng = np.random.default_rng(31)
    r = lambda *sh: rng.standard_normal(sh).astype(np.float32) * 0.05  # noqa: E731
    p = dict(g2=1 + r(d), b2=r(d), w1=r(d, hidden), bf1=r(hidden), w2=r(hidden, d),
             bf2=r(d), ls2=1 + r(d))
    x, ct = (rng.standard_normal((1, s, d)).astype(np.float32) for _ in range(2))
    td = getattr(torch, dtype)
    mp = tblock.MlpParams(*(torch.from_numpy(p[f]).to(td if p[f].ndim == 2 else torch.float32)
                            for f in tblock.MlpParams._fields))
    tx, tct = (torch.from_numpy(a).to(td) for a in (x, ct))
    for rank in range(tp):
        pp = tblock.shard_mlp(mp, tp, rank)

        def vjp(a, c, q):
            _, f = jax.vjp(lambda a_, q_: jblock.fused_mlp_part_partial(a_, q_, EPS, True), a, q)
            return f(c)[0]

        want = _np(_jit(vjp, jnp.asarray(x).astype(dtype), jnp.asarray(ct).astype(dtype),
                        _to_jax(pp)))
        xg = tx.clone().requires_grad_()
        tblock.mlp_part_partial_frozen(xg, pp, EPS).backward(tct)
        got = _np(xg.grad)
        assert np.array_equal(got, _np(tblock.mlp_partial_dx_math(tx, tct, pp, eps=EPS)))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
            assert np.abs(got - want).max() <= ulp
            assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-2
    assert calls["_mlp_partial_dx_kernel"] == 0


def test_mesh_refuses_a_data_axis_and_restores_its_target():
    with tdispatch.scoped():
        mesh = create_mesh(MeshSpec(1, 2), device="cpu")
        assert tdispatch.target_mesh() is mesh and mesh.tp == 2
        assert repr(mesh) == "Mesh(data=1, model=2)"
        with tdispatch.local():
            assert tdispatch.target_mesh() is None
        assert tdispatch.target_mesh() is mesh
        with pytest.raises(ValueError, match="dp must be 1"):
            create_mesh(MeshSpec(2, 2), device="cpu")
    assert tdispatch.target_mesh() is None


# ---------------------------------------------------------------------------
# The route under a mesh against JAX's dispatch
# ---------------------------------------------------------------------------

def _jax_tp_route(cfg, s, lora, training, tp, calls) -> tuple[str, bool | None]:
    """What JAX's vit ``Block`` traces under a ('data', 'model') = (1, tp)
    mesh on a TPU target (abstractly: nothing is lowered or run): the route,
    and for a LoRA block whether its backward runs ``_mlp_partial_dx_kernel``."""
    cfg = dataclasses.replace(cfg, lora_layers=(0,) if lora else ())
    blk = jvit.Block(cfg, use_lora=lora, frozen=not training)
    x = jnp.zeros((1, s, cfg.hidden_size), jnp.bfloat16)
    for k in calls:
        calls[k] = 0

    def run():
        variables = blk.init(jax.random.key(0), x, deterministic=not training)
        if not lora:
            return variables
        y, vjp = jax.vjp(lambda a: blk.apply(variables, a, deterministic=True), x)
        return vjp(y)

    jax.eval_shape(run)
    if calls["_attn_part_partial_kernel"]:
        assert calls["_mlp_part_partial_kernel"] >= 1
        return "tp", (calls["_mlp_partial_dx_kernel"] > 0) if lora else None
    assert not any(calls.values()), calls
    return "math", None


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("s", [257, 1297])
@pytest.mark.parametrize("model", ["facebook/dinov2-small", "facebook/dinov2-base",
                                   "facebook/dinov2-large"])
def test_block_route_under_a_mesh_matches_jax_dispatch(model, s, tp, monkeypatch):
    """``block_route(..., tp=)`` against the kernels JAX's ``Block`` traces
    for a frozen block, a LoRA block (with its backward) and, at tp = 2, a
    block that trains; at 224²: every width on the TP halves where its heads
    divide (not dinov2-small at tp = 4), and JAX's LoRA backward on its
    ``_mlp_partial_dx_kernel`` for all but dinov2-large at tp = 2, where its
    ``_mlp_dx_fits`` sends it to the unfused vjp (the port keeps its dx
    chain: ``test_partial_dx_where_jax_takes_its_unfused_vjp``)."""
    monkeypatch.delenv("DINO_POSE_TPU_BLOCK", raising=False)
    calls = _count_kernels(monkeypatch, PARTIAL)
    cfg = jvit.VIT_PRESETS[model]
    d, heads, hidden = cfg.hidden_size, cfg.num_heads, cfg.hidden_size * cfg.mlp_ratio
    cases = [(False, False), (True, False)] + ([(False, True)] if tp == 2 else [])
    with jdispatch.scoped():
        jmesh.create_mesh(jmesh.MeshSpec(dp=1, tp=tp), devices=jax.devices()[:tp])
        monkeypatch.setattr(jblock, "_dispatch_target", lambda: ("tpu", tp))
        for lora, training in cases:
            want, dx = _jax_tp_route(cfg, s, lora, training, tp, calls)
            got = tblock.block_route(d, s, heads, hidden, 2, lora=lora, training=training, tp=tp)
            assert got == want, (lora, training)
            if dx is not None:
                assert dx == (s == 257 and not (d == 1024 and tp == 2)), (lora, dx)
    if s == 257:  # dinov2-small's 6 heads do not divide over 4 shards
        assert tblock.block_route(d, s, heads, hidden, 2, lora=True, training=False,
                                  tp=tp) == ("math" if heads % tp else "tp")


# ---------------------------------------------------------------------------
# The whole slice: test/vit-tiny + LoRA under tp = 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pose_tp():
    vit = dataclasses.replace(jvit.VIT_PRESETS["test/vit-tiny"], lora_layers=(1,),
                              lora_dropout=0.0)
    module = JaxPoseModule(vit=vit, num_keypoints=24, heatmap_size=48)
    variables = jax.jit(module.init)(jax.random.key(0), jnp.zeros((1, 3, 224, 224)))
    return module, _randomise(jax.device_get(variables), np.random.default_rng(11))


@pytest.fixture
def tp_route(monkeypatch):
    """Both packages under a tp = 2 mesh; JAX's halves forced onto its TP
    route on the CPU (``DINO_POSE_TPU_BLOCK=parts``, its own test hook, as
    tests/test_block_tp.py), its ``dispatch.local`` kept from dropping the
    mesh inside the shared train-step helper."""
    monkeypatch.setenv("DINO_POSE_TPU_BLOCK", "parts")
    monkeypatch.setattr(jdispatch, "local", contextlib.nullcontext)
    calls = _count_kernels(monkeypatch, PARTIAL)
    with _meshes(2):
        yield calls


def test_pose_model_under_tp2_matches_jax(jax_pose_tp, tp_route):
    """Every block of the tiny pose model on the TP halves on both sides
    (JAX: one trace of each shard kernel a layer; the port: the route
    ``"tp"``), heatmaps and z in f32 to 1e-4 abs."""
    module, variables = jax_pose_tp
    pixels = np.random.default_rng(12).standard_normal((B, 3, 224, 224)).astype(np.float32)
    hm_j, z_j = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables,
                                                                       jnp.asarray(pixels))
    assert tp_route["_attn_part_partial_kernel"] == tp_route["_mlp_part_partial_kernel"] == 2
    assert tp_route["_block_kernel"] == tp_route["_attn_part_kernel"] == 0
    tm = _port_model(variables)
    assert tblock.block_route(64, 257, 2, 256, 4, lora=True, training=False, tp=2) == "tp"
    with torch.inference_mode():
        hm, z = tm(torch.from_numpy(pixels))
    np.testing.assert_allclose(hm.numpy(), np.asarray(hm_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=1e-4, rtol=0)


def test_lora_train_steps_under_tp2_match_jax(jax_pose_tp, tp_route, monkeypatch):
    """Two LoRA train steps under tp = 2 against JAX's, whose LoRA layer
    carries the adapter's cotangent through ``_mlp_partial_dx_kernel`` on
    each shard: losses, step-1 gradients, parameters and BatchNorm
    statistics as tests/test_torch_train.py holds its LoRA steps."""
    module, variables = jax_pose_tp
    monkeypatch.setattr(jlayers, "Dropout", _NoDropout)
    rng = np.random.default_rng(13)
    kps = rng.uniform(10, 214, (B, 24, 3)).astype(np.float32)
    kps[..., 2] = 2.0
    batch = {"image": rng.standard_normal((B, 3, 224, 224)).astype(np.float32),
             "2d_keypoints": kps,
             "z_coords": (rng.standard_normal((B, 24)) * 10).astype(np.float32)}
    grads = _two_steps_match_jax(module, variables, CONFIG, batch)
    assert tp_route["_mlp_partial_dx_kernel"] >= 1
    lora = [n for n in grads if "lora" in n]
    assert len(lora) == 2 and all(np.abs(grads[n]).max() > 0 for n in lora)
