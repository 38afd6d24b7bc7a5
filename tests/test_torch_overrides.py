"""The JAX package's route overrides, read by the port as JAX reads them.

``DINO_POSE_TPU_BLOCK`` moves a dinov2 block's rounding route:
``ops/block.block_route`` is held against JAX's three gates
(``fused_blocks_enabled``, ``parts_fused_enabled``, ``stream_fused_enabled``)
composed as its vit ``Block`` composes them (models/vit.py:276-342; a LoRA
block :177-193 and :373-395) on a single TPU (``_dispatch_target``
patched), for dinov2-small, -base and -large at S = 257 and 1297, every
override value and each of the lora/training flags; where an override
moves a route, also against the kernels JAX's ``Block`` traces; and under a
tp = 2 mesh at dinov2-base's widths.

``DINO_POSE_TPU_ATTENTION`` and ``DINO_POSE_TPU_CONVFFN`` move no rounding
point in the port: its attention and ConvFFN round as JAX's XLA branches and
its kernels do, so the port's output equals JAX's under every value (the
attention here; the ConvFFN in tests/test_torch_fastvit.py's
``test_pose_model_matches_jax``, one case per value).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import _count_kernels, _jax_route
from test_torch_tp import PARTIAL

from dino_pose_tpu.core import mesh as jmesh
from dino_pose_tpu.models import vit as jvit
from dino_pose_tpu.ops import block as jblock
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu_torch.ops import attention as tattention
from dino_pose_tpu_torch.ops import block as tblock

jattention = importlib.import_module("dino_pose_tpu.ops.attention")

MODELS = ["facebook/dinov2-small", "facebook/dinov2-base", "facebook/dinov2-large"]
OVERRIDES = ["", "fused", "pallas", "unfused", "xla", "stream", "parts"]
FLAGS = [(False, False), (True, False), (False, True)]  # (lora, training)


def _jax_gates_route(d: int, s: int, heads: int, hidden: int, lora: bool,
                     training: bool) -> str:
    """JAX's gates as its vit ``Block`` composes them, as a route."""
    fused = jblock.fused_blocks_enabled(d, s, 2, mlp_hidden=hidden)
    parts = jblock.parts_fused_enabled(d, s, 2, heads, mlp_hidden=hidden)
    if training and not lora:  # hidden_dropout is 0 in the dinov2 presets
        if fused:
            return "block"  # dispatch_block_train
        stream = jblock.stream_fused_enabled(d, s, 2, heads, mlp_hidden=hidden,
                                             for_training=True)
        return "stream" if stream else "math"
    if fused or parts:
        return "block"  # the whole block, or the resident halves
    stream = jblock.stream_fused_enabled(d, s, 2, heads, mlp_hidden=hidden)
    return "stream" if stream else "math"


def _set(monkeypatch, override: str) -> None:
    if override:
        monkeypatch.setenv("DINO_POSE_TPU_BLOCK", override)
    else:
        monkeypatch.delenv("DINO_POSE_TPU_BLOCK", raising=False)


@pytest.mark.parametrize("override", OVERRIDES, ids=lambda o: o or "unset")
@pytest.mark.parametrize("s", [257, 1297])
@pytest.mark.parametrize("model", MODELS)
def test_block_route_follows_jax_gates_under_override(model, s, override, monkeypatch):
    monkeypatch.setattr(jblock, "_dispatch_target", lambda: ("tpu", 1))
    _set(monkeypatch, override)
    cfg = jvit.VIT_PRESETS[model]
    d, heads, hidden = cfg.hidden_size, cfg.num_heads, cfg.hidden_size * cfg.mlp_ratio
    for lora, training in FLAGS:
        want = _jax_gates_route(d, s, heads, hidden, lora, training)
        got = tblock.block_route(d, s, heads, hidden, 2, lora=lora, training=training)
        assert got == want, (lora, training)
    if override in ("unfused", "xla"):
        assert want == "math"
    if override in ("fused", "pallas"):
        assert want == "block"


@pytest.mark.parametrize("override", ["fused", "unfused"])
@pytest.mark.parametrize("model", MODELS)
def test_block_route_under_override_matches_traced_block(model, override, monkeypatch):
    """The two overrides that move a route at 224² (``unfused`` puts
    dinov2-large on the resident rounding, ``fused`` takes every width to
    the whole block) against the kernels JAX's ``Block`` traces."""
    monkeypatch.setattr(jblock, "_dispatch_target", lambda: ("tpu", 1))
    _set(monkeypatch, override)
    calls = _count_kernels(monkeypatch)
    cfg = jvit.VIT_PRESETS[model]
    d = cfg.hidden_size
    for lora, training in FLAGS:
        want = _jax_route(cfg, 257, lora, training, calls)
        got = tblock.block_route(d, 257, cfg.num_heads, d * cfg.mlp_ratio, 2, lora=lora,
                                 training=training)
        assert got == want, (lora, training)
    if override == "unfused":
        assert got == "math"


def _jax_mesh_route(cfg, lora: bool, training: bool, calls: dict) -> str:
    """The kernels JAX's ``Block`` traces at 224² under the current mesh
    (abstractly), as a route: the whole block, the TP halves or none."""
    cfg = dataclasses.replace(cfg, lora_layers=(0,) if lora else ())
    blk = jvit.Block(cfg, use_lora=lora, frozen=not training)
    x = jnp.zeros((1, 257, cfg.hidden_size), jnp.bfloat16)
    for k in calls:
        calls[k] = 0
    jax.eval_shape(lambda: blk.init(jax.random.key(0), x, deterministic=not training))
    if calls["_block_kernel"]:
        return "block"
    if calls["_attn_part_partial_kernel"]:
        assert calls["_mlp_part_partial_kernel"] >= 1
        return "tp"
    assert not any(calls.values()), calls
    return "math"


@pytest.mark.parametrize("override", OVERRIDES, ids=lambda o: o or "unset")
def test_block_route_under_a_mesh_and_override_matches_traced_block(override, monkeypatch):
    """dinov2-base at 224² under a tp = 2 mesh: the kernels JAX's ``Block``
    traces for a frozen, a LoRA and a trainable block, under every value."""
    _set(monkeypatch, override)
    calls = _count_kernels(monkeypatch, ("_block_kernel", *PARTIAL))
    cfg = jvit.VIT_PRESETS["facebook/dinov2-base"]
    d, heads, hidden = cfg.hidden_size, cfg.num_heads, cfg.hidden_size * cfg.mlp_ratio
    with jdispatch.scoped():
        jmesh.create_mesh(jmesh.MeshSpec(dp=1, tp=2), devices=jax.devices()[:2])
        monkeypatch.setattr(jblock, "_dispatch_target", lambda: ("tpu", 2))
        for lora, training in FLAGS:
            want = _jax_mesh_route(cfg, lora, training, calls)
            got = tblock.block_route(d, 257, heads, hidden, 2, lora=lora, training=training,
                                     tp=2)
            assert got == want, (lora, training)


# ---------------------------------------------------------------------------
# The attention override moves no rounding point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("value", ["", "xla", "pallas"], ids=lambda v: v or "unset")
def test_attention_override_moves_no_rounding_point(value, dtype, monkeypatch):
    """JAX's ``attention()`` under ``DINO_POSE_TPU_ATTENTION`` (its XLA
    softmax attention, or its flash kernel in interpret mode) against the
    port's ``attention()``, which reads no such switch: f32 to 1e-5, bf16
    within one bf16 ulp of values up to 4 (2e-2; both round P to bf16
    before P V, in another summation order; tests/test_torch_attention.py)."""
    if value:
        monkeypatch.setenv("DINO_POSE_TPU_ATTENTION", value)
    else:
        monkeypatch.delenv("DINO_POSE_TPU_ATTENTION", raising=False)
    rng = np.random.default_rng(len(value) + len(dtype))
    q, k, v = (rng.standard_normal((2, 3, 100, 32)).astype(np.float32) for _ in range(3))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jdispatch.local():
        want = np.asarray(jattention.attention(*(jnp.asarray(t, jdt) for t in (q, k, v)),
                                               32**-0.5).astype(jnp.float32))
    got = tattention.attention(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
                               32**-0.5).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
