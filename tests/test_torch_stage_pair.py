"""FastViT's two opt-in kernel arms in the port against the JAX package's, on
the CPU: the stage-pair arm (``DINO_POSE_TPU_STAGE_PAIR``) and the
depthwise-conv arm (``DINO_POSE_TPU_DWCONV``), both forced on both sides.

``test/fastvit-tiny`` with LoRA rank 4 (dropout off), its JAX variables drawn
as tests/test_torch_fastvit_train.py draws them (``jax_model``) and carried
into the port through ``io/convert.state_dict_from_jax``. JAX runs its
Pallas kernels in interpret mode (``DINO_POSE_TPU_CONVFFN=force`` as well,
so that its ConvFFNs outside the pair take theirs). With both arms forced the
three RepMixer blocks (stages 0-2) run as the pair on both sides (JAX's
``_combine_dw_fwd_kernel``, ``_convffn_fwd_res_kernel`` and, in a backward,
``_combine_dw_bwd_kernel``; the port's ``fused_combine_dw``,
``fused_convffn_res``, ``fused_combine_dw_bwd``), and every stride-1
depthwise conv outside it (the mixers' 3x3 branches, the attention block's
ConvFFN 7x7) takes the conv arm (``_dw_kernel``; ``fused_dw_conv``). The
port's wrapper calls are counted (on the CPU each runs its plain version).

Tolerances, f32, are tests/test_torch_fastvit_train.py's: the train-mode
backbone's feature map to 1e-5 of its largest magnitude, every running
statistic to 1e-5 relative, the backbone's LoRA gradients to 1e-5 relative
Frobenius; two LoRA train steps at 256² at its ``GATED`` tolerances (the
heads' ReLU gates); the eval pose model with the conv arm forced as
tests/test_torch_fastvit.py holds it (feature map 1e-5, heatmaps and z
1e-4).

The bf16 witness: one pair block in bf16, JAX's pair output against the
port's pair output and against the port's reuse route (the pair arm unset):
the pair route rounds differently (LayerScale folded into w2 before the
cast, the residual added last in bf16, x2 rounded before the conv), so a
port that ignored the gate would be held to the wrong rounding.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_fastvit_train import (
    CONFIG,
    GATED,
    _assert_stats_match,
    _nhwc,
    _route,
    _stats_with,
    _sub,
    _to_port,
    batch,
    jax_model,
)
from test_torch_train import _NoDropout, _port_model, _t, _two_steps_match_jax

from dino_pose_tpu.models import fastvit as jfastvit
from dino_pose_tpu.nn import layers as jlayers
from dino_pose_tpu.ops import convffn as jconvffn
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu.ops import dwconv as jdwconv
from dino_pose_tpu_torch.io.convert import state_dict_from_jax
from dino_pose_tpu_torch.ops import convffn as tconvffn
from dino_pose_tpu_torch.ops import dwconv as tdwconv

__all__ = ["batch", "jax_model"]  # fixtures

ARMS = {"DINO_POSE_TPU_STAGE_PAIR": "force", "DINO_POSE_TPU_DWCONV": "force"}
JAX_KERNELS = ("_dw_kernel", "_combine_dw_fwd_kernel", "_combine_dw_bwd_kernel")
PORT_WRAPPERS = ("fused_dw_conv", "fused_combine_dw", "fused_combine_dw_bwd")


def _arms(monkeypatch, pair: bool = True) -> tuple[dict, dict]:
    """Force both arms (the pair only if ``pair``) and JAX's ConvFFN kernels;
    count JAX's Pallas kernel bodies and the port's wrapper calls."""
    for env, mode in ARMS.items():
        if pair or env != "DINO_POSE_TPU_STAGE_PAIR":
            monkeypatch.setenv(env, mode)
        else:
            monkeypatch.delenv(env, raising=False)
    jcalls = _route(monkeypatch, "force")
    for module, names in ((jdwconv, JAX_KERNELS), (jconvffn, ("_convffn_fwd_res_kernel",))):
        jcalls.update(dict.fromkeys(names, 0))
        for name in names:
            orig = getattr(module, name)
            monkeypatch.setattr(module, name, lambda *a, _n=name, _o=orig, **k:
                                jcalls.__setitem__(_n, jcalls[_n] + 1) or _o(*a, **k))
    tcalls = dict.fromkeys((*PORT_WRAPPERS, "fused_convffn_res", "fused_convffn"), 0)
    for module, names in ((tdwconv, PORT_WRAPPERS),
                          (tconvffn, ("fused_convffn_res", "fused_convffn"))):
        for name in names:
            orig = getattr(module, name)
            monkeypatch.setattr(module, name, lambda *a, _n=name, _o=orig, **k:
                                tcalls.__setitem__(_n, tcalls[_n] + 1) or _o(*a, **k))
    return jcalls, tcalls


def test_train_mode_backbone_matches_jax(jax_model, monkeypatch):
    """The train-mode backbone with both arms: the feature map and every
    running statistic after one batch; three pair blocks and four conv-arm
    convs a forward on the port's side, JAX tracing all three of its
    forward kernels."""
    module, variables = jax_model
    jcalls, tcalls = _arms(monkeypatch)
    x = _nhwc((2, 128, 128, 3), seed=1)
    backbone = jfastvit.FastViTBackbone(module.cfg)
    sub = {c: variables[c]["backbone"] for c in ("params", "batch_stats")}
    with jdispatch.local():
        want, mutated = jax.jit(lambda v, x_: backbone.apply(
            v, x_, train=True, mutable=["batch_stats"]))(sub, jnp.asarray(x))
    assert jcalls["_combine_dw_fwd_kernel"] == jcalls["_convffn_fwd_res_kernel"] == 3
    assert jcalls["_dw_kernel"] == 4
    tm = _port_model(variables, CONFIG).train()
    with torch.no_grad():
        got = tm.backbone(_to_port(x))
    assert tcalls == {"fused_dw_conv": 4, "fused_combine_dw": 3, "fused_combine_dw_bwd": 0,
                      "fused_convffn_res": 3, "fused_convffn": 1}
    want = np.asarray(want)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    _assert_stats_match(tm, _stats_with(variables, ("backbone",), mutated["batch_stats"]),
                        tm.backbone.stem, tm.backbone.stages, tm.backbone.final_conv)


def test_backbone_lora_grads_match_jax(jax_model, monkeypatch):
    """The 16 LoRA gradients of the train-mode backbone with both arms under
    a seeded cotangent, against JAX's vjp through its pair and conv-arm
    backward kernels. The port's backward runs ``fused_combine_dw_bwd`` in
    the two pair blocks whose input carries a gradient (stage 0's block
    input does not) and ``fused_dw_conv`` for their mixers' dx and the
    attention block's ConvFFN conv."""
    module, variables = jax_model
    jcalls, tcalls = _arms(monkeypatch)
    flat = {k: jnp.asarray(v) for k, v in
            traverse_util.flatten_dict(variables["params"]["backbone"]).items()}
    lora = {k: v for k, v in flat.items() if k[-2] in ("lora_A", "lora_B")}
    x = _nhwc((2, 128, 128, 3), seed=2)
    backbone = jfastvit.FastViTBackbone(module.cfg)
    stats = variables["batch_stats"]["backbone"]
    ct = np.random.default_rng(3).standard_normal((2, 4, 4, 128)).astype(np.float32)

    def dot(leaves):
        params = traverse_util.unflatten_dict({**flat, **leaves})
        out = backbone.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             train=True, mutable=["batch_stats"])[0]
        return jnp.vdot(out, jnp.asarray(ct)), out

    with jdispatch.local():
        (_, out), jgrads = jax.jit(jax.value_and_grad(dot, has_aux=True))(lora)
    assert jcalls["_combine_dw_bwd_kernel"] == 2 and jcalls["_convffn_bwd_kernel"] == 4

    tm = _port_model(variables, CONFIG).train()
    got = tm.backbone(_to_port(x))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5 * np.abs(np.asarray(out)).max())
    got.backward(_t(ct.transpose(0, 3, 1, 2)))
    assert tcalls == {"fused_dw_conv": 4 + 3, "fused_combine_dw": 3, "fused_combine_dw_bwd": 2,
                      "fused_convffn_res": 3, "fused_convffn": 1}
    gflat = traverse_util.flatten_dict(jax.tree.map(np.zeros_like, variables["params"]))
    gflat.update({("backbone",) + k: np.asarray(g) for k, g in jgrads.items()})
    want = state_dict_from_jax({"params": traverse_util.unflatten_dict(gflat),
                                "batch_stats": variables["batch_stats"]}, tm)
    params = dict(tm.named_parameters())
    names = [n for n, p in params.items() if p.grad is not None]
    assert len(names) == 16 and all("lora_" in n for n in names)
    for n in names:
        g, w = params[n].grad.numpy(), want[n].numpy()
        assert np.abs(g).max() > 0, n
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < 1e-5, f"{n}: relative Frobenius error {rel:.3e}"


def test_lora_train_step_matches_jax(jax_model, batch, monkeypatch):
    """Two LoRA train steps at 256² with both arms on both sides (losses,
    step-1 gradients, parameters after AdamW, running statistics), at the
    tolerances the heads' ReLU gates allow (``GATED``); the pair's backward
    kernels run on both sides."""
    module, variables = jax_model
    monkeypatch.setattr(jlayers, "Dropout", _NoDropout)
    jcalls, tcalls = _arms(monkeypatch)
    grads = _two_steps_match_jax(module, variables, CONFIG, batch, family="fastvit", **GATED)
    assert jcalls["_combine_dw_bwd_kernel"] and jcalls["_convffn_fwd_res_kernel"]
    assert tcalls["fused_combine_dw_bwd"] == 2 * 2 and tcalls["fused_convffn_res"] == 2 * 3
    lora = [n for n in grads if "lora_" in n]
    assert len(lora) == 16 and all(np.abs(grads[n]).max() > 0 for n in lora)


def test_eval_pose_model_with_the_conv_arm_matches_jax(jax_model, monkeypatch):
    """Eval with ``DINO_POSE_TPU_DWCONV`` forced: each ConvFFN's 7x7 conv
    takes the arm on both sides (four a forward; the RepMixers fold into one
    XLA conv and take none); the pair arm has no eval form. (The eval
    ConvFFN calls ``fused_convffn`` by its own import, uncounted here.)"""
    module, variables = jax_model
    jcalls, tcalls = _arms(monkeypatch)
    pixels = np.random.default_rng(1).standard_normal((2, 3, 128, 128)).astype(np.float32)
    with jdispatch.local():
        hm_j, z_j = jax.jit(lambda v, x_: module.apply(v, x_, train=False))(
            variables, jnp.asarray(pixels))
    assert jcalls["_dw_kernel"] == 4 and jcalls["_combine_dw_fwd_kernel"] == 0
    tm = _port_model(variables, CONFIG).eval()
    with torch.inference_mode():
        hm_t, z_t = tm(torch.from_numpy(pixels))
    assert {k: v for k, v in tcalls.items() if k != "fused_convffn"} == {
        **dict.fromkeys(PORT_WRAPPERS, 0), "fused_convffn_res": 0, "fused_dw_conv": 4}
    np.testing.assert_allclose(hm_t.numpy(), np.asarray(hm_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-4, rtol=0)


def test_arms_keep_the_parameter_tree(jax_model, monkeypatch):
    """The arms change no parameter or buffer: a state dict converted from
    JAX's variables loads ``strict=True`` into a model built with both arms
    on, and a train-mode forward touches the same BatchNorms."""
    _, variables = jax_model
    _arms(monkeypatch)
    tm = _port_model(variables, CONFIG)
    plain = copy.deepcopy(tm)
    assert tm.state_dict().keys() == plain.state_dict().keys()
    tm.load_state_dict(state_dict_from_jax(variables, tm), strict=True)
    x = _to_port(_nhwc((2, 128, 128, 3), seed=5))
    with torch.no_grad():
        tm.train().backbone(x)
    counted = {n for n, m in tm.named_modules()
               if isinstance(m, torch.nn.BatchNorm2d) and m.num_batches_tracked.item() == 1}
    monkeypatch.delenv("DINO_POSE_TPU_STAGE_PAIR")
    monkeypatch.delenv("DINO_POSE_TPU_DWCONV")
    with torch.no_grad():
        plain.train().backbone(x)
    assert counted == {n for n, m in plain.named_modules()
                       if isinstance(m, torch.nn.BatchNorm2d) and m.num_batches_tracked.item() == 1}


def _block_bf16(module, variables, x, monkeypatch, pair: bool):
    """Stage 1's block in bf16, train mode: (JAX's pair output, the port's
    output with the pair arm ``pair``), both f32 arrays."""
    path = ("backbone", "stage1_block0")
    jblock = jfastvit.FastViTBlock(mixer="repmixer", mlp_ratio=3.0, cfg=module.cfg)
    sub = {c: _sub(variables[c], path) for c in ("params", "batch_stats")}
    _arms(monkeypatch, pair=True)
    xb = jnp.asarray(x, jnp.bfloat16)

    def fn(v, x_):
        return jblock.apply(v, x_, train=True, mutable=["batch_stats"])[0]

    with jdispatch.local():
        want = jax.jit(fn).lower(sub, xb).compile(
            compiler_options={"xla_allow_excess_precision": False})(sub, xb)
    _arms(monkeypatch, pair=pair)
    tm = _port_model(variables, CONFIG).train()
    with torch.no_grad():
        got = tm.backbone.stages[1].blocks[0](_to_port(x).to(torch.bfloat16))
    return got.permute(0, 2, 3, 1).float().numpy(), np.asarray(want.astype(jnp.float32))


def test_bf16_pair_route_rounds_as_jax_and_not_as_the_reuse_route(jax_model, monkeypatch):
    """bf16 witness: against JAX's pair block the port's pair block differs on
    at most 1e-2 of the outputs by at most two ulps of the largest (the
    ConvFFN's GELU flips, tests/test_torch_convffn.py; measured: none); the
    port's reuse block (the pair arm unset, same weights and input) differs
    on at least 10% of them (measured 14.6%), so the tests above see which
    route the port took."""
    module, variables = jax_model
    x = _nhwc((2, 16, 16, 16), seed=6)
    pair, want = _block_bf16(module, variables, x, monkeypatch, pair=True)
    reuse, _ = _block_bf16(module, variables, x, monkeypatch, pair=False)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(pair - want).max() <= 2 * ulp
    assert (pair != want).mean() <= 1e-2, (pair != want).mean()
    assert (reuse != want).mean() >= 0.1, (reuse != want).mean()
