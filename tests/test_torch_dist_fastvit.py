"""Two gloo ranks train test/fastvit-tiny + LoRA over a global batch, against
JAX's single-process computation on that batch, on the CPU in f32.

Every train-mode BatchNorm of the backbone and the heads (the one-pass
moments of the coefficient branches, the Gram form of stem0's scale branch,
the two-pass statistics of the materialised branches and the ConvFFN's
depthwise conv, SpatialAttention's pre-norm) reduces its sums over the two
ranks before it divides, its running statistics update from the global
values, and under autograd the cotangents of those sums are all-reduced.

- The train-mode backbone, each rank two of four 128² images, under a
  seeded cotangent, against JAX's vjp on the four: its output rows to 1e-5
  of their largest magnitude and every running mean and var to 1e-5
  relative (1e-7 absolute), as ``test_torch_fastvit_train.py`` holds one
  process. No ReLU gate lies in the way of the 16 LoRA gradients (summed
  over the ranks): they are held to 1e-5 relative Frobenius error against
  one process of the port on the four images (measured up to 2.2e-6) and
  to 5e-5 against JAX's, since on four images one process of the port
  itself reads up to 1.6e-5 against JAX (f32 summation order; 1e-5 holds
  it on ``test_torch_fastvit_train.py``'s two).
- Two LoRA train steps, each rank two of four 256² images, with
  ``test_torch_fastvit_train.py``'s ``GATED`` tolerances. Two of them are
  what four rows need, on one process of the port as on two: the 1e-4 set
  is the leaves with no ReLU below the losses (``heatmap_head.prediction.0``
  reads 3.8e-3 against JAX, one process or two, behind a gate that flips),
  and the step-1 running statistics are held to 1e-6 absolute (one process
  reads 3.0e-7 against JAX's 1e-7). JAX's ConvFFNs on its default route off
  a TPU (XLA).

Both ranks end bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from dino_pose_tpu.models import fastvit as jfastvit
from dino_pose_tpu.nn import layers as jlayers
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu_torch.io.convert import state_dict_from_jax
from test_torch_dist_step import as_port_run
from test_torch_distributed import load_npz, run_ranks, save_npz
from test_torch_fastvit_train import CONFIG, GATED, jax_model  # noqa: F401  (fixture)
from test_torch_train import _check_two_steps, _jax_two_steps, _NoDropout, _port_model

# The leaves with no ReLU between them and the losses, at FastViT's prefix.
LAST_RELU = ("backbone.head.z_head.mlp.9.", "backbone.head.heatmap_head.prediction.3.")


def _jax_backbone(module, variables, x, ct):
    """JAX's train-mode backbone on the whole batch: output, the LoRA
    gradients of ``vdot(output, ct)`` and the mutated batch stats."""
    flat = {k: jnp.asarray(v) for k, v in
            traverse_util.flatten_dict(variables["params"]["backbone"]).items()}
    lora = {k: v for k, v in flat.items() if k[-2] in ("lora_A", "lora_B")}
    backbone = jfastvit.FastViTBackbone(module.cfg)

    def dot(leaves):
        params = traverse_util.unflatten_dict({**flat, **leaves})
        out, mut = backbone.apply({"params": params,
                                   "batch_stats": variables["batch_stats"]["backbone"]},
                                  jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.vdot(out, jnp.asarray(ct)), (out, mut["batch_stats"])

    with jdispatch.local():
        (_, (out, stats)), grads = jax.jit(jax.value_and_grad(dot, has_aux=True))(lora)
    return np.asarray(out), grads, jax.device_get(stats)


@pytest.fixture(scope="module")
def fastvit_run(jax_model, tmp_path_factory):
    module, variables = jax_model
    tmp = tmp_path_factory.mktemp("dist_fastvit")
    rng = np.random.default_rng(40)
    kps = rng.uniform(4, 252, (4, 24, 3)).astype(np.float32)
    kps[..., 2] = rng.choice([0.0, 1.0, 2.0], (4, 24))
    batch = {"image": rng.standard_normal((4, 3, 256, 256)).astype(np.float32),
             "2d_keypoints": kps,
             "z_coords": (rng.standard_normal((4, 24)) * 10).astype(np.float32)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "Dropout", _NoDropout)
        mp.delenv("DINO_POSE_TPU_CONVFFN", raising=False)
        want = _jax_two_steps(module, variables, CONFIG, batch, family="fastvit")
        x = (rng.standard_normal((4, 128, 128, 3)) * 1.5 + 0.5).astype(np.float32)
        ct = rng.standard_normal((4, 4, 4, 128)).astype(np.float32)
        out, grads, stats = _jax_backbone(module, variables, x, ct)
    tm = _port_model(variables, CONFIG)
    weights = save_npz(tmp / "w.npz", {k: v.numpy() for k, v in tm.state_dict().items()})
    run_ranks(tmp, [
        {"name": "backbone", "config": CONFIG, "weights": weights,
         "inputs": save_npz(tmp / "bb.npz", {"x": x.transpose(0, 3, 1, 2),
                                              "ct": ct.transpose(0, 3, 1, 2)})},
        {"name": "step", "config": CONFIG, "weights": weights,
         "batch": save_npz(tmp / "batch.npz", batch)}])
    one = _port_model(variables, CONFIG).train()
    one.backbone(torch.from_numpy(x.transpose(0, 3, 1, 2)).contiguous(
        memory_format=torch.channels_last)).backward(torch.from_numpy(ct.transpose(0, 3, 1, 2)))
    one_grads = {n: p.grad.numpy() for n, p in one.named_parameters() if p.grad is not None}
    gflat = traverse_util.flatten_dict(jax.tree.map(np.zeros_like, variables["params"]))
    gflat.update({("backbone",) + k: np.asarray(g) for k, g in grads.items()})
    want_grads = state_dict_from_jax({"params": traverse_util.unflatten_dict(gflat),
                                      "batch_stats": variables["batch_stats"]}, tm)
    want_stats = state_dict_from_jax({"params": variables["params"], "batch_stats": {
        **variables["batch_stats"], "backbone": stats}}, tm)
    out_dir = tmp / "out"
    return (tm, want, (out, want_grads, want_stats, one_grads),
            [load_npz(out_dir / f"step_{r}.npz") for r in range(2)],
            [load_npz(out_dir / f"backbone_{r}.npz") for r in range(2)])


def test_two_rank_backbone_matches_jax(fastvit_run):
    """Global BatchNorm in the train-mode backbone, forward and backward:
    each rank's output rows, the all-reduced LoRA gradients (against one
    process of the port and JAX's) and every running statistic against
    JAX's on the four images."""
    _, _, (out, grads, stats, one_grads), _, runs = fastvit_run
    for rank, r in enumerate(runs):
        want = out[2 * rank:2 * rank + 2]
        np.testing.assert_allclose(r["y"].transpose(0, 2, 3, 1), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(out).max())
        names = [k[len("grad/"):] for k in r if k.startswith("grad/")]
        assert len(names) == 16 and all("lora_" in n for n in names)
        assert sorted(names) == sorted(one_grads)
        for n in names:
            g = r[f"grad/{n}"]
            assert np.abs(g).max() > 0, n
            for w, tol in ((one_grads[n], 1e-5), (grads[n].numpy(), 5e-5)):
                rel = np.linalg.norm(g - w) / np.linalg.norm(w)
                assert rel < tol, f"{n}: relative Frobenius error {rel:.3e} (tol {tol})"
        keys = [k[len("sd/"):] for k in r if k.startswith("sd/backbone.")]
        assert len(keys) > 20
        for k in keys:
            np.testing.assert_allclose(r[f"sd/{k}"], stats[k].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_two_rank_fastvit_step_matches_jax(fastvit_run):
    """Two LoRA steps on two ranks against JAX's on the global batch:
    losses, the step-1 gradients of the 16 adapters and the heads, the
    parameters after AdamW, and every BatchNorm's running statistics from
    the global batch's moments."""
    tm, want, _, (r0, _), _ = fastvit_run
    got = as_port_run(r0)
    _check_two_steps(tm, want, got, **{**GATED, "above": LAST_RELU, "stats_atol": 1e-6})
    lora = [n for n in got["grads"] if "lora_" in n]
    assert len(lora) == 16 and all(np.abs(got["grads"][n]).max() > 0 for n in lora)
    stats = [k for k in got["states"][2] if k.endswith("running_var")]
    assert len(stats) > 20


def test_two_fastvit_ranks_end_bit_identical(fastvit_run):
    _, _, _, (r0, r1), (b0, b1) = fastvit_run
    assert set(r0) == set(r1)
    for k in r0:
        assert np.array_equal(r0[k], r1[k]), k
    for k in b0:
        if k != "y":
            assert np.array_equal(b0[k], b1[k]), k


