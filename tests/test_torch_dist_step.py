"""Two gloo ranks train one test/vit-tiny + LoRA model over a global batch,
against JAX's single-process step on that batch, on the CPU in f32; and the
('data', 'model') = (1, 2) mesh across two ranks against the one-card
tensor-parallel route.

The data-parallel step is held with ``test_torch_train._check_two_steps``,
the tolerances of ``test_torch_train.py``'s train steps (losses 1e-5,
gradients above the heads' last ReLU 1e-4 and below it 1e-2, parameters
2*lr a step, running statistics 1e-5): each rank holds two rows of four,
the losses divide by the global count, the heads' BatchNorm statistics are
the global batch's and the gradients are summed over the ranks. At four
rows the heatmap head's ``prediction.0`` sits behind a ReLU gate that
flips between the frameworks, so the 1e-4 leaves are those with no ReLU
below the losses (``_ABOVE_LAST_RELU``, as the unfreeze steps hold them):
on this batch one process of the port reads 2.6e-4 there against JAX.
The eval step's ranks hold unequal numbers of valid rows (two and one):
its losses are held to 1e-5 and its predictions to 1e-4 abs, as
``test_eval_step_matches_jax`` holds them. Both ranks end bit-identical.

Across the model axis two-term f32 sums commute, so the halves (forward
and the input's cotangent) and a LoRA model's forward and train step (its
dropout on) are bit-equal to the one-card route computed in the same
process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dino_pose_tpu.data import heatmaps as jheatmaps
from dino_pose_tpu.nn import layers as jlayers
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu.train import state as jstate
from dino_pose_tpu.train import step as jstep
from test_torch_distributed import load_npz, run_ranks, save_npz
from test_torch_train import (
    _ABOVE_LAST_RELU,
    CONFIG,
    _check_two_steps,
    _jax_two_steps,
    _keypoints,
    _NoDropout,
    _port_model,
    jax_pose,  # noqa: F401  (fixture)
)

EVAL_WEIGHT = 0.37


def as_port_run(npz: dict) -> dict:
    """A worker's ``step`` output in ``_check_two_steps``'s form."""
    def part(prefix):
        return {k[len(prefix):]: torch.from_numpy(v) for k, v in npz.items()
                if k.startswith(prefix)}

    return {"stats": [part("stats1/"), part("stats2/")],
            "grads": {k: v.numpy() for k, v in part("grad/").items()},
            "partition": frozenset(npz["partition"].tolist()),
            "states": [part("before/"), part("after1/"), part("after2/")]}


def global_batch(seed: int, b: int, size: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((b, 3, size, size)).astype(np.float32),
            "2d_keypoints": _keypoints(rng, b, 24, (size, size)),
            "z_coords": (rng.standard_normal((b, 24)) * 10).astype(np.float32)}


@pytest.fixture(scope="module")
def dinov2_run(jax_pose, tmp_path_factory):
    module, variables = jax_pose
    tmp = tmp_path_factory.mktemp("dist_step")
    batch = global_batch(30, 4, 224)
    hm = np.asarray(jheatmaps.render_heatmaps(jnp.asarray(batch["2d_keypoints"])))
    sv = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "Dropout", _NoDropout)
        want = _jax_two_steps(module, variables, CONFIG, batch)
        js, _, _ = jstate.create_train_state(variables, CONFIG, "dinov2")
        js = js.replace(loss_weight=js.loss_weight.replace(weight=jnp.float32(EVAL_WEIGHT)))
        with jdispatch.local():
            want_eval = jax.jit(jstep.make_eval_step(module))(js, {
                **{k: jnp.asarray(v) for k, v in batch.items()},
                "2d_heatmaps": jnp.asarray(hm), "sample_valid": jnp.asarray(sv)})
    tm = _port_model(variables)
    weights = save_npz(tmp / "weights.npz", {k: v.numpy() for k, v in tm.state_dict().items()})
    run_ranks(tmp, [{"name": "step", "config": CONFIG, "weights": weights,
                     "batch": save_npz(tmp / "batch.npz", batch),
                     "eval": save_npz(tmp / "eval.npz", {**batch, "2d_heatmaps": hm,
                                                         "sample_valid": sv,
                                                         "weight": EVAL_WEIGHT})}])
    return tm, want, want_eval, [load_npz(tmp / "out" / f"step_{r}.npz") for r in range(2)]


def test_two_rank_lora_step_matches_jax(dinov2_run):
    """Two LoRA steps on two ranks against JAX's two steps on the global
    batch: losses, loss weights, the step-1 gradients (all-reduced), the
    parameters after AdamW, the heads' running statistics (global)."""
    tm, want, _, (r0, _) = dinov2_run
    got = as_port_run(r0)
    _check_two_steps(tm, want, got, above=_ABOVE_LAST_RELU)
    lora = [n for n in got["grads"] if "lora" in n]
    assert len(lora) == 2 and all(np.abs(got["grads"][n]).max() > 0 for n in lora)


def test_two_ranks_end_bit_identical(dinov2_run):
    _, _, _, (r0, r1) = dinov2_run
    keys = [k for k in r0 if not k.startswith("eval/pred")]
    assert set(r0) == set(r1)
    for k in keys:
        if k != "eval/valid_rows":
            assert np.array_equal(r0[k], r1[k]), k


def test_eval_step_with_unequal_valid_rows_matches_jax(dinov2_run):
    """Rank 0 holds two valid rows, rank 1 one: the validation losses
    divide by the global count of three and are the global batch's on both
    ranks; each rank's predictions are its rows of JAX's."""
    _, _, want, runs = dinov2_run
    assert [float(r["eval/valid_rows"]) for r in runs] == [2.0, 1.0]
    for rank, r in enumerate(runs):
        for k in ("loss", "kp_loss", "z_loss"):
            np.testing.assert_allclose(float(r[f"eval/{k}"]), float(want[k]), rtol=1e-5,
                                       err_msg=k)
        for k in ("pred_heatmaps", "pred_z"):
            np.testing.assert_allclose(r[f"eval/{k}"],
                                       np.asarray(want[k])[2 * rank:2 * rank + 2],
                                       atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# The model axis across ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp_run(jax_pose, tmp_path_factory):
    _, variables = jax_pose
    tmp = tmp_path_factory.mktemp("dist_tp")
    rng = np.random.default_rng(31)
    d, h, s, b = 64, 256, 17, 2

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    halves = {"x": f32(b, s, d), "ct": f32(b, s, d), "ls1": f32(d, scale=0.5), "heads": 2,
              **{f"ap{i}": a for i, a in enumerate(
                  (1 + f32(d, scale=0.1), f32(d, scale=0.1), f32(d, 3 * d, scale=d ** -0.5),
                   f32(3 * d, scale=0.1), f32(d, d, scale=d ** -0.5), f32(d, scale=0.1)))},
              **{f"mp{i}": a for i, a in enumerate(
                  (1 + f32(d, scale=0.1), f32(d, scale=0.1), f32(d, h, scale=d ** -0.5),
                   f32(h, scale=0.1), f32(h, d, scale=h ** -0.5), f32(d, scale=0.1),
                   f32(d, scale=0.5)))}}
    config = {**CONFIG, "lora_dropout": 0.1}
    tm = _port_model(variables, config)
    run_ranks(tmp, [{"name": "tp", "config": config, "heads_dropout_off": False,
                     "weights": save_npz(tmp / "w.npz", {k: v.numpy() for k, v in
                                                         tm.state_dict().items()}),
                     "halves": save_npz(tmp / "halves.npz", halves),
                     "batch": save_npz(tmp / "batch.npz", global_batch(32, 2, 224))}])
    return [load_npz(tmp / "out" / f"tp_{r}.npz") for r in range(2)]


@pytest.mark.parametrize("what", ["halves", "model"])
def test_model_axis_across_ranks_is_bit_equal_to_one_card(tp_run, what):
    """(1, 2) across two ranks against the one-card tp = 2 route: the
    attention and MLP halves and the input's cotangent through both
    (``halves``); a LoRA model's eval forward, and one train step with its
    dropout on: stats and every parameter and buffer after it (``model``).
    Both ranks hold the same bits."""
    names = ("o", "y", "dx") if what == "halves" else ("hm", "z", "stats/", "sd/")
    for r in tp_run:
        keys = [k[len("card/"):] for k in r if k.startswith("card/")
                and k[len("card/"):].startswith(names)]
        assert keys
        for k in keys:
            assert np.array_equal(r[f"ranks/{k}"], r[f"card/{k}"]), k
            assert np.array_equal(r[f"ranks/{k}"], tp_run[0][f"ranks/{k}"]), k
    if what == "halves":
        assert np.abs(tp_run[0]["ranks/dx"]).max() > 0
