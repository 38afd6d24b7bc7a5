"""One rank of the port's multi-process tests (torch.distributed, gloo, CPU).

    python tests/_torch_dist_worker.py <spec.json> <rank>

The spec names the world size, the ``file://`` rendezvous file, the output
directory and the jobs to run, in order; each job writes what it measured
to ``<out>/<job>_<rank>.npz`` (or ``.json``) for the test process, which
holds it against the JAX package. Inputs (weights, batches) come from the
test process as ``.npz``. This process imports no JAX: the process group is
made here with the spec's rendezvous file, so that the port's
``maybe_initialize_distributed`` finds it up.
"""

import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dino_pose_tpu_torch.core import distributed  # noqa: E402
from dino_pose_tpu_torch.core.mesh import Mesh, MeshSpec, create_mesh  # noqa: E402
from dino_pose_tpu_torch.models import registry  # noqa: E402
from dino_pose_tpu_torch.ops import block, dispatch  # noqa: E402
from dino_pose_tpu_torch.train import state as tstate  # noqa: E402
from dino_pose_tpu_torch.train import step as tstep  # noqa: E402

LR, WD = 3e-5, 1e-6  # tests/test_torch_train.py's


def _npz(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _save(out: str, name: str, rank: int, arrays: dict) -> None:
    np.savez(os.path.join(out, f"{name}_{rank}.npz"),
             **{k: np.asarray(v.detach().numpy() if torch.is_tensor(v) else v)
                for k, v in arrays.items()})


def _model(job: dict):
    """The job's model with its weights; the heads' dropout off unless the
    job keeps it (``heads_dropout_off: false``)."""
    model = registry.create_model_from_config(dict(job["config"]), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _npz(job["weights"]).items()},
                          strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout) and job.get("heads_dropout_off", True):
            m.p = 0.0
    return model


def _rows(batch: dict, rank: int, world: int) -> dict:
    b = len(next(iter(batch.values())))
    lo, hi = rank * b // world, (rank + 1) * b // world
    return {k: torch.from_numpy(v[lo:hi]) for k, v in batch.items()}


def job_step(job: dict, rank: int, world: int, out: str) -> None:
    """Two train steps on this rank's rows of the global batch, then one
    eval step with ``sample_valid``; the state dicts, stats and step-1
    gradients as they come out."""
    model = _model(job)
    batch = _npz(job["batch"])
    with dispatch.scoped():
        create_mesh(device="cpu")
        ts, opt, part = tstate.create_train_state(model, job["config"], weight_decay=WD)
        step = tstep.prepare_batch(tstep.make_train_step(model, opt, part),
                                   (batch["image"].shape[-1], 48))
        res = {}
        if "eval" in job:
            # On the initial weights, with the loss weight JAX's side sets.
            ev = _npz(job["eval"])
            weight = float(ev.pop("weight"))
            rows = _rows(ev, rank, world)
            lw = dataclasses.replace(ts.loss_weight, weight=torch.tensor(weight))
            got = tstep.make_eval_step(model)(dataclasses.replace(ts, loss_weight=lw), rows)
            res.update({f"eval/{k}": got[k] for k in ("loss", "kp_loss", "z_loss",
                                                      "pred_heatmaps", "pred_z")})
            res["eval/valid_rows"] = rows["sample_valid"].sum()
        local = _rows({k: batch[k] for k in ("image", "2d_keypoints", "z_coords")}, rank, world)
        res.update({f"before/{k}": v.clone() for k, v in model.state_dict().items()})
        ts, stats1 = step(ts, local, LR, 0)
        res.update({f"grad/{n}": p.grad.clone() for n, p in model.named_parameters()
                    if p.grad is not None})
        res.update({f"after1/{k}": v.clone() for k, v in model.state_dict().items()})
        ts, stats2 = step(ts, local, LR, 0)
        res.update({f"after2/{k}": v.clone() for k, v in model.state_dict().items()})
        res.update({f"stats1/{k}": v for k, v in stats1.items()})
        res.update({f"stats2/{k}": v for k, v in stats2.items()})
    res["partition"] = np.array(sorted(part))
    _save(out, "step", rank, res)


def job_backbone(job: dict, rank: int, world: int, out: str) -> None:
    """The train-mode backbone on this rank's rows under a seeded cotangent:
    its output rows, the trainable gradients summed over the ranks, the
    BatchNorm running statistics."""
    model = _model(job).train()
    a = _npz(job["inputs"])
    rows = _rows(a, rank, world)
    with dispatch.scoped():
        create_mesh(device="cpu")
        x = rows["x"].contiguous(memory_format=torch.channels_last)
        y = model.backbone(x)
        y.backward(rows["ct"])
        params = [p for p in model.parameters() if p.grad is not None]
        distributed.all_reduce_grads(params)
    res = {f"grad/{n}": p.grad for n, p in model.named_parameters() if p.grad is not None}
    res.update({f"sd/{k}": v for k, v in model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))})
    res["y"] = y.detach()
    _save(out, "backbone", rank, res)


def job_tp(job: dict, rank: int, world: int, out: str) -> None:
    """A (1, world) mesh across the ranks against the one-card route
    computed in this same process: the attention and MLP halves forward and
    backward, then a LoRA model's forward and one train step."""
    from dino_pose_tpu_torch.ops.block import AttnParams, MlpParams, attn_part_tp, mlp_part_tp

    a = _npz(job["halves"])
    heads, eps = int(a["heads"]), 1e-6
    ap = AttnParams(*(torch.from_numpy(a[f"ap{i}"]) for i in range(6)))
    mp = MlpParams(*(torch.from_numpy(a[f"mp{i}"]) for i in range(7)))
    res = {}

    def halves(mesh, tag):
        x = torch.from_numpy(a["x"]).requires_grad_(True)
        o = attn_part_tp(x, ap, heads, eps, mesh, kernels=False)
        x2 = x + o * torch.from_numpy(a["ls1"])
        y = mlp_part_tp(x2, mp, eps, mesh, kernels=False)
        y.backward(torch.from_numpy(a["ct"]))
        res.update({f"{tag}/o": o.detach(), f"{tag}/y": y.detach(), f"{tag}/dx": x.grad})

    spec = MeshSpec(1, world)
    with dispatch.scoped():
        across = create_mesh(spec, device="cpu")
        assert across.model_spans_ranks and list(across.local_model_ranks) == [rank]
        halves(across, "ranks")
        halves(Mesh(spec), "card")

        batch = _npz(job["batch"])
        for tag, mesh in (("ranks", across), ("card", Mesh(spec))):
            dispatch.configure_for_mesh(mesh)
            model = _model(job)
            with torch.no_grad():
                hm, z = model.eval()(torch.from_numpy(batch["image"]))
            ts, opt, part = tstate.create_train_state(model, job["config"], weight_decay=WD)
            step = tstep.prepare_batch(tstep.make_train_step(model, opt, part), (224, 48))
            block.reset_launches()
            ts, stats = step(ts, {k: torch.from_numpy(v) for k, v in batch.items()}, LR, 0)
            res.update({f"{tag}/hm": hm, f"{tag}/z": z,
                        **{f"{tag}/stats/{k}": v for k, v in stats.items()},
                        **{f"{tag}/sd/{k}": v.clone() for k, v in model.state_dict().items()}})
    _save(out, "tp", rank, res)


def job_collectives(job: dict, rank: int, world: int, out: str) -> None:
    """broadcast_string, broadcast_state (rank 0 has stepped its AdamW, the
    others have fresh state and other weights), the structure guard, the
    meshes and fit's refusals across ranks."""
    res = {"already_up": distributed.maybe_initialize_distributed("cpu"),
           "world": distributed.world_size(), "rank": distributed.rank(),
           "primary": distributed.is_primary()}
    res["string"] = distributed.broadcast_string(f"ckpt_of_rank_{rank}.pth")
    res["none"] = distributed.broadcast_string(None if rank == 0 else "x")
    torch.manual_seed(100 + rank)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    opt = tstate.make_optimizer(model.parameters(), WD)
    if rank == 0:
        model(torch.randn(5, 4)).square().sum().backward()
        opt.param_groups[0]["lr"] = 1e-2
        opt.step()
    from dino_pose_tpu_torch.train.weighting import LossWeightState

    lw = LossWeightState.create(0.1 + rank)
    if rank == 0:
        lw = LossWeightState(*(torch.tensor(v) for v in (0.5, 1.5, 2.5, True, 0.25, 3.0)))
    distributed.check_same_structure(distributed.state_description(model, opt), "same")
    lw, scalars = distributed.broadcast_state(model, opt, lw, [7 + rank, 1e-4 * (rank + 1)])
    res["scalars"] = scalars
    res["lw"] = [float(getattr(lw, f)) for f in ("weight", "kp_avg", "z_avg", "initialized",
                                                   "best_weight", "best_val_loss")]
    res["state"] = {k: v.tolist() for k, v in model.state_dict().items()}
    res["opt"] = {f"{i}/{k}": v.tolist() for i, st in enumerate(opt.state.values())
                  for k, v in sorted(st.items())}
    try:
        distributed.check_same_structure(f"structure of rank {rank}", "differs")
        res["guard"] = "passed"
    except RuntimeError as e:
        res["guard"] = str(e)

    refusals = {}
    for spec in (MeshSpec(1, 1), MeshSpec(2, 2), MeshSpec(1, world), MeshSpec(world, 1)):
        try:
            with dispatch.scoped():
                create_mesh(spec, device="cpu")
            refusals[f"{spec.dp}x{spec.tp}"] = "made"
        except ValueError as e:
            refusals[f"{spec.dp}x{spec.tp}"] = str(e)
    with dispatch.scoped():
        mesh = create_mesh(device="cpu")
        res["default_mesh"] = [mesh.data_size, mesh.tp, mesh.data_rank, mesh.model_rank]
        res["data_shard"] = list(distributed.data_shard())
        res["data_sum"] = distributed.data_sum(torch.tensor([1.0, float(rank)])).tolist()
    from dino_pose_tpu_torch.train.loop import fit

    d, t, p, m = job["fit"]
    runs = {"model_axis": ((d, {**t, "checkpoint_dir": t["checkpoint_dir"] + "_tp"}, p, m),
                           {"mesh": MeshSpec(1, world)}),
            "batch": ((d, {**t, "batch_size": 3}, p, m), {})}
    for name, (cfgs, kw) in runs.items():
        try:
            fit(*cfgs, device="cpu", progress=False, **kw)
            refusals[name] = "trained"
        except (NotImplementedError, ValueError) as e:
            refusals[name] = str(e)
    res["refusals"] = refusals
    with open(os.path.join(out, f"collectives_{rank}.json"), "w") as f:
        json.dump(res, f)


def job_pckh(job: dict, rank: int, world: int, out: str) -> None:
    """The dataset PCKh with the images split over the ranks."""
    from dino_pose_tpu_torch.train import evaluate

    model = _model(job)
    with dispatch.scoped():
        create_mesh(device="cpu")
        got = evaluate.compute_pckh_dataset(model, job["images"], job["ann"], batch_size=2,
                                            num_workers=2, return_all=True)
    with open(os.path.join(out, f"pckh_{rank}.json"), "w") as f:
        json.dump({"metrics": got, **evaluate.last_eval_info}, f)


def job_fit(job: dict, rank: int, world: int, out: str) -> None:
    """``fit`` on this rank; the history and the final state dict."""
    from dino_pose_tpu_torch.train import evaluate
    from dino_pose_tpu_torch.train.loop import fit

    if job.get("pretend_no_ckpt") and rank > 0:
        # A filesystem the ranks do not share: this rank acts as if the
        # primary's checkpoint file were not there.
        real = os.path.isfile
        os.path.isfile = lambda p: False if str(p).endswith(".pth") else real(p)
    d, t, p, m = job["configs"]
    t = {**t, "checkpoint_dir": job["checkpoint_dirs"][rank]}
    history = fit(d, t, p, m, device="cpu", progress=False, num_epochs=job.get("num_epochs"))
    sd = history["model"].state_dict()
    _save(out, "fit_state", rank, {k: v for k, v in sd.items()})
    with open(os.path.join(out, f"fit_{rank}.json"), "w") as f:
        json.dump({"train_loss": history["train_loss"], "val_loss": history["val_loss"],
                   "pckh": history["pckh"], "step": history["state"].step,
                   "eval_info": dict(evaluate.last_eval_info)}, f)


def job_fit_tp(job: dict, rank: int, world: int, out: str) -> None:
    """``fit`` with a (1, world) mesh across the ranks, once per model of
    the job: the history and the final state dict of each."""
    from dino_pose_tpu_torch.train.loop import fit

    for name, (d, t, p, m) in job["runs"].items():
        t = {**t, "checkpoint_dir": f"{t['checkpoint_dir']}_{rank}"}
        history = fit(d, t, p, m, device="cpu", progress=False, mesh=MeshSpec(1, world))
        _save(out, f"fit_tp_{name}", rank, history["model"].state_dict())
        with open(os.path.join(out, f"fit_tp_{name}_{rank}.json"), "w") as f:
            json.dump({"train_loss": history["train_loss"], "val_loss": history["val_loss"],
                       "pckh": history["pckh"], "step": history["state"].step}, f)


JOBS = {"step": job_step, "backbone": job_backbone, "tp": job_tp, "collectives": job_collectives, "pckh": job_pckh,
        "fit": job_fit, "fit_tp": job_fit_tp}


def main() -> None:
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{spec['init_file']}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=spec["timeout"]))
    assert distributed.maybe_initialize_distributed("cpu") == (world > 1)
    for job in spec["jobs"]:
        JOBS[job["name"]](job, rank, world, spec["out"])
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
