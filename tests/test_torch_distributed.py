"""The port's multi-process runtime on the CPU: the launch contracts, the
device a rank takes, the sharding table against JAX's, the loader's process
shards against JAX's, and two gloo processes for the collectives, the
meshes across ranks, fit's refusals and the dataset PCKh.

The processes run ``tests/_torch_dist_worker.py`` (it imports no JAX) with a
``file://`` rendezvous under ``tmp_path``; every spawn and wait has a time
limit, so a hung collective fails the test. The PCKh split over two ranks
is held to JAX's single-process ``compute_pckh_dataset`` to 1e-6 abs (f32
counts summed in another order), as ``test_torch_loop.py`` holds the
single-process one.
"""

import json
import os
import subprocess
import sys
import time

import flax
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JaxMesh

from dino_pose_tpu.core import sharding as jsharding
from dino_pose_tpu.data import dataset as jdataset
from dino_pose_tpu.models import registry as jregistry
from dino_pose_tpu.train import evaluate as jevaluate
from dino_pose_tpu_torch.config import get_default_configs
from dino_pose_tpu_torch.core import device as tdevice
from dino_pose_tpu_torch.core import distributed as tdist
from dino_pose_tpu_torch.core import sharding as tsharding
from dino_pose_tpu_torch.core.mesh import Mesh, MeshSpec
from dino_pose_tpu_torch.data import dataset as tdataset
from dino_pose_tpu_torch.io import convert
from dino_pose_tpu_torch.io.convert import state_dict_from_jax
from dino_pose_tpu_torch.models import registry as tregistry
from test_torch_data import MODEL, write_coco
from test_torch_loop import EVEN_SIZES
from test_torch_model import _randomise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
LAUNCH_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
               "SLURM_NTASKS", "SLURM_NPROCS", "SLURM_PROCID", "SLURM_LOCALID")


# ---------------------------------------------------------------------------
# Running ranks
# ---------------------------------------------------------------------------

def save_npz(path, arrays: dict) -> str:
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})
    return str(path)


def load_npz(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def run_ranks(tmp_path, jobs: list, world: int = 2, timeout: float = 150,
              expect_ok: bool = True) -> list[tuple[int, str]]:
    """Run ``jobs`` in ``world`` gloo processes; returns each rank's
    (return code, output). Every process is killed at ``timeout`` seconds,
    and the collectives time out before that."""
    out = tmp_path / "out"
    out.mkdir(parents=True, exist_ok=True)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"world": world, "init_file": str(tmp_path / "rendezvous"),
                                "out": str(out), "jobs": jobs, "timeout": timeout / 2}))
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    logs = [tmp_path / f"rank{r}.log" for r in range(world)]
    procs = []
    for r, path in enumerate(logs):
        # Output to a file: a full pipe would block the worker mid-collective.
        with open(path, "w") as f:
            procs.append(subprocess.Popen([sys.executable, WORKER, str(spec), str(r)], cwd=ROOT,
                                          env=env, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = [(p.returncode, path.read_text()) for p, path in zip(procs, logs)]
    if expect_ok:
        for r, (rc, log) in enumerate(results):
            assert rc == 0, f"rank {r} exited {rc}:\n{log[-4000:]}"
    return results


# ---------------------------------------------------------------------------
# The launch contracts
# ---------------------------------------------------------------------------

TORCHRUN = {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1", "MASTER_ADDR": "h0",
            "MASTER_PORT": "29500"}


@pytest.mark.parametrize("env, want", [
    ({}, None),
    (TORCHRUN, tdist.Launch(2, 1, 1, "tcp://h0:29500", "torchrun")),
    ({**TORCHRUN, "SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1"},
     tdist.Launch(2, 1, 1, "tcp://h0:29500", "torchrun")),
    ({"WORLD_SIZE": "1"}, None),
    ({"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "h0",
      "MASTER_PORT": "1"}, tdist.Launch(1, 0, 0, "tcp://h0:1", "torchrun")),
    ({"JAX_COORDINATOR_ADDRESS": "h1:1234", "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "3"},
     tdist.Launch(4, 3, 0, "tcp://h1:1234", "jax")),
    ({"JAX_COORDINATOR_ADDRESS": "h1:1234", "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "3",
      "LOCAL_RANK": "2"}, tdist.Launch(4, 3, 2, "tcp://h1:1234", "jax")),
    ({"JAX_NUM_PROCESSES": "1"}, None),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_LOCALID": "0", "MASTER_ADDR": "h2",
      "MASTER_PORT": "7"}, tdist.Launch(4, 2, 0, "tcp://h2:7", "slurm")),
    ({"SLURM_NPROCS": "4", "SLURM_PROCID": "3", "SLURM_LOCALID": "1",
      "JAX_COORDINATOR_ADDRESS": "h3:9"}, tdist.Launch(4, 3, 1, "tcp://h3:9", "slurm")),
    ({"SLURM_NTASKS": "1"}, None),
])
def test_launch_contracts(env, want):
    assert tdist.launch_contract(env) == want


@pytest.mark.parametrize("env, missing", [
    ({"WORLD_SIZE": "2"}, "incomplete torchrun launch: RANK, LOCAL_RANK"),
    ({"WORLD_SIZE": "2", "RANK": "0", "LOCAL_RANK": "0"}, "MASTER_ADDR, MASTER_PORT"),
    ({"WORLD_SIZE": "2", "RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "h"}, "MASTER_PORT"),
    ({"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "0"},
     "incomplete JAX launch: JAX_COORDINATOR_ADDRESS"),
    ({"JAX_NUM_PROCESSES": "2", "JAX_COORDINATOR_ADDRESS": "h:1"}, "JAX_PROCESS_ID"),
    ({"SLURM_NTASKS": "2", "SLURM_PROCID": "0", "SLURM_LOCALID": "0"},
     "incomplete SLURM launch: MASTER_ADDR"),
    ({"SLURM_NPROCS": "2", "MASTER_ADDR": "h", "MASTER_PORT": "1"}, "SLURM_PROCID"),
])
def test_incomplete_contracts_raise(env, missing):
    with pytest.raises(RuntimeError, match=missing):
        tdist.launch_contract(env)


def _mock_init(monkeypatch, env: dict) -> list:
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(dist, "all_reduce", lambda t, **k: calls.append(("all_reduce", t)))
    return calls


@pytest.mark.parametrize("env", [
    TORCHRUN,
    {"JAX_COORDINATOR_ADDRESS": "h1:1234", "JAX_NUM_PROCESSES": "4", "JAX_PROCESS_ID": "3"},
    {"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_LOCALID": "0", "MASTER_ADDR": "h2",
     "MASTER_PORT": "7"},
])
def test_initialize_follows_the_contract(monkeypatch, env):
    """Each contract initialises gloo for the CPU with its address, world,
    rank and an explicit timeout, then runs one tiny all-reduce; a group
    already up is left as it is; no contract, no group."""
    calls = _mock_init(monkeypatch, env)
    launch = tdist.launch_contract()
    assert tdist.maybe_initialize_distributed("cpu") is True
    (args, kw), (name, t) = calls
    assert args == ("gloo",) and name == "all_reduce" and t.device.type == "cpu"
    assert kw == {"init_method": launch.init_method, "world_size": launch.world,
                  "rank": launch.rank, "timeout": tdist.DEFAULT_TIMEOUT}

    calls.clear()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 3)
    assert tdist.maybe_initialize_distributed("cpu") is True and not calls
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    assert tdist.maybe_initialize_distributed("cpu") is False and not calls


def test_nothing_falls_back_quietly(monkeypatch):
    """A CUDA launch without NCCL raises (no gloo fallback); a local rank
    with no card raises; the default device under a launch is the rank's
    card, and an explicit device wins."""
    calls = _mock_init(monkeypatch, TORCHRUN)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    assert tdevice.resolve_device() == torch.device("cuda:1")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="NCCL is not available"):
        tdist.maybe_initialize_distributed()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="local rank 1 has no card"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="local rank 1 has no card"):
        tdist.maybe_initialize_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device()
    assert not calls
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdevice.resolve_device() == torch.device("cuda")


# ---------------------------------------------------------------------------
# The sharding table against JAX's
# ---------------------------------------------------------------------------

# JAX leaf dim -> torch dim, by io/convert's layout kind.
_TORCH_DIM = {"linear": {0: 1, 1: 0}, "conv": {3: 0, 2: 1, 0: 2, 1: 3},
              "none": {0: 0}, "scale2d": {0: 0}}


def _jax_dim(sharding, mesh) -> int | None:
    """The dim a NamedSharding splits over a 'model' axis of more than one
    shard, or None."""
    spec = sharding.spec
    dims = [i for i, a in enumerate(spec) if a == "model"]
    assert not any(a not in (None, "model") for a in spec), spec
    return dims[0] if dims and mesh.shape["model"] > 1 else None


@pytest.fixture(scope="module")
def families():
    """Each family's JAX variable tree as the registry builds it (its
    ``init`` traced, not run: the rules read shapes only) and the port's
    model."""
    out = {}
    init = flax.linen.Module.init
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Module, "init",
                   lambda self, *a, **k: jax.eval_shape(lambda *b: init(self, *b, **k), *a))
        for family, name in (("dinov2", "test/vit-tiny"), ("fastvit", "test/fastvit-tiny")):
            config = {"model_name": name, "use_lora": True}
            jm = jregistry.create_model_from_config(dict(config), pretrained=False)
            tm = tregistry.create_model_from_config(dict(config), device="cpu")
            out[family] = (jm.variables, tm)
    return out


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
@pytest.mark.parametrize("family", ["dinov2", "fastvit"])
def test_shard_specs_match_jax(families, family, shape):
    """Every key's split dim under the port's table equals JAX's
    ``tree_shardings`` on the same leaf, carried through io/convert's key
    map and layouts; the rules engage on the model axis (q/k/v, their
    biases, the out-projection, fc1 and its bias, fc2 in each of the two
    dinov2 blocks; each FastViT ConvFFN's fc1, its bias and fc2, and the
    attention stage's qkv and proj) and replicate everything on a data-only
    mesh."""
    variables, tm = families[family]
    jm_ = JaxMesh(np.asarray(jax.devices()[:2]).reshape(shape), ("data", "model"))
    jsh = jsharding.tree_shardings(variables, jm_, jsharding.tp_rules_for_family(family))
    got = tsharding.shard_specs(tm.state_dict(), Mesh(MeshSpec(*shape)),
                                tsharding.tp_rules_for_family(family))
    rules = (convert.dinov2_pose_rules(tm.vit.num_layers, tm.vit.lora_layers,
                                       len(tm.pose_heads.heatmap_head.upsampling))
             if family == "dinov2" else convert.fastvit_pose_rules(
                 tm.cfg, len(tm.backbone.head.heatmap_head.upsampling)))
    flat = {tuple(str(getattr(p, "key", p)) for p in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(jsh)[0]}
    assert len(rules) == len([k for k in got if not k.endswith("num_batches_tracked")])
    for rule in rules:
        jdim = _jax_dim(flat[rule.jax_path], jm_)
        want = None if jdim is None else _TORCH_DIM[rule.kind][jdim]
        assert got[rule.torch_key] == want, (rule, got[rule.torch_key], want)
    split = sorted(k for k, v in got.items() if v is not None)
    if shape == (2, 1):
        assert not split
    elif family == "dinov2":
        assert len(split) == 2 * 10
    else:
        ffn = [k for k in split if ".mlp.fc" in k]
        attn = [k for k in split if ".token_mixer." in k]
        assert len(ffn) % 3 == 0 and len(ffn) >= 9 and len(attn) >= 2


def test_shard_cutters_follow_the_table():
    """``ops/block.shard_attn``/``shard_mlp`` cut along the table's dims:
    moving a rule's dim moves the cut."""
    from dino_pose_tpu_torch.ops import block as tblock

    assert tsharding.vit_block_dims() == {"qkv": 0, "qkv_bias": 0, "out": 1, "fc1": 0,
                                          "fc1_bias": 0, "fc2": 1}
    d, h = 8, 32
    g = torch.Generator().manual_seed(0)
    ap = tblock.AttnParams(*(torch.randn(s, generator=g) for s in
                             ((d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,))))
    mp = tblock.MlpParams(*(torch.randn(s, generator=g) for s in
                            ((d,), (d,), (d, h), (h,), (h, d), (d,), (d,))))
    a1, m1 = tblock.shard_attn(ap, 2, 1), tblock.shard_mlp(mp, 2, 1)
    assert torch.equal(a1.wqkv[:, :4], ap.wqkv[:, 4:8]) and torch.equal(a1.wo, ap.wo[4:])
    assert torch.equal(m1.w1, mp.w1[:, 16:]) and torch.equal(m1.w2, mp.w2[16:])
    assert tsharding.shard_specs({"x": torch.zeros(3)}, Mesh(MeshSpec(1, 2))) == {"x": None}


# ---------------------------------------------------------------------------
# The loader's process shards against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coco10(tmp_path_factory):
    return write_coco(tmp_path_factory.mktemp("coco10"), 10, seed=4)


@pytest.mark.parametrize("nshards, drop_last", [(2, True), (3, True), (3, False), (4, False)])
def test_loader_shards_match_jax(coco10, monkeypatch, nshards, drop_last):
    """Rank r of n loads what JAX's process r of n loads: the same shared
    shuffle, equal shards padded with the epoch's leading indices (10 images
    do not divide over 3 or 4), the same batches bit for bit over two
    epochs, and the padded val tail (``drop_last=False``)."""
    images, ann = coco10
    _, _, preproc, _ = get_default_configs()
    common = dict(batch_size=2, num_workers=2, seed=3, drop_last=drop_last,
                  shard_by_process=True)
    tl = tdataset.create_dataloaders(preproc, MODEL, images, ann, **common)
    jl = jdataset.create_dataloaders(preproc, MODEL, images, ann, **common)
    seen = set()
    for r in range(nshards):
        monkeypatch.setattr(tdist, "data_shard", lambda r=r: (r, nshards))
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: nshards)
        tl.set_epoch(0)
        jl.set_epoch(0)
        per = -(-10 // nshards)  # the padded shard
        assert len(tl) == len(jl) == (per // 2 if drop_last else -(-per // 2))
        for _ in range(2):
            tb, jb = list(tl), list(jl)
            assert len(tb) == len(jb) == len(tl)
            for t, j in zip(tb, jb):
                if not drop_last:
                    (t, tv), (j, jv) = tdataset.pad_batch(t, 2), jdataset.pad_batch(j, 2)
                    assert np.array_equal(tv, jv)
                for k in j:
                    assert np.array_equal(t[k], j[k]), (r, k)
                seen.add(t["z_coords"].tobytes())
    assert len(seen) >= 8  # the shards cover the set


# ---------------------------------------------------------------------------
# Two ranks: the collectives, the meshes, fit's refusals, the PCKh split
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One run of two gloo ranks: collectives, the meshes and fit's
    refusals; and the dataset PCKh of test/vit-tiny + LoRA (JAX's variables,
    randomised) with its images split over the ranks, beside JAX's
    single-process value."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    config = {"model_name": "test/vit-tiny", "use_lora": True}
    jm = jregistry.create_model_from_config(dict(config), pretrained=False)
    jm.variables = _randomise(jax.device_get(jm.variables), np.random.default_rng(5))
    tm = tregistry.create_model_from_config(dict(config), device="cpu")
    weights = save_npz(tmp / "weights.npz", {k: v.numpy() for k, v in
                                             state_dict_from_jax(jm.variables, tm).items()})
    images, ann = write_coco(tmp / "pckh", 7, seed=3, sizes=EVEN_SIZES)
    train = write_coco(tmp / "train", 4, seed=6)
    d, t, p, m = get_default_configs()
    d.update(train_images_dir=str(train[0]), train_annotation_json=str(train[1]),
             val_images_dir="", val_annotation_json="")
    t.update(batch_size=2, num_epochs=1, checkpoint_dir=str(tmp / "ck"), multiprocessing_num=1)
    m.update(model_name="test/vit-tiny")
    run_ranks(tmp, [
        {"name": "collectives", "fit": [d, t, p, m]},
        {"name": "pckh", "config": config, "weights": weights, "images": str(images),
         "ann": str(ann)},
    ])
    want = jevaluate.compute_pckh_dataset(jm, images, ann, batch_size=2, num_workers=2,
                                          return_all=True)
    out = tmp / "out"
    return ([json.loads((out / f"collectives_{r}.json").read_text()) for r in range(2)],
            [json.loads((out / f"pckh_{r}.json").read_text()) for r in range(2)], want,
            tmp / "ck")


def test_broadcasts_from_the_primary(two_ranks):
    """broadcast_string hands rank 0's string (or None) to every rank;
    broadcast_state makes the other rank's weights, BatchNorm buffers, AdamW
    state (materialised where the rank had none), loss-weight state and
    scalars bit-equal to rank 0's."""
    (r0, r1), _, _, _ = two_ranks
    assert r0["already_up"] is r1["already_up"] is True
    assert (r0["world"], r0["rank"], r0["primary"]) == (2, 0, True)
    assert (r1["world"], r1["rank"], r1["primary"]) == (2, 1, False)
    assert r0["string"] == r1["string"] == "ckpt_of_rank_0.pth"
    assert r0["none"] is None and r1["none"] is None
    assert r0["scalars"] == r1["scalars"] == [7.0, 1e-4]
    assert r0["lw"] == r1["lw"] == [0.5, 1.5, 2.5, 1.0, 0.25, 3.0]
    assert r0["state"] == r1["state"] and r0["opt"] == r1["opt"]
    assert len(r1["opt"]) == 4 * 3 and r1["opt"]["0/step"] == 1.0


def test_structure_guard_raises_on_every_rank(two_ranks):
    (r0, r1), _, _, _ = two_ranks
    assert r0["guard"] == r1["guard"] == "differs: the structure differs across processes"


def test_meshes_across_ranks(two_ranks):
    """dp * tp must equal the world; the default mesh puts every rank on
    the data axis (rank = d * tp + m); the data sum runs over the ranks."""
    (r0, r1), _, _, _ = two_ranks
    for r in (r0, r1):
        ref = r["refusals"]
        assert "needs dp * tp = 1 processes, the launch has 2" in ref["1x1"]
        assert "needs dp * tp = 4 processes" in ref["2x2"]
        assert ref["1x2"] == ref["2x1"] == "made"
        assert r["data_sum"] == [2.0, 1.0]
    assert r0["default_mesh"] == [2, 1, 0, 0] and r1["default_mesh"] == [2, 1, 1, 0]
    assert r0["data_shard"] == [0, 2] and r1["data_shard"] == [1, 2]


def test_fit_refusals_across_ranks(two_ranks):
    """A model axis across ranks in fit trains (``test_torch_fastvit_tp.py``
    holds it bit for bit against one process) and only the primary writes;
    a global batch that does not divide over the data shards raises and
    writes no file."""
    (r0, r1), _, _, ck = two_ranks
    for r in (r0, r1):
        assert r["refusals"]["model_axis"] == "trained"
        assert "batch_size=3 must divide evenly over 2 data shards" in r["refusals"]["batch"]
    assert not ck.exists() or not os.listdir(ck)
    assert "final_model.pth" in os.listdir(f"{ck}_tp")


def test_pckh_split_over_ranks_matches_jax(two_ranks):
    """Rank 0 evaluates images 0, 2, 4, 6 and rank 1 images 1, 3, 5; the
    all-reduced means equal JAX's single-process values on every rank."""
    _, (p0, p1), want, _ = two_ranks
    assert (p0["local_images"], p1["local_images"]) == (4, 3)
    assert p0["total_images"] == p1["total_images"] == 7
    assert p0["metrics"] == p1["metrics"]
    assert p0["metrics"] == pytest.approx(want, abs=1e-6)
    assert 0 < p0["metrics"]["pckh"] < 1
