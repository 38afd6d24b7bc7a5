"""Multi-process runtime on ``torch.distributed`` (counterpart of
dino_pose_tpu/core/distributed.py).

One process per card. Every process runs the same program on its own
shard of the global batch; the collectives below make each step the global
batch's step, as JAX's one program over a global array is:

- the losses divide by the global valid count and the dynamic loss weights
  update from the all-reduced global losses (``train/losses.py``,
  ``train/step.py``);
- the trainable gradients are summed over the data group after the
  backward (:func:`all_reduce_grads`);
- BatchNorm's train-mode sums are all-reduced over the data group in f32
  before they divide (:func:`data_mean`), and under autograd the cotangent
  of such a sum is all-reduced too, since each rank's loss part differs;
- dropout draws the global batch's mask from the step generator and keeps
  the rank's rows (:func:`batch_rand`).

The data group and the rank's coordinates come from the mesh that
``core/mesh.create_mesh`` records (``ops/dispatch.target_mesh``); with no
mesh recorded, or one data shard, every function here is the one-process
computation, bit for bit.

Launch contracts, read in this order (one process per card):

    torchrun --nproc_per_node=8 -m dino_pose_tpu_torch.cli.train ...
        (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
    JAX_COORDINATOR_ADDRESS=host0:1234 JAX_NUM_PROCESSES=4 JAX_PROCESS_ID=<0..3> \
        python -m dino_pose_tpu_torch.cli.train ...
        (JAX's contract is one process per host: the local rank is
        ``LOCAL_RANK`` where it is set, else 0)
    SLURM_NTASKS (or SLURM_NPROCS) > 1 with SLURM_PROCID and SLURM_LOCALID,
        and MASTER_ADDR + MASTER_PORT or JAX_COORDINATOR_ADDRESS

A contract that asks for more than one process but lacks a variable raises:
nothing is guessed, because a wrong guess silently trains N independent
models that all believe they are the primary writer.

``make_global_batch`` has no counterpart: each rank keeps its local shard
of the batch, and the collectives above stand where XLA's global array
would.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import math
import os
from typing import Mapping, NamedTuple, Sequence

import torch
import torch.distributed as dist

from dino_pose_tpu_torch.ops import dispatch

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class Launch:
    """A launch contract read from the environment."""

    world: int
    rank: int
    local_rank: int
    init_method: str
    source: str  # "torchrun", "jax" or "slurm"


def _need(env: Mapping[str, str], source: str, *names: str) -> list[str]:
    missing = [n for n in names if not env.get(n)]
    if missing:
        raise RuntimeError(
            f"incomplete {source} launch: {', '.join(missing)} not set (have "
            f"{ {k: env[k] for k in names if env.get(k)} }); set every variable of the "
            "contract (core/distributed.py) or launch a single process"
        )
    return [env[n] for n in names]


def _address(env: Mapping[str, str], source: str) -> str:
    """MASTER_ADDR:MASTER_PORT, else JAX's coordinator address."""
    if env.get("JAX_COORDINATOR_ADDRESS") and not (env.get("MASTER_ADDR")
                                                   or env.get("MASTER_PORT")):
        return f"tcp://{env['JAX_COORDINATOR_ADDRESS']}"
    addr, port = _need(env, source, "MASTER_ADDR", "MASTER_PORT")
    return f"tcp://{addr}:{port}"


def launch_contract(env: Mapping[str, str] | None = None) -> Launch | None:
    """The launch the environment describes, or None for a single process.
    Raises ``RuntimeError`` on a contract that asks for more than one
    process and lacks a variable."""
    env = os.environ if env is None else env
    if env.get("WORLD_SIZE"):
        world = int(env["WORLD_SIZE"])
        if world == 1 and not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
            return None
        rank, local = (int(v) for v in _need(env, "torchrun", "RANK", "LOCAL_RANK"))
        return Launch(world, rank, local, _address(env, "torchrun"), "torchrun")
    if int(env.get("JAX_NUM_PROCESSES") or 1) > 1:
        coord, pid = _need(env, "JAX", "JAX_COORDINATOR_ADDRESS", "JAX_PROCESS_ID")
        return Launch(int(env["JAX_NUM_PROCESSES"]), int(pid), int(env.get("LOCAL_RANK") or 0),
                      f"tcp://{coord}", "jax")
    ntasks = env.get("SLURM_NTASKS") or env.get("SLURM_NPROCS")
    if int(ntasks or 1) > 1:
        rank, local = (int(v) for v in _need(env, "SLURM", "SLURM_PROCID", "SLURM_LOCALID"))
        return Launch(int(ntasks), rank, local, _address(env, "SLURM"), "slurm")
    return None


def maybe_initialize_distributed(device: str | torch.device | None = None, *,
                                 backend: str | None = None) -> bool:
    """Initialise ``torch.distributed`` when the environment describes a
    launch; returns True when this run is multi-process.

    A no-op when a process group is already up (whoever made it) and in a
    single-process run. ``device`` (default: this rank's card,
    ``core/device.resolve_device``) picks the backend: ``nccl`` for a CUDA
    device, ``gloo`` for the CPU; ``backend`` overrides it (``gloo`` with
    CUDA tensors runs two ranks on one card). A missing NCCL raises; there
    is no fallback to gloo. A collective that waits longer than
    ``DEFAULT_TIMEOUT`` fails. Right after the group is up one tiny
    all-reduce runs, so that NCCL builds its communicator while every rank
    is at the same point, not at the first step after each rank's build."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    launch = launch_contract()
    if launch is None:
        return False
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    from dino_pose_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("NCCL is not available in this torch build; a CUDA launch needs it")
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=launch.init_method, world_size=launch.world,
                            rank=launch.rank, timeout=DEFAULT_TIMEOUT, **kw)
    dist.all_reduce(torch.zeros(1, device=collective_device()))
    return launch.world > 1


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Processes in the group (1 with none)."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank (0 with no group)."""
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns checkpoint and metrics writes."""
    return rank() == 0


def _local_processes(env: Mapping[str, str]) -> int:
    """The processes this launch runs on this host: torchrun's
    ``LOCAL_WORLD_SIZE``, SLURM's tasks a node, else one (JAX's contract:
    one process a host)."""
    for name in ("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE"):
        digits = (env.get(name) or "").split("(")[0]
        if digits.isdigit():
            return int(digits)
    return 1


def unused_cards_warning(device: str | torch.device,
                         env: Mapping[str, str] | None = None) -> str | None:
    """One line of warning where this host shows more CUDA devices than its
    launch runs processes (a process trains on one card), else None."""
    env = os.environ if env is None else env
    visible, local = torch.cuda.device_count(), _local_processes(env)
    if visible <= local:
        return None
    return (f"Warning: {visible} CUDA devices are visible and this host runs {local} "
            f"process{'es' if local > 1 else ''} of the launch; this process trains on "
            f"{device} alone (the port runs one process a card). To train on every card, "
            f"launch one process per card: torchrun --nproc_per_node={visible} -m "
            "dino_pose_tpu_torch.cli.train --config_file <file> (or one JAX_PROCESS_ID "
            "or SLURM task per card, each with its LOCAL_RANK).")


def collective_device() -> torch.device:
    """Where this group's collectives take their tensors: the current card
    under NCCL, the host under gloo."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_string(s: str | None, max_len: int = 4096) -> str | None:
    """``s`` as process 0 has it (e.g. a resolved checkpoint path), through
    a fixed ``max_len``-byte buffer; identity without a group."""
    if not is_initialized():
        return s
    data = (s or "").encode()[:max_len].ljust(max_len, b"\0")
    buf = torch.tensor(list(data), dtype=torch.uint8, device=collective_device())
    dist.broadcast(buf, src=0)
    decoded = bytes(buf.cpu().tolist()).rstrip(b"\x00").decode()
    return decoded or None


def _broadcast_(t: torch.Tensor) -> None:
    """Broadcast ``t`` from rank 0 in place, through the collective device
    where it lies elsewhere (AdamW's ``step`` tensors live on the host)."""
    dev = collective_device()
    if t.device == dev or dev.type == "cpu":
        dist.broadcast(t, src=0)
        return
    tmp = t.to(dev)
    dist.broadcast(tmp, src=0)
    t.copy_(tmp)


def _materialize_adamw_state(optimizer: torch.optim.Optimizer) -> None:
    """Give every parameter of ``optimizer`` AdamW's state as its first step
    would create it (``step`` 0 on the host, zero moments) where it has none;
    the next step behaves as on a fresh state."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state[p]
            if not st:
                st["step"] = torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def state_description(model: torch.nn.Module, optimizer: torch.optim.Optimizer | None) -> str:
    """The structure of a train state: every state-dict key with its shape
    and dtype, and the optimizer's parameter shapes."""
    parts = [f"{k}{tuple(v.shape)}{v.dtype}" for k, v in model.state_dict().items()]
    if optimizer is not None:
        parts += [f"opt{tuple(p.shape)}{p.dtype}" for g in optimizer.param_groups
                  for p in g["params"]]
    return ";".join(parts)


def values_digest(model: torch.nn.Module) -> str:
    """A digest of the values of ``model``'s trainable parameters and
    floating buffers (the BatchNorm running statistics): what a train step
    changes."""
    h = hashlib.sha256()
    tensors = [p for p in model.parameters() if p.requires_grad]
    tensors += [b for b in model.buffers() if b.is_floating_point()]
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def check_same_structure(description: str, what: str, noun: str = "structure") -> None:
    """Raise on every rank unless ``description`` is the same on all of
    them: the primary's digest is broadcast, each rank compares, and a
    mismatch flag is all-reduced. Nothing without a group. ``noun`` names
    what the description describes, in the error."""
    if not is_initialized():
        return
    mine = int.from_bytes(hashlib.sha256(description.encode()).digest()[:7], "little")
    dev = collective_device()
    digest = torch.tensor([mine], dtype=torch.int64, device=dev)
    dist.broadcast(digest, src=0)
    flag = torch.tensor([int(digest.item() != mine)], dtype=torch.int64, device=dev)
    dist.all_reduce(flag)
    if flag.item():
        raise RuntimeError(f"{what}: the {noun} differs across processes")


def broadcast_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer | None = None,
                    loss_weight=None, scalars: Sequence[float] = ()):
    """Make every rank's train state bit-identical to rank 0's: the model's
    parameters and buffers, AdamW's state (materialised first where a rank
    has none, see :func:`_materialize_adamw_state`), the loss-weight state
    (a ``train/weighting.LossWeightState`` or None) and ``scalars`` (the
    epoch, the step, the scheduler's fields: as f64). Returns
    ``(loss_weight, scalars)`` as rank 0 has them; identity without a
    group. Replicated values that disagree would corrupt training with no
    error raised."""
    if not is_initialized():
        return loss_weight, list(scalars)
    with torch.no_grad():
        for t in model.state_dict().values():
            _broadcast_(t)
        if optimizer is not None:
            has = torch.tensor([float(bool(optimizer.state))], device=collective_device())
            dist.broadcast(has, src=0)
            if has.item():
                _materialize_adamw_state(optimizer)
                for group in optimizer.param_groups:
                    for p in group["params"]:
                        st = optimizer.state[p]
                        for k in sorted(st):
                            _broadcast_(st[k])
    if loss_weight is not None:
        fields = [f.name for f in dataclasses.fields(loss_weight)]
        vals = torch.stack([getattr(loss_weight, f).double() for f in fields]).to(
            collective_device())
        dist.broadcast(vals, src=0)
        loss_weight = dataclasses.replace(loss_weight, **{
            f: v.to(getattr(loss_weight, f).device, getattr(loss_weight, f).dtype)
            for f, v in zip(fields, vals)})
    out = list(scalars)
    if out:
        vals = torch.tensor(out, dtype=torch.float64, device=collective_device())
        dist.broadcast(vals, src=0)
        out = vals.cpu().tolist()
    return loss_weight, out


# ---------------------------------------------------------------------------
# The data axis of the recorded mesh
# ---------------------------------------------------------------------------

class DataAxis(NamedTuple):
    group: object   # the torch.distributed group of this rank's data ranks
    size: int       # data shards (the mesh's dp)
    rank: int       # this rank's data coordinate


def data_axis() -> DataAxis | None:
    """The recorded mesh's data axis where it spans more than one rank,
    else None (one process, no mesh, ``dispatch.local()``, or dp == 1)."""
    mesh = dispatch.target_mesh()
    if mesh is None or mesh.data_size == 1:
        return None
    return DataAxis(mesh.data_group, mesh.data_size, mesh.data_rank)


def data_shard() -> tuple[int, int]:
    """(this rank's data coordinate, data shards) for the input pipeline:
    the recorded mesh's, else the process group's, else (0, 1)."""
    mesh = dispatch.target_mesh()
    if mesh is not None:
        return mesh.data_rank, mesh.data_size
    return rank(), world_size()


def data_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group, in f32 (no autograd); ``t`` itself
    without a data axis."""
    axis = data_axis()
    if axis is None:
        return t
    out = t.detach().float().clone()
    dist.all_reduce(out, group=axis.group)
    return out


class _DataSum(torch.autograd.Function):
    """A sum over the data group whose cotangent is summed over it too:
    every rank's loss part reads the global sum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.float().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def data_mean(t: torch.Tensor, dim: Sequence[int]) -> torch.Tensor:
    """``t.mean(dim)`` over the global batch: this rank's sum all-reduced
    over the data group in f32 before the divide, under autograd through
    :class:`_DataSum`. Without a data axis, ``t.mean(dim)`` itself."""
    axis = data_axis()
    if axis is None:
        return t.mean(dim=tuple(dim))
    n = math.prod(t.shape[d] for d in dim) * axis.size
    return _DataSum.apply(t.float().sum(dim=tuple(dim)), axis.group) / n


def data_matmul_mean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b / n`` for a product that contracts the batch's ``n`` rows,
    over the global batch (the product all-reduced before the divide)."""
    n = a.shape[-1]
    axis = data_axis()
    if axis is None:
        return a @ b / n
    return _DataSum.apply(a @ b, axis.group) / (n * axis.size)


def data_count(n: int) -> int:
    """A count of this rank's positions as the global batch's count."""
    axis = data_axis()
    return n if axis is None else n * axis.size


def batch_rand(shape: Sequence[int], generator: torch.Generator | None,
               device: torch.device) -> torch.Tensor:
    """``torch.rand(shape)`` for a batch-leading ``shape``: with a data
    axis, the global batch's draw (``shape[0] * dp`` rows) and this rank's
    rows of it, so that no two ranks share mask bits and a dp-rank run
    draws what one process draws for the global batch."""
    axis = data_axis()
    if axis is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    b = shape[0]
    full = torch.rand((b * axis.size, *shape[1:]), generator=generator, device=device)
    return full[axis.rank * b:(axis.rank + 1) * b]


def all_reduce_grads(params: Sequence[torch.Tensor]) -> None:
    """Sum the gradients of ``params`` over the data group, in place, one
    all-reduce per dtype; nothing without a data axis. A parameter
    replicated over the model axis has the same gradient on every model
    rank, so the model group takes no part."""
    axis = data_axis()
    if axis is None:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=axis.group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
