"""The ('data', 'model') mesh (counterpart of dino_pose_tpu/core/mesh.py).

The JAX package shards the batch over the mesh's ``'data'`` axis and
attention heads and MLP hidden units over its ``'model'`` axis (Megatron
layout, one ``psum`` per half): dinov2's blocks through
``ops/block.attn_part_tp``/``mlp_part_tp``, FastViT's ConvFFN hidden units
and attention heads through ``models/fastvit.ConvFFN._tp_rows`` and
``SpatialAttention._tp`` (cut along ``core/sharding.fastvit_dims``).

In one process (no ``torch.distributed`` group, or a world of one) every
shard of the model axis lives on the one card: each shard's kernel launches
in rank order on its own weight slice, and the ``psum`` is
:meth:`Mesh.all_reduce`, a sum of the shards' partials in rank order. That
is what the JAX package computes when it runs its mesh on virtual CPU
devices (``tests/test_block_tp.py``), with the same rounding points: XLA's
all-reduce of bf16 partials sums them in f32 and rounds once, and the
transpose of a replicated shard input sums the shards' cotangents the same
way (:meth:`Mesh.replicate`). The batch is not split there: ``dp`` is 1.

Across processes the mesh is laid over the ranks as JAX's reshape lays it
over devices, the model axis fastest: rank = ``d * tp + m``. Each rank
holds one data shard of the batch and one model shard of each block; it
belongs to one data group (the ranks of its model coordinate) and one model
group (the ranks of its data coordinate), made with ``dist.new_group`` on
every rank in the same order. The model axis's all-reduce and the
transpose of its replication become collectives over the model group, in
f32 and rounded once; the data axis's sums are ``core/distributed``'s.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from dino_pose_tpu_torch.core import distributed
from dino_pose_tpu_torch.core.device import resolve_device
from dino_pose_tpu_torch.ops import dispatch


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape: ``dp`` batch shards, ``tp`` model shards."""

    dp: int = 1
    tp: int = 1


def _sum_in_order(parts) -> torch.Tensor:
    """Sum of ``parts`` in rank order, in f32, rounded once to their dtype."""
    out = parts[0].float()
    for p in parts[1:]:
        out = out + p.float()
    return out.to(parts[0].dtype)


def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks in f32, rounded once to its dtype."""
    out = t.float().clone()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _AllReduce(torch.autograd.Function):
    """psum over the model axis: the partials summed in rank order (f32,
    one rounding); every shard gets the cotangent of the sum."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.n = len(parts)
        return _sum_in_order(parts)

    @staticmethod
    def backward(ctx, g):
        return (g,) * ctx.n


class _Replicate(torch.autograd.Function):
    """A tensor replicated over the model axis: each shard reads it as it is,
    and its cotangent is the shards' cotangents summed in rank order (f32,
    one rounding), the transpose of a replicated shard_map input."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        present = [g for g in grads if g is not None]
        return (_sum_in_order(present) if present else None), None


class _AllReduceAcross(torch.autograd.Function):
    """psum over a model group of ranks: this rank's partial summed with
    the others' (f32, one rounding). Its cotangent passes through as it is:
    every model rank already holds the cotangent of the sum, and summing it
    would scale it by tp."""

    @staticmethod
    def forward(ctx, part, group):
        return _sum_over(part, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicateAcross(torch.autograd.Function):
    """A tensor every model rank reads: its cotangent is the model ranks'
    cotangents summed over the model group (f32, one rounding)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class Mesh:
    """``('data', 'model')`` mesh of ``spec.dp`` x ``spec.tp`` shards. In one
    process it holds the ``tp`` model shards of one data shard; across
    ``dp * tp`` ranks this rank's coordinates and groups. It holds no device
    of its own: each shard's work runs where the tensors it is given lie."""

    def __init__(self, spec: MeshSpec, *, rank: int = 0, world: int = 1,
                 data_group=None, model_group=None):
        self.spec = spec
        self.world = world
        self.rank = rank
        self.data_rank, self.model_rank = divmod(rank, spec.tp)
        self.data_group = data_group
        self.model_group = model_group

    @property
    def tp(self) -> int:
        return self.spec.tp

    @property
    def data_size(self) -> int:
        return self.spec.dp

    @property
    def model_spans_ranks(self) -> bool:
        return self.world > 1 and self.tp > 1

    @property
    def local_model_ranks(self) -> range:
        """The model shards this process computes: all ``tp`` in one
        process, its own across ranks."""
        if self.model_spans_ranks:
            return range(self.model_rank, self.model_rank + 1)
        return range(self.tp)

    def all_reduce(self, parts) -> torch.Tensor:
        """The model axis's psum of one partial per local shard, in rank
        order."""
        if len(parts) != len(self.local_model_ranks):
            raise ValueError(f"all_reduce: {len(parts)} partials for "
                             f"{len(self.local_model_ranks)} local model shards")
        if self.model_spans_ranks:
            return _AllReduceAcross.apply(parts[0], self.model_group)
        if len(parts) == 1:
            return parts[0]
        return _AllReduce.apply(*parts)

    def replicate(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` as each local model shard reads it; under autograd the
        shards' cotangents reach ``x`` summed in rank order."""
        n = len(self.local_model_ranks)
        if self.tp == 1 or not (torch.is_grad_enabled() and x.requires_grad):
            return [x] * n
        if self.model_spans_ranks:
            return [_ReplicateAcross.apply(x, self.model_group)]
        return list(_Replicate.apply(x, self.tp))

    def __repr__(self) -> str:
        where = f", rank={self.rank} of {self.world}" if self.world > 1 else ""
        return f"Mesh(data={self.spec.dp}, model={self.spec.tp}{where})"


def _groups(spec: MeshSpec, rank: int, world: int) -> tuple:
    """This rank's (data group, model group). Every rank creates every group,
    in the same order; a group of every rank is the world's, and a group of
    one rank is None."""

    def make(ranks: list[int]):
        if len(ranks) == world:
            return dist.group.WORLD
        return dist.new_group(ranks) if len(ranks) > 1 else None

    dp, tp = spec.dp, spec.tp
    data = model = None
    for d in range(dp):
        g = make([d * tp + m for m in range(tp)])
        if rank // tp == d:
            model = g
    for m in range(tp):
        g = make([d * tp + m for d in range(dp)])
        if rank % tp == m:
            data = g
    return data, model


def create_mesh(spec: MeshSpec | None = None,
                device: str | torch.device | None = None) -> Mesh:
    """A ``('data', 'model')`` mesh, recorded as the target of the next
    forwards (``ops/dispatch.target_mesh``), as JAX's ``create_mesh`` records
    its own. ``device`` (default: this rank's card) must exist: without a
    card the default raises (``core/device.resolve_device``); the shards'
    work runs on the device of the tensors.

    With no spec every process is a data shard (``dp = world, tp = 1``, as
    JAX's all-devices-on-data default). Across processes ``dp * tp`` must
    equal the world; in one process ``dp`` must be 1: a process holds one
    data shard."""
    world = distributed.world_size()
    spec = MeshSpec(dp=world) if spec is None else spec
    if spec.dp < 1 or spec.tp < 1:
        raise ValueError(f"mesh {spec.dp}x{spec.tp}: both axes need at least one shard")
    if world == 1 and spec.dp != 1:
        raise ValueError(
            f"mesh {spec.dp}x{spec.tp}: one process holds one data shard (dp must be 1); "
            "dp > 1 needs a multi-process launch (core/distributed.py)"
        )
    if world > 1 and spec.dp * spec.tp != world:
        raise ValueError(
            f"mesh {spec.dp}x{spec.tp} needs dp * tp = {spec.dp * spec.tp} processes, "
            f"the launch has {world}"
        )
    resolve_device(device)
    if world == 1:
        mesh = Mesh(spec)
    else:
        rank = distributed.rank()
        data, model = _groups(spec, rank, world)
        mesh = Mesh(spec, rank=rank, world=world, data_group=data, model_group=model)
    dispatch.configure_for_mesh(mesh)
    return mesh
