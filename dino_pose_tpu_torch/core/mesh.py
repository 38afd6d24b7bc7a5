"""The ('data', 'model') mesh on one card (counterpart of dino_pose_tpu/core/mesh.py).

The JAX package shards attention heads and MLP hidden units over the mesh's
``'model'`` axis (Megatron layout, one ``psum`` per half,
``ops/block.attn_part_tp``/``mlp_part_tp``). Here every shard of that axis
lives on the one card: each shard's kernel launches in rank order on its own
weight slice, and the ``psum`` is :meth:`Mesh.all_reduce`, a sum of the
shards' partials in rank order. That is what the JAX package computes when
it runs its mesh on virtual CPU devices (``tests/test_block_tp.py``), with
the same rounding points: XLA's all-reduce of bf16 partials sums them in
f32 and rounds once, and the transpose of a replicated shard input sums the
shards' cotangents the same way (:meth:`Mesh.replicate`).

The batch is not split: ``dp > 1`` needs more than one card, and the
``torch.distributed`` all-reduce across cards is a later slice. This object
is the only place that changes then.
"""

from __future__ import annotations

import dataclasses

import torch

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


class Mesh:
    """``('data', 'model')`` mesh of ``spec.tp`` model shards on one device.
    It holds no device of its own: each shard's work runs where the tensors
    it is given lie."""

    def __init__(self, spec: MeshSpec):
        self.spec = spec

    @property
    def tp(self) -> int:
        return self.spec.tp

    def all_reduce(self, parts) -> torch.Tensor:
        """The model axis's psum of one partial per shard, in rank order."""
        if len(parts) != self.tp:
            raise ValueError(f"all_reduce: {len(parts)} partials for {self.tp} model shards")
        if len(parts) == 1:
            return parts[0]
        return _AllReduce.apply(*parts)

    def replicate(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` as each model shard reads it; under autograd the shards'
        cotangents reach ``x`` summed in rank order."""
        if self.tp == 1 or not (torch.is_grad_enabled() and x.requires_grad):
            return [x] * self.tp
        return list(_Replicate.apply(x, self.tp))

    def __repr__(self) -> str:
        return f"Mesh(data={self.spec.dp}, model={self.spec.tp})"


def create_mesh(spec: MeshSpec | None = None,
                device: str | torch.device | None = None) -> Mesh:
    """A ``('data', 'model')`` mesh, recorded as the target of the next
    forwards (``ops/dispatch.target_mesh``), as JAX's ``create_mesh`` records
    its own. ``device`` (default ``cuda``) must exist: without a card the
    default raises (``core/device.resolve_device``); the shards' work runs
    on the device of the tensors. With no spec, one shard on each axis.
    ``dp > 1`` raises: splitting the batch needs more than one card."""
    spec = MeshSpec() if spec is None else spec
    if spec.dp < 1 or spec.tp < 1:
        raise ValueError(f"mesh {spec.dp}x{spec.tp}: both axes need at least one shard")
    if spec.dp != 1:
        raise ValueError(
            f"mesh {spec.dp}x{spec.tp}: the batch is not split on one card (dp must be 1)"
        )
    resolve_device(device)
    mesh = Mesh(spec)
    dispatch.configure_for_mesh(mesh)
    return mesh
