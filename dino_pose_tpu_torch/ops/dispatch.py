"""The mesh the next forward runs on (counterpart of dino_pose_tpu/ops/dispatch.py).

``core.mesh.create_mesh`` records its mesh here, as JAX's ``configure_for_mesh``
does, and ``models/vit.Block.forward`` reads it at call time: under a mesh
whose ``'model'`` axis holds more than one shard a block takes the
tensor-parallel halves (``ops/block.block_route(..., tp=)``). With no mesh
recorded every block runs as on one device.

The target is process-global state, so a caller that builds a mesh for one
computation wraps it in :func:`scoped`, and host-local work that must not
inherit a mesh runs under :func:`local`.
"""

from __future__ import annotations

import contextlib

_MESH = None


def configure_for_mesh(mesh) -> None:
    """Record the mesh the next forwards run on."""
    global _MESH
    _MESH = mesh


def target_mesh():
    """The recorded mesh, or None for the one-device path."""
    return _MESH


@contextlib.contextmanager
def scoped():
    """Restore the recorded mesh on exit, so that no later computation
    inherits a mesh built inside the block."""
    global _MESH
    prev = _MESH
    try:
        yield
    finally:
        _MESH = prev


@contextlib.contextmanager
def local():
    """Run the block with no mesh (the one-device path), restoring the
    previous target on exit."""
    global _MESH
    prev = _MESH
    _MESH = None
    try:
        yield
    finally:
        _MESH = prev
