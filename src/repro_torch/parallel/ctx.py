"""Mesh context threaded through model code, PyTorch port of
``repro.parallel.ctx``.

The step builders and the trainer set the active mesh with
``use_mesh``; the communication-aware blocks consult it (MoE expert
parallelism, sequence-sharded decode, ``tp_attention``).  The port runs
on one card, where the mesh is logical (``repro_torch.launch.mesh``):
those blocks compute what the JAX package's compute on a real mesh of
the same shape, their collectives done over a shard axis on the one
device.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Tuple

_STATE = threading.local()


def set_mesh(mesh) -> None:
    _STATE.mesh = mesh


def get_mesh():
    return getattr(_STATE, "mesh", None)


@contextmanager
def use_mesh(mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def set_unroll(flag: bool) -> None:
    """Counting mode of the JAX package's dry runs (unroll inner chunk
    loops); kept for the API, read by ``train.step``'s microbatch loop."""
    _STATE.unroll = bool(flag)


def get_unroll() -> bool:
    return getattr(_STATE, "unroll", False)


@contextmanager
def use_unroll(flag: bool = True):
    prev = get_unroll()
    set_unroll(flag)
    try:
        yield
    finally:
        set_unroll(prev)


def get_chip() -> bool:
    """One chip's program (the dry run, ``repro_torch.launch.dryrun``):
    a block that computes a mesh's shards side by side computes only
    the first, the one this chip holds."""
    return getattr(_STATE, "chip", False)


@contextmanager
def use_chip():
    """Runs the block as one chip's program (see :func:`get_chip`)."""
    prev = get_chip()
    _STATE.chip = True
    try:
        yield
    finally:
        _STATE.chip = prev


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes over which the global batch is sharded."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    out = 1
    for a in batch_axes(mesh):
        out *= mesh.shape[a]
    return out
