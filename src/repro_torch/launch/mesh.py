"""Mesh construction, PyTorch port of ``repro.launch.mesh``.

The port runs on one card, so a mesh here is logical: axis names and
sizes of any shape over that one device.  The mesh-aware blocks
(``parallel.sharding``, the expert-parallel MoE, ``tp_attention``,
``sp_decode``) compute under it what the JAX package's blocks compute on
a real mesh of that shape: a collective becomes a reduction or a
permutation over a shard axis on the one device, and nothing is placed
on another device.  ``make_production_mesh`` gives the (16, 16) and
(2, 16, 16) meshes of the dry run (``repro_torch.launch.dryrun``), which
counts one chip's program of them on meta tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Axis names and sizes over the one device (the counterpart of a
    ``jax.sharding.Mesh``'s ``shape``, ``axis_names`` and ``devices``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"LogicalMesh: {len(self.axis_names)} names, "
                             f"{len(self.sizes)} sizes")
        if any(int(n) < 1 for n in self.sizes):
            raise ValueError(f"LogicalMesh: axis sizes {self.sizes} must "
                             f"be at least 1")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def devices(self) -> np.ndarray:
        """The logical devices' ids in mesh order, shaped like the mesh
        (``devices.size`` devices, all on the one card)."""
        return np.arange(math.prod(self.sizes)).reshape(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The production mesh, logical: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model"), the JAX package's
    axes.  The dry run (``repro_torch.launch.dryrun``) counts one chip's
    program of it; nothing runs on 256 or 512 devices."""
    if multi_pod:
        return LogicalMesh(("pod", "data", "model"), (2, 16, 16))
    return LogicalMesh(("data", "model"), (16, 16))


def make_test_mesh(data: int = 1, model: int = 1, pod: int = 0):
    """A logical mesh of these sizes over the one device, with the JAX
    signature: axes ("data", "model"), or ("pod", "data", "model") when
    ``pod`` is given."""
    if pod:
        return LogicalMesh(("pod", "data", "model"), (pod, data, model))
    return LogicalMesh(("data", "model"), (data, model))
