"""Mesh construction, PyTorch port of ``repro.launch.mesh``.

The port runs on one card, so a mesh here is logical: axis names and
sizes over that one device, with no collective behind it.  A mesh of
more than one device cannot be built (``make_production_mesh`` needs
256; ROADMAP A12 holds the mesh code).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Axis names and sizes over the one device (the counterpart of a
    ``jax.sharding.Mesh``'s ``shape`` and ``axis_names``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    raise NotImplementedError(
        f"make_production_mesh: a {shape} mesh needs {math.prod(shape)} "
        f"devices; the port runs on one card (ROADMAP A12)")


def make_test_mesh(data: int = 1, model: int = 1, pod: int = 0):
    """A mesh over the one device: every axis size must be 1."""
    names = (("pod",) if pod else ()) + ("data", "model")
    sizes = ((pod,) if pod else ()) + (data, model)
    if math.prod(sizes) != 1:
        raise ValueError(f"make_test_mesh: {dict(zip(names, sizes))} needs "
                         f"{math.prod(sizes)} devices; the port runs on one "
                         f"(ROADMAP A12)")
    return LogicalMesh(names, sizes)
