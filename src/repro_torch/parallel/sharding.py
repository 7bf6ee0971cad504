"""Logical-axis -> mesh-axis sharding rules (MaxText-style), PyTorch port
of ``repro.parallel.sharding``.

Every parameter/state leaf carries a tuple of logical axis names (the
families' ``logical_axes`` and ``cache_axes``).  A rules mapping turns
those into partition specs for a mesh.  Rules silently drop mesh axes
that the mesh does not have (so single-pod / multi-pod / test meshes
share one rule set).

A spec is a plain tuple, one entry per leading dimension: ``None``
(replicated), a mesh axis name, or a tuple of names (the counterpart of
``jax.sharding.PartitionSpec``, a tuple subclass).  A :class:`Sharding`
is ``(mesh, spec)``, the counterpart of ``NamedSharding``.  The port's
mesh is logical (``repro_torch.launch.mesh``): a sharding says what a
leaf's shard holds on each logical device, while the tensor itself lives
whole on the one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.parallel import ctx as pctx

Spec = Tuple[object, ...]

# Default rule set.  Values are mesh-axis names or tuples thereof.
DEFAULT_RULES: Dict[str, object] = {
    "embed": "data",          # FSDP: shard the d_model dim of weights
    "heads": "model",         # TP over attention heads
    "kv": "model",            # TP over kv heads (GSPMD pads if uneven)
    "mlp": "model",           # TP over FFN hidden
    "vocab": "model",         # TP over vocabulary
    "expert": "model",        # EP over experts
    "expert_mlp": "data",     # FSDP dim inside expert weights
    "layer": None,            # never shard the stacked-layer dim
    "batch": ("pod", "data"),  # data parallel over batch
    "kv_seq": "model",        # decode KV cache: sequence-sharded (SP)
    "seq": None,              # training activations: seq replicated
    "lru": "model",           # recurrent state width
    "state_v": "model",       # mLSTM matrix-memory value dim
}


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's spec over a mesh (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: Spec


def _axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_from_axes(axes: Tuple[Optional[str], ...], mesh,
                   rules: Dict[str, object] | None = None,
                   shape: Optional[Tuple[int, ...]] = None) -> Spec:
    """Map logical axes to a spec.

    A mesh axis is applied to a dim only if (a) it exists in the mesh,
    (b) it is not already used by another dim of this array, and (c) the
    dim size is divisible by it (pjit argument shardings must divide
    exactly — e.g. 8 GQA kv heads cannot shard over a 16-way model axis
    and fall back to replication)."""
    rules = rules or DEFAULT_RULES
    parts = []
    used = set()
    for i, ax in enumerate(axes):
        mapped = None if ax is None else rules.get(ax)
        if mapped is None:
            parts.append(None)
            continue
        eff = []
        dim = shape[i] if shape is not None else None
        div = 1
        for m in _axes(mapped):
            if m not in mesh.axis_names or m in used:
                continue
            sz = mesh.shape[m]
            if dim is not None and dim % (div * sz) != 0:
                continue
            eff.append(m)
            div *= sz
        used.update(eff)
        if not eff:
            parts.append(None)
        elif len(eff) == 1:
            parts.append(eff[0])
        else:
            parts.append(tuple(eff))
    return tuple(parts)


def _shape(leaf) -> Tuple[int, ...]:
    """A spec-tree leaf's shape: a shape tuple (``param_specs``), or
    anything with ``.shape`` (a tensor, an ``adamw.TensorSpec``)."""
    return tuple(getattr(leaf, "shape", leaf))


def shardings_from_axes(axes_tree, mesh,
                        rules: Dict[str, object] | None = None,
                        spec_tree=None):
    """Tree of logical-axis tuples (+ an optional tree of the leaves'
    shapes for divisibility checks, with the same keys) -> tree of
    :class:`Sharding`.  Raises ``ValueError`` where the two trees'
    keys differ, as ``jax.tree.map`` does."""
    def one(ax, leaf):
        if not ax:
            return Sharding(mesh, ())
        shape = _shape(leaf) if spec_tree is not None else None
        return Sharding(mesh, spec_from_axes(ax, mesh, rules, shape))

    def walk(ax, sp, path):
        if isinstance(ax, dict):
            if spec_tree is not None and (not isinstance(sp, dict)
                                          or set(sp) != set(ax)):
                where = path or "the root"
                raise ValueError(f"shardings_from_axes: at {where} the "
                                 f"axes and the specs differ in structure")
            return {k: walk(ax[k], None if sp is None else sp[k],
                            f"{path}[{k!r}]") for k in sorted(ax)}
        return one(ax, sp)

    return walk(axes_tree, spec_tree, "")


def batch_spec(mesh, ndim: int = 2) -> Spec:
    """(B, ...) inputs: batch over ('pod','data'), rest replicated."""
    ba = pctx.batch_axes(mesh)
    lead = ba[0] if len(ba) == 1 else ba
    return (lead,) + (None,) * (ndim - 1)


def batch_sharding(mesh, ndim: int = 2) -> Sharding:
    return Sharding(mesh, batch_spec(mesh, ndim))


def size_of_spec(spec: Spec, shape, mesh) -> int:
    """Per-device element count under a spec (for napkin math)."""
    per = math.prod(shape)
    for ax in spec:
        if ax is None:
            continue
        div = math.prod(mesh.shape[a] for a in _axes(ax))
        per //= max(1, div)
    return per


def check_sharding(sharding: Sharding, shape, where: str = "") -> None:
    """Raise ``ValueError`` unless every axis of ``sharding.spec`` is in
    its mesh and the dims it shards divide by their axes' sizes (what
    ``jax.device_put`` demands of a ``NamedSharding``)."""
    spec, mesh = sharding.spec, sharding.mesh
    if len(spec) > len(shape):
        raise ValueError(f"{where}: spec {spec} has more entries than the "
                         f"leaf's shape {tuple(shape)}")
    for dim, entry in zip(shape, spec):
        axes = _axes(entry)
        missing = [a for a in axes if a not in mesh.axis_names]
        if missing:
            raise ValueError(f"{where}: spec {spec} names axes {missing} "
                             f"that the mesh {mesh.shape} lacks")
        div = math.prod(mesh.shape[a] for a in axes)
        if dim % div:
            raise ValueError(f"{where}: spec {spec} splits a dim of "
                             f"{dim} over {div} shards (shape "
                             f"{tuple(shape)}, mesh {mesh.shape})")
