"""Carry a JAX parameter tree into the port.

``params_from_jax`` takes the JAX package's parameter tree with numpy
leaves (``jax.tree.map(np.asarray, params)``; layers stacked on a
leading ``L`` dimension) and returns the port's tree of tensors.  It
copies values and does no arithmetic, so the two packages compute the
same function from the same parameters.  bfloat16 leaves (numpy's
``bfloat16`` extension dtype) are carried bit for bit, and a leaf that
``param_specs`` marks float32 (``common.F32``: the recurrent families'
gate weights) stays float32 in a model of any dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.models.common import F32, ModelConfig


def _tensor(leaf) -> torch.Tensor:
    arr = np.array(leaf, order="C")        # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(cfg: ModelConfig, tree: dict, *, device,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The port's parameters from a JAX tree of numpy arrays, on
    ``device``, cast to ``dtype`` (default: ``cfg.dtype``) except the
    leaves marked float32, which stay float32.  The tree
    must have exactly the port's keys and shapes
    (``registry.param_specs(cfg)``)."""
    dtype = cfg.dtype if dtype is None else dtype

    def carry(spec, sub, path):
        if isinstance(spec, dict):
            if not isinstance(sub, dict) or set(sub) != set(spec):
                got = sorted(sub) if isinstance(sub, dict) else type(sub)
                raise ValueError(f"params_from_jax: {path or 'root'} has "
                                 f"keys {got}, expected {sorted(spec)}")
            return {k: carry(spec[k], sub[k], f"{path}/{k}") for k in spec}
        t = _tensor(sub)
        if tuple(t.shape) != tuple(spec):
            raise ValueError(f"params_from_jax: {path} has shape "
                             f"{tuple(t.shape)}, expected {tuple(spec)}")
        return t.to(device=device,
                    dtype=torch.float32 if isinstance(spec, F32) else dtype)

    return carry(registry.param_specs(cfg), tree, "")
