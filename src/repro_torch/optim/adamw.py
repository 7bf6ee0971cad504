"""AdamW, PyTorch port of ``repro.optim.adamw``.

Moments are float32; parameters stay in their storage dtype (bf16) with
float32 update arithmetic and no master copy, as in the JAX package.
The arithmetic is ``src/repro/optim/adamw.py``'s: the clip scale comes
from the global norm of the gradients, ``b1 ** count`` is computed in
float32, the update runs in float32 and the parameter is cast back to
its dtype.  Weight decay applies to leaves with ``ndim >= 2`` of the
stacked tree, so the stacked norm scales of shape (L, d) are decayed,
exactly as in the JAX package.

Where the JAX package builds new trees (and donates the old buffers),
:func:`adamw_update` updates parameters and moments in place under
``torch.no_grad()``, one leaf at a time: the float32 gradient is made
per leaf, so no whole float32 gradient tree ever exists (at qwen3_4b's
full width it alone would be 17.6 GB).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a state leaf, allocated nowhere (the counterpart
    of ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def tree_leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree.flatten`` order: dict keys sorted, depth
    first."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``) in :func:`tree_leaves` order, keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def adamw_init(params) -> dict:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_specs(param_specs) -> dict:
    """The optimizer state's :class:`TensorSpec` tree from a parameter
    spec tree (shape tuples at the leaves, ``registry.param_specs``)."""
    def f32(shape):
        return TensorSpec(tuple(shape), torch.float32)
    return {"m": tree_map(f32, param_specs), "v": tree_map(f32, param_specs),
            "count": TensorSpec((), torch.int32)}


def opt_state_axes(param_axes) -> dict:
    return {"m": tree_map(lambda a: a, param_axes),
            "v": tree_map(lambda a: a, param_axes), "count": ()}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf, summed leaf by
    leaf in tree order."""
    total = None
    for g in tree_leaves(grads):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, params, state: dict,
                 lr: torch.Tensor) -> Tuple[Any, dict, dict]:
    """One AdamW step; returns ``(params, state, metrics)``.  ``params``,
    ``state["m"]`` and ``state["v"]`` are updated in place and returned;
    ``state["count"]`` is a new tensor.  ``grads`` has the parameters'
    tree."""
    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    count = state["count"] + 1
    countf = count.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                      device=countf.device), countf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                      device=countf.device), countf)
    lr = lr.to(torch.float32)
    for g, p, m, v in zip(flat_g, flat_p, tree_leaves(state["m"]),
                          tree_leaves(state["v"])):
        # separate products and sums (no fused multiply-add), as jnp
        g32 = g.float() * scale
        m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g32.square_().mul_(1 - cfg.b2))
        del g32
        step = (m / c1).div_((v / c2).sqrt_().add_(cfg.eps))
        p32 = p.float()
        if p.dim() >= 2:  # decay matrices only (norms/bias excluded)
            step.add_(p32 * cfg.weight_decay)
        p.copy_(p32.sub_(step.mul_(lr)))
        del step, p32
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "count": count}, metrics
