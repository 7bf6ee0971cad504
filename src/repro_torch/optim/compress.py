"""Gradient compression (int8, per-tensor scale) with error feedback,
PyTorch port of ``repro.optim.compress``.

Quantize -> (the all-reduce would run on the int8 representation) ->
dequantize, with the quantization residual carried to the next step.
On one device there is no collective; what runs is the numerically
faithful transform.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import tree_map


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads, ef_state):
    """Returns (dequantized grads, new error-feedback state), both float32
    trees of ``grads``' structure."""

    def one(g, e):
        g32 = g.float() + e
        scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        return deq, g32 - deq

    pairs = tree_map(one, grads, ef_state)
    is_pair = lambda x: isinstance(x, tuple)  # noqa: E731

    def pick(tree, i):
        return ({k: pick(v, i) for k, v in tree.items()}
                if not is_pair(tree) else tree[i])
    return pick(pairs, 0), pick(pairs, 1)
