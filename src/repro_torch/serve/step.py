"""Serve-step builders, PyTorch port of ``repro.serve.step``: prefill
and single-token decode.

Decode shards the KV-cache sequence dimension over ``model`` (SP /
flash-decoding style) because GQA kv-head counts (1-10) rarely divide
the TP axis; batch shards over DP axes when divisible, else replicates.
On the port's one card the mesh is logical: ``serve_rules`` and
``cache_shardings`` give the specs the JAX package gives on a real mesh
of the same shape (what each shard would hold), and the cache itself
stays whole on the card.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.models import registry
from repro_torch.models.common import ModelConfig
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as shd


def build_prefill_step(cfg: ModelConfig) -> Callable:
    def step(params, tokens, frontend_embeds=None):
        return registry.prefill(cfg, params, tokens,
                                frontend_embeds=frontend_embeds)

    return step


def build_decode_step(cfg: ModelConfig) -> Callable:
    def step(params, token, cache):
        return registry.decode_step(cfg, params, token, cache)

    return step


def serve_rules(cfg: ModelConfig, mesh, batch: int) -> dict:
    """Rule overrides for serving shapes (batch may not divide DP)."""
    rules = dict(shd.DEFAULT_RULES)
    dp = pctx.dp_size(mesh)
    if batch % dp != 0:
        ba = [a for a in pctx.batch_axes(mesh)
              if batch % mesh.shape[a] == 0]
        rules["batch"] = tuple(ba) if ba else None
    else:
        rules["batch"] = tuple(pctx.batch_axes(mesh))
    return rules


def cache_shardings(cfg: ModelConfig, mesh, batch: int, max_len: int,
                    rules: Optional[dict] = None):
    rules = rules or serve_rules(cfg, mesh, batch)
    axes = registry.cache_axes(cfg)
    specs = registry.cache_specs(cfg, batch, max_len)
    return shd.shardings_from_axes(axes, mesh, rules, specs)
