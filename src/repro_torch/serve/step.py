"""Serve-step builders, PyTorch port of ``repro.serve.step``: prefill
and single-token decode.

The JAX module's ``serve_rules`` and ``cache_shardings`` shard the
cache over a device mesh; they wait for the port's mesh code (ROADMAP
A12: the port trains and serves on one card, its mesh logical).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models import registry
from repro_torch.models.common import ModelConfig


def build_prefill_step(cfg: ModelConfig) -> Callable:
    def step(params, tokens, frontend_embeds=None):
        return registry.prefill(cfg, params, tokens,
                                frontend_embeds=frontend_embeds)

    return step


def build_decode_step(cfg: ModelConfig) -> Callable:
    def step(params, token, cache):
        return registry.decode_step(cfg, params, token, cache)

    return step
