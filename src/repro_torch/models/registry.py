"""Family dispatch, PyTorch port of ``repro.models.registry``: every
architecture exposes one uniform interface.

Every family is ported: ``dense``, ``moe`` and ``vlm`` run the
transformer, ``encdec`` the encoder-decoder, ``rglru`` and ``xlstm``
their own modules.  Each also gives its sharding metadata
(``logical_axes`` of the parameters, ``cache_axes`` of the serving
cache), which ``repro_torch.parallel.sharding`` maps onto a logical
mesh as the JAX package maps it onto a real one.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig


def _module(cfg: ModelConfig):
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer
        return transformer
    if fam == "encdec":
        from repro_torch.models import encdec
        return encdec
    if fam == "rglru":
        from repro_torch.models import rglru
        return rglru
    if fam == "xlstm":
        from repro_torch.models import xlstm
        return xlstm
    raise ValueError(f"unknown family: {fam}")


def init(cfg: ModelConfig, generator: torch.Generator, *, device=None):
    """Random parameters on ``device`` (``None`` means CUDA and raises
    without it), drawn from ``generator``, which lives there too."""
    return _module(cfg).init(cfg, generator, device=device)


def param_specs(cfg: ModelConfig):
    return _module(cfg).param_specs(cfg)


def logical_axes(cfg: ModelConfig):
    return _module(cfg).logical_axes(cfg)


def forward(cfg: ModelConfig, params, tokens, frontend_embeds=None,
            return_aux: bool = False):
    return _module(cfg).forward(cfg, params, tokens,
                                frontend_embeds=frontend_embeds,
                                return_aux=return_aux)


def prefill(cfg: ModelConfig, params, tokens, frontend_embeds=None,
            max_len=None):
    return _module(cfg).prefill(cfg, params, tokens,
                                frontend_embeds=frontend_embeds,
                                max_len=max_len)


def decode_step(cfg: ModelConfig, params, token, cache):
    return _module(cfg).decode_step(cfg, params, token, cache)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    return _module(cfg).cache_specs(cfg, batch, max_len)


def cache_axes(cfg: ModelConfig):
    return _module(cfg).cache_axes(cfg)


def has_frontend(cfg: ModelConfig) -> bool:
    return bool(cfg.frontend)


def sub_quadratic(cfg: ModelConfig) -> bool:
    """True when decode state is O(1)/windowed in context length."""
    return cfg.family in ("xlstm", "rglru")
