"""The assigned input-shape grid and per-(arch x shape) applicability,
PyTorch port of ``repro.launch.shapes``.

LM transformer shapes are seq_len x global_batch.  ``decode_*``/``long_*``
run ``serve_step`` (one new token against a KV/recurrent cache of
seq_len), NOT ``train_step``.  ``long_500k`` requires sub-quadratic
attention: it runs for the SSM/hybrid archs (xlstm, recurrentgemma) and is
skipped (recorded N/A) for pure full-attention archs.

Where the JAX package returns ``jax.ShapeDtypeStruct`` stand-ins,
:func:`input_specs` returns ``(shape, torch.dtype)`` pairs; a decode
cell's cache is ``registry.cache_specs``' shape tree.  The trainer takes
:func:`frontend_tokens` to size its synthetic frontend embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import registry
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


# Gradient-accumulation microbatch count per arch for train_4k (the JAX
# package's choice, so that per-layer saved activations fit a chip's
# memory).
MICROBATCH: Dict[str, int] = {
    "phi3_medium_14b": 4,
    "glm4_9b": 4,
    "deepseek_coder_33b": 8,
    "qwen3_4b": 2,
    "seamless_m4t_medium": 1,
    "xlstm_1_3b": 2,
    "moonshot_v1_16b_a3b": 2,
    "olmoe_1b_7b": 1,
    "pixtral_12b": 4,
    "recurrentgemma_9b": 4,
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch, shape) cell runs; else a skip reason (N/A cell)."""
    if shape.name == "long_500k" and not registry.sub_quadratic(cfg):
        return ("full-attention arch: 512k dense-KV decode is not "
                "sub-quadratic; skipped per assignment")
    return None


def frontend_tokens(cfg: ModelConfig, seq: int) -> int:
    """Frontend positions of a sequence of ``seq`` tokens: the patches of
    a VLM (at most half the sequence), the audio frames of an
    encoder-decoder (``encdec.enc_len``), else 0."""
    if cfg.frontend == "patch":
        return min(cfg.n_frontend_tokens, seq // 2)
    if cfg.frontend == "audio":
        from repro_torch.models import encdec

        return encdec.enc_len(cfg, seq)
    return 0


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``(shape, dtype)`` stand-ins for every model input of this cell.

    train  -> {tokens, labels[, frontend_embeds]}
    prefill-> {tokens[, frontend_embeds]}
    decode -> {token, cache}
    """
    b, s = shape.batch, shape.seq
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": ((b, s), i32)}
        if shape.kind == "train":
            specs["labels"] = ((b, s), i32)
        nf = frontend_tokens(cfg, s)
        if nf:
            specs["frontend_embeds"] = ((b, nf, cfg.frontend_dim),
                                        torch.float32)
        return specs
    if shape.kind == "decode":
        return {
            "token": ((b,), i32),
            "cache": registry.cache_specs(cfg, b, s),
        }
    raise ValueError(shape.kind)
