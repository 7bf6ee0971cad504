"""Deterministic synthetic LM data pipeline, PyTorch port of
``repro.data.pipeline``.

Step-indexed (stateless) generation: ``batch(step)`` is a pure function
of (seed, step), so restarts resume mid-stream exactly (the checkpoint
only needs the step counter).  The tokens come from the JAX package's
numpy generator, operation for operation, so both packages draw the same
batches bit for bit; they are returned as int32 tensors on ``device``
(``None`` means CUDA and raises without it).

The token stream is a repeatable mixture: a structured component (a
global affine token map, so the loss actually goes down) plus uniform
noise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_dim: int = 0
    frontend_tokens: int = 0
    device: Any = None

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        from repro_torch.core.engine_torch import resolve_device
        dev = resolve_device(self.device, "SyntheticLMData")
        rng = np.random.default_rng((self.seed, step))
        b, s = self.global_batch, self.seq_len
        # structured component: a GLOBAL affine token map t_{i+1} =
        # (a*t_i + c) % vocab (fixed per seed) — learnable as a lookup
        # table, so training losses drop fast even for tiny models.
        g = np.random.default_rng(self.seed)
        a = int(g.integers(1, 8)) | 1          # odd -> bijective mod 2^k
        c = int(g.integers(0, self.vocab))
        t0 = rng.integers(0, self.vocab, size=(b, 1))
        structured = t0.astype(np.int64)
        cols = [structured % self.vocab]
        for _ in range(s - 1):
            structured = (a * structured + c) % self.vocab
            cols.append(structured)
        structured = np.concatenate(cols, axis=1)
        noise = rng.integers(0, self.vocab, size=(b, s))
        take_noise = rng.random((b, s)) < 0.1
        tokens = torch.from_numpy(
            np.where(take_noise, noise, structured).astype(np.int32)).to(dev)
        out = {"tokens": tokens, "labels": tokens}
        if self.frontend_tokens:
            fe = rng.standard_normal(
                (b, self.frontend_tokens, self.frontend_dim))
            out["frontend_embeds"] = torch.from_numpy(fe).to(
                dev, torch.float32)
        return out
