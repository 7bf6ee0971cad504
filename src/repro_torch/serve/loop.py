"""Batched serving loop, PyTorch port of ``repro.serve.loop``: prefill +
decode with per-request bookkeeping.

Single static batch per wave (continuous batching is a scheduling-layer
concern that LiveStack simulates; the execution layer here provides the
real prefill/decode steps with KV-cache reuse, EOS early-exit, and
latency accounting per request).  On CUDA, prefill attention runs the
``flash_attention`` kernel and each decode step's attention the
``decode_attention`` kernel; ``torch.cuda.synchronize()`` closes each
timed span, so ``prefill_s`` and ``decode_s`` time the work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.engine_torch import resolve_device
from repro_torch.models import registry
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class ServeStats:
    prefill_s: float
    decode_s: float
    tokens_out: int
    per_token_ms: float
    throughput_tok_s: float
    decode_steps: int = 0


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (the port's
    ``block_until_ready``); nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BatchServer:
    """Greedy batched generation on ``device`` (``None`` means CUDA and
    raises without it); ``params`` must already live there."""

    def __init__(self, cfg: ModelConfig, params, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, pad_id: int = 0, *,
                 device=None):
        self.device = resolve_device(device, "BatchServer")
        where = params["embed"].device
        if where.type != self.device.type or (
                self.device.index is not None and where != self.device):
            raise ValueError(f"BatchServer: params on {where}, server on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_new = max_new_tokens
        self.eos_id = eos_id
        self.pad_id = pad_id

    @torch.inference_mode()
    def _prefill(self, params, tokens, frontend_embeds=None):
        return registry.prefill(self.cfg, params, tokens,
                                frontend_embeds=frontend_embeds,
                                max_len=tokens.shape[1] + self.max_new)

    @torch.inference_mode()
    def _decode(self, params, token, cache):
        return registry.decode_step(self.cfg, params, token, cache)

    def generate(self, prompts, frontend_embeds=None) -> Dict:
        """prompts (B, S) int -> dict with tokens (B, <=max_new) numpy
        int32 + stats.  ``frontend_embeds`` (patch or frame embeddings,
        numpy or a tensor) go to the server's device with the prompts.

        With an ``eos_id``, a lane that has emitted it is finished: its
        later positions hold ``pad_id`` (a finished lane's argmax is KV
        garbage, not output), ``tokens_out`` counts only tokens emitted
        by lanes still alive at step start, and decode exits as soon as
        every lane is done — ``per_token_ms`` divides by the decode
        steps actually executed, not the output width.
        """
        prompts = torch.as_tensor(prompts, dtype=torch.int32).to(
            self.device)
        if frontend_embeds is not None:
            # the model casts them to its dtype, as the JAX model does
            frontend_embeds = torch.as_tensor(frontend_embeds).to(
                self.device)
        b = prompts.shape[0]
        sync(self.device)
        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, prompts,
                                      frontend_embeds)
        tok = logits.argmax(dim=-1).to(torch.int32)
        sync(self.device)
        t1 = time.perf_counter()
        t_np = tok.cpu().numpy()
        out = [t_np]
        alive = np.ones(b, bool)
        if self.eos_id is not None:
            alive &= t_np != self.eos_id
        n_out = b
        decode_steps = 0
        for _ in range(self.max_new - 1):
            if self.eos_id is not None and not alive.any():
                break
            logits, cache = self._decode(self.params, tok, cache)
            tok = logits.argmax(dim=-1).to(torch.int32)
            decode_steps += 1
            t_np = tok.cpu().numpy()
            if self.eos_id is not None:
                t_np = np.where(alive, t_np,
                                self.pad_id).astype(np.int32)
                n_out += int(alive.sum())
                alive &= t_np != self.eos_id
            else:
                n_out += b
            out.append(t_np)
        sync(self.device)
        t2 = time.perf_counter()
        tokens = np.stack(out, axis=1)
        stats = ServeStats(
            prefill_s=t1 - t0, decode_s=t2 - t1, tokens_out=n_out,
            per_token_ms=(t2 - t1) / max(decode_steps, 1) * 1e3,
            throughput_tok_s=n_out / max(t2 - t0, 1e-9),
            decode_steps=decode_steps)
        return {"tokens": tokens, "stats": stats}
