"""Public entry points of the port's kernels, dispatched by device.

A CUDA tensor goes to the hand-written kernel (which launches or
raises); a CPU tensor goes to the plain PyTorch version.  There is no
mode that quietly trades one for the other: the caller picks the
device.  Every kernel of the JAX package has its counterpart here:
``minskew``, ``hub_route``, ``flash_attention``, ``decode_attention``,
``rglru`` and ``mlstm``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention_flat
# (B, S, H, hd) attention: bf16 on the card in place, else flat copies
from repro_torch.kernels.flash_attention import \
    flash_attention_bshd as flash_attention
from repro_torch.kernels.hub_route import hub_route
from repro_torch.kernels.minskew import minskew
from repro_torch.kernels.mlstm_kernel import mlstm_chunkwise
from repro_torch.kernels.ref import MLSTM_CHUNK, mlstm_chunkwise_plain
from repro_torch.kernels.rglru_scan import rglru_scan

__all__ = ["decode_attention", "flash_attention", "flash_attention_flat",
           "hub_route", "minskew", "mlstm", "rglru"]


def rglru(log_a: torch.Tensor, b: torch.Tensor,
          h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t over axis 1: (B,S,W) float32,
    h0 (B,W) or None -> (B,S,W)."""
    return rglru_scan(log_a.contiguous(), b.contiguous(),
                      None if h0 is None else h0.contiguous())


def mlstm(q, k, v, i_raw, f_raw, c0=None, n0=None, *,
          chunk: int = MLSTM_CHUNK):
    """Chunkwise mLSTM: q,k,v (B,S,H,hd); gates (B,S,H) float32; c0
    (B,H,hd,hd), n0 (B,H,hd) float32 or None (zeros) -> h (B,S,H,hd),
    (C, n).

    On CPU tensors this is the JAX model's ``mlstm_chunkwise`` at
    ``chunk`` (one chunk where S is not a multiple), a branch that the
    JAX ``ops.mlstm`` lacks.  On CUDA tensors the heads move next to the
    batch ((B*H, S, hd), a copy) for the kernel, which runs its own
    chunk (``mlstm_kernel.CHUNK``) and ignores ``chunk``."""
    if q.device.type == "cpu":
        return mlstm_chunkwise_plain(q, k, v, i_raw, f_raw, c0, n0,
                                     chunk=chunk)
    b, s, h, hd = q.shape

    def heads_first(t):
        return t.transpose(1, 2).reshape(b * h, s, *t.shape[3:]).contiguous()
    hf, (c, n) = mlstm_chunkwise(
        heads_first(q), heads_first(k), heads_first(v),
        heads_first(i_raw.float()), heads_first(f_raw.float()),
        None if c0 is None else c0.reshape(b * h, hd, hd).contiguous(),
        None if n0 is None else n0.reshape(b * h, hd).contiguous())
    return (hf.reshape(b, h, s, hd).transpose(1, 2),
            (c.reshape(b, h, hd, hd), n.reshape(b, h, hd)))
