"""Public entry points of the port's kernels, dispatched by device.

A CUDA tensor goes to the hand-written kernel (which launches or
raises); a CPU tensor goes to the plain PyTorch version.  There is no
mode that quietly trades one for the other: the caller picks the
device.  The other two kernels of the JAX package (rglru, mlstm) are
not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention_flat
from repro_torch.kernels.hub_route import hub_route
from repro_torch.kernels.minskew import minskew

__all__ = ["decode_attention", "flash_attention", "flash_attention_flat",
           "hub_route", "minskew"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,H,hd); k/v (B,Sk,Hkv,hd) -> (B,S,H,hd).  The heads move
    next to the batch ((B*H, S, hd), a copy) for the flat kernel and
    back."""
    b, s, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * hkv, sk, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * hkv, sk, hd).contiguous()
    of = flash_attention_flat(qf, kf, vf, causal=causal, window=window)
    return of.reshape(b, h, s, hd).transpose(1, 2)
