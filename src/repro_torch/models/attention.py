"""Attention for every attention-bearing architecture, PyTorch port of
``repro.models.attention``.

The JAX package's models call a chunked jnp attention here and keep the
Pallas kernels as validated drop-ins behind ``repro.kernels.ops``.  In
the port the drop-ins are the path: both functions go through
:mod:`repro_torch.kernels.ops`, so on CUDA tensors prefill runs the
``flash_attention`` kernel and every decode step the
``decode_attention`` kernel, and on CPU tensors their plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def multi_head_attention(
    q: torch.Tensor,              # (B, Sq, H, hd)
    k: torch.Tensor,              # (B, Sk, Hkv, hd)
    v: torch.Tensor,              # (B, Sk, Hkv, hd)
    *,
    causal: bool = True,
    window: int = 0,              # 0 = full; >0 = sliding local window
    q_offset: int = 0,            # absolute position of q[0]
) -> torch.Tensor:
    """Masked softmax attention with GQA -> (B, Sq, H, hd).

    The JAX package's ``chunk_q`` and ``causal_slice`` (query chunking
    and triangle slicing of its jnp path) have no counterpart: the
    kernel tiles the queries and skips key tiles outside the band
    itself."""
    if q_offset != 0:
        raise NotImplementedError(
            "multi_head_attention: q_offset != 0 is not on the serving "
            "path and is not ported (ROADMAP A6)")
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention_sp(q, k_cache, v_cache, cache_len):
    """Flash-decoding over a sequence-sharded cache (a ``shard_map`` over
    a device mesh in the JAX package): mesh code, not ported."""
    raise NotImplementedError(
        "decode_attention_sp shards the KV cache over a device mesh; the "
        "port's mesh is logical, over one card (ROADMAP A12)")


def decode_attention(
    q: torch.Tensor,              # (B, 1, H, hd)
    k_cache: torch.Tensor,        # (B, S, Hkv, hd)
    v_cache: torch.Tensor,        # (B, S, Hkv, hd)
    cache_len,                    # valid prefix length: int, scalar or (B,)
) -> torch.Tensor:
    """Single-token attention against a (possibly padded) KV cache ->
    (B, 1, H, hd)."""
    b = q.shape[0]
    if isinstance(cache_len, int):
        # a fill on the device, not a host-to-device copy
        lengths = torch.full((b,), cache_len, dtype=torch.int32,
                             device=q.device)
    else:
        lengths = torch.as_tensor(cache_len).to(q.device, torch.int32)
        if lengths.dim() == 0:
            lengths = lengths.expand(b)
    return ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                lengths.contiguous())[:, None]
