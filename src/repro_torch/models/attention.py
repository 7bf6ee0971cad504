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

from repro_torch.kernels import ops, ref
from repro_torch.parallel import ctx as pctx


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


def decode_attention_sp(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Flash-decoding over the sequence-sharded KV cache (``sp_decode``),
    the JAX package's ``decode_attention_sp``: there a ``shard_map`` keeps
    each chip's cache shard in place (local partial softmax, then a psum
    of (max, l, o) over the ``model`` axis).  Under an active mesh with a
    ``model`` axis of size ``m`` the cache's S must split into ``m``
    shards (``ValueError`` otherwise, as ``shard_map`` requires).  On
    CPU tensors this is its plain version,
    :func:`repro_torch.kernels.ref.decode_attention_sp_plain` over ``m``
    shards; on the card it is the ``decode_attention`` kernel, whose
    split-S partials and combine are this computation on one device
    (no second kernel).  Without a mesh or a ``model`` axis it is
    :func:`decode_attention`, as in the JAX package.  Arguments and
    result as :func:`decode_attention`."""
    mesh = pctx.get_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return decode_attention(q, k_cache, v_cache, cache_len)
    m = mesh.shape["model"]
    if k_cache.shape[1] % m:
        raise ValueError(f"decode_attention_sp: a cache of "
                         f"{k_cache.shape[1]} positions does not split "
                         f"over a model axis of {m}")
    if q.device.type != "cpu":
        return decode_attention(q, k_cache, v_cache, cache_len)
    return ref.decode_attention_sp_plain(
        q[:, 0], k_cache, v_cache, _lengths(q, cache_len), m)[:, None]


def _lengths(q: torch.Tensor, cache_len) -> torch.Tensor:
    """(B,) int32 valid lengths on q's device from an int, a scalar or a
    (B,) vector."""
    b = q.shape[0]
    if isinstance(cache_len, int):
        # a fill on the device, not a host-to-device copy
        return torch.full((b,), cache_len, dtype=torch.int32,
                          device=q.device)
    lengths = torch.as_tensor(cache_len).to(q.device, torch.int32)
    if lengths.dim() == 0:
        lengths = lengths.expand(b)
    return lengths.contiguous()


def decode_attention(
    q: torch.Tensor,              # (B, 1, H, hd)
    k_cache: torch.Tensor,        # (B, S, Hkv, hd)
    v_cache: torch.Tensor,        # (B, S, Hkv, hd)
    cache_len,                    # valid prefix length: int, scalar or (B,)
) -> torch.Tensor:
    """Single-token attention against a (possibly padded) KV cache ->
    (B, 1, H, hd)."""
    return ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                _lengths(q, cache_len))[:, None]
