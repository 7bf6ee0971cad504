"""Decode attention: the CUDA kernels and their wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py``
(``_kernel``, wrapper ``decode_attention``): one new query token per
batch row against a (B, S, Hkv, hd) KV cache, masked to each row's
valid ``lengths`` prefix, online softmax in float32, output in q's
dtype.  Every decode step runs it once per layer.

Bound on the H100: bytes (the valid cache is read once).  The kernels
(``csrc/decode_attention.cu``) split the cache into chunks of
:func:`split_chunk` positions (flash-decoding): one block per (chunk,
batch row, kv head) writes a float32 partial (m, l, acc) for each head
of its GQA group, and a combine kernel merges a row's partials.  The
chunk depends on the shapes only, never on ``lengths``, which stay on
the card.

On a CPU tensor the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.decode_attention_plain`); on a CUDA
tensor it launches the kernels or raises; on a meta tensor it takes the
meta route (:mod:`repro_torch.kernels.work`).  Both paths check dtypes and
shapes first.  ``decode_attention.launches`` counts calls that launched
(each launches the split and the combine kernel once).  Decode is not
trained and the kernels have no backward: on a CUDA tensor under grad
the wrapper raises (ROADMAP A8.2) rather than detach its output.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.flash_attention import DTYPES, check_head_dim
from repro_torch.kernels.ref import decode_attention_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
#: (H / Hkv) * hd per block: SPLIT_GROUPS * 8 * SPLIT_THREADS in the source
SOURCE = "decode_attention.cu"
MAX_GROUP_OUT = 8192
TILE = 32                     # positions per tile of a split block
MAX_CHUNK = 2048
#: blocks the split grid should reach: two per SM of an H100 (132 SMs)
TARGET_BLOCKS = 264


@functools.lru_cache(maxsize=None)
def _lib():
    """The configured launcher, set up once."""
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _I, ctypes.c_double, _I, _P]
    fn.restype = _I
    return fn


def split_chunk(b: int, hkv: int, s: int) -> int:
    """Positions per split block for a (B, S, Hkv, hd) cache: a multiple
    of ``TILE``, doubled while the grid keeps ``TARGET_BLOCKS`` blocks."""
    chunk = TILE
    while (chunk < MAX_CHUNK
           and b * hkv * -(-s // (2 * chunk)) >= TARGET_BLOCKS):
        chunk *= 2
    return chunk


def n_splits(b: int, hkv: int, s: int) -> int:
    """Split blocks per (batch row, kv head): at least one, also at S=0."""
    return max(1, -(-s // split_chunk(b, hkv, s)))


def _check(q, k_cache, v_cache, lengths):
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("decode_attention: q must be (B, H, hd) and the "
                         "caches (B, S, Hkv, hd)")
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention: dtype {q.dtype}, expected one "
                        f"of {DTYPES}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"decode_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"decode_attention: lengths is {lengths.dtype}, "
                        f"expected torch.int32")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q "
                             f"on {q.device}")
    b, h, hd = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != b
            or k_cache.shape[3] != hd or tuple(lengths.shape) != (b,)):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, lengths "
            f"{tuple(lengths.shape)} disagree")
    hkv = k_cache.shape[2]
    if hkv == 0 or h % hkv != 0:
        raise ValueError(f"decode_attention: H={h} is not a multiple of "
                         f"Hkv={hkv}")
    check_head_dim("decode_attention", hd)
    if (h // hkv) * hd > MAX_GROUP_OUT:
        raise ValueError(f"decode_attention: (H / Hkv) * hd = "
                         f"{(h // hkv) * hd} exceeds {MAX_GROUP_OUT}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} is not contiguous")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd); caches (B, S, Hkv, hd); lengths (B,) int32 valid
    prefixes -> (B, H, hd) in q's dtype (float32 or bfloat16; hd a
    multiple of 8 up to 256).  On the card the caches' base addresses
    must be 16-byte aligned (the kernel copies 16 bytes at a time); a
    view that is not raises."""
    _check(q, k_cache, v_cache, lengths)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths)
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    return _launch(q, k_cache, v_cache, lengths)


def _launch(q, k_cache, v_cache, lengths):
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    b, h, hd = q.shape
    _, s, hkv, _ = k_cache.shape
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} is not 16-byte "
                             f"aligned")
    if b * hkv > 65535:
        raise ValueError(f"decode_attention: B * Hkv = {b * hkv} exceeds "
                         f"the launch grid")
    out = torch.empty_like(q)
    if b == 0:
        return out
    chunk = split_chunk(b, hkv, s)
    n_split = n_splits(b, hkv, s)
    # float32 scratch in one allocation: m and l (B, H, n_split) each, then
    # acc (B, H, n_split, hd) from a 16-byte boundary (the kernel stores it
    # 16 bytes at a time)
    n = b * h * n_split
    acc_at = -(-2 * n // 4) * 4
    scratch = torch.empty(acc_at + n * hd, dtype=torch.float32,
                          device=q.device)
    if q.device.type == "meta":
        # the meta route: the lengths' values are not known here, so the
        # work counts every cache position of every row
        work.record(SOURCE, work.decode_work(b, h, hkv, hd, q.element_size(),
                                             b * s))
        return out
    part = scratch.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                     lengths.data_ptr(), part, part + 4 * n, part + 4 * acc_at,
                     out.data_ptr(), b, h, hkv, s, hd, chunk, n_split,
                     1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
                     stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
