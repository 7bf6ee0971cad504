"""Decode attention: the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py``
(``_kernel``, wrapper ``decode_attention``): one new query token per
batch row against a (B, S, Hkv, hd) KV cache, masked to each row's
valid ``lengths`` prefix, online softmax in float32, output in q's
dtype.  Every decode step runs it once per layer.

Bound on the H100: bytes (the valid cache is read once).  The first
kernel (``csrc/decode_attention.cu``) runs one block per (batch row, kv
head), which reads each KV tile once for its whole GQA group and never
reads past the row's length; at B * Hkv = 32 blocks it leaves most SMs
idle (see the source note).

On a CPU tensor the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.decode_attention_plain`); on a CUDA
tensor it launches the kernel or raises.  Both paths check dtypes and
shapes first.  ``decode_attention.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, check_head_dim
from repro_torch.kernels.ref import decode_attention_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_GROUP_OUT = 8192          # (H / Hkv) * hd per block (MAX_OUT * THREADS)


@functools.lru_cache(maxsize=None)
def _lib():
    """The configured launcher, set up once."""
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   ctypes.c_double, _I, _P]
    fn.restype = _I
    return fn


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
    multiple of 8 up to 256)."""
    _check(q, k_cache, v_cache, lengths)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths)
    return _launch(q, k_cache, v_cache, lengths)


def _launch(q, k_cache, v_cache, lengths):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    b, h, hd = q.shape
    _, s, hkv, _ = k_cache.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                     lengths.data_ptr(), out.data_ptr(), b, h, hkv, s, hd,
                     1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
                     stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
