"""Blockwise (flash) attention: the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_kernel``, wrapper ``flash_attention_flat``): causal and sliding-window
softmax attention over flattened (BH, S, hd) queries, GQA through the kv
row ``b // q_per_kv``, key tiles outside the band skipped, float32 sums
and output in q's dtype.  Prefill runs it once per layer.

Bound on the H100: operations (about 2 B H S^2 hd FLOPs over the causal
half).  The first kernel (``csrc/flash_attention.cu``) does them as
float32 FMAs from shared memory, with the online-softmax state in
registers; see the source note.

On a CPU tensor the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.attention_flat_plain`); on a CUDA tensor
it launches the kernel or raises.  Both paths check dtypes and shapes
first.  ``flash_attention_flat.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_flat_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
DTYPES = (torch.float32, torch.bfloat16)
MAX_HD = 256
BQ = 64                       # query rows per block (csrc/flash_attention.cu)


@functools.lru_cache(maxsize=None)
def _lib():
    """The configured launcher, set up once."""
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   ctypes.c_double, _I, _P]
    fn.restype = _I
    return fn


def check_head_dim(name: str, hd: int) -> None:
    if hd % 8 != 0 or not 8 <= hd <= MAX_HD:
        raise ValueError(f"{name}: head_dim {hd} is not a multiple of 8 "
                         f"in 8..{MAX_HD}")


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: q, k, v must be 3-D (BH, S, hd)")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype}, expected one "
                        f"of {DTYPES}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    bh, _, hd = q.shape
    if k.shape != v.shape or k.shape[2] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if k.shape[0] == 0 or bh % k.shape[0] != 0:
        raise ValueError(f"flash_attention: BH={bh} is not a multiple of "
                         f"BHkv={k.shape[0]}")
    check_head_dim("flash_attention", hd)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q (BH, Sq, hd); k/v (BHkv, Sk, hd), BH % BHkv == 0 -> (BH, Sq, hd)
    in q's dtype (float32 or bfloat16; hd a multiple of 8 up to 256)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_flat_plain(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window)


def _launch(q, k, v, causal, window):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    bh, sq, hd = q.shape
    bhkv, sk, _ = k.shape
    if -(-sq // BQ) > 65535:
        raise ValueError(f"flash_attention: Sq={sq} exceeds the launch grid")
    out = torch.empty_like(q)
    if sq == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), bh, bhkv, sq, sk, hd, int(causal),
                     int(window), 1.0 / math.sqrt(hd),
                     int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention_flat.launches += 1
    return out


flash_attention_flat.launches = 0
