"""Bounded-skew eligibility (paper §3.2): the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/minskew.py``
(``_minima_kernel``, ``_elig_kernel``, wrapper ``minskew``).  Per
dispatch round the vectorized engine needs, for every scope, the min
vtime over its runnable members, and for every vtask whether it sits
within the skew bound of every scope it belongs to.  The kernel
(``csrc/minskew.cu``) takes a leading variant axis, so single runs
(V = 1) and batched sweeps (V variants) share it.

Bound on the H100: memory — the N*S int8 membership matrix is read
twice, about 2.5 us at N = 16,384 and S = 256; at the main path's S = 1
the launch latency dominates.  Coalesced int8 reads along S, a
register running min with one ``atomicMin`` per column and block, and
a warp vote per row (see the source note).

On a CPU tensor the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.minskew_plain`); on a CUDA tensor it
launches the kernel or raises.  ``minskew.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import INF, minskew_plain

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """The configured launcher, set up once."""
    lib = _build.load("minskew")
    fn = lib.minskew_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"minskew: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"minskew: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"minskew: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"minskew: {name} is not contiguous")


def minskew(vtime: torch.Tensor, runnable: torch.Tensor,
            membership: torch.Tensor, skew: torch.Tensor):
    """Returns (minima, elig int8).

    vtime (V, N) int32; runnable (V, N) int8; membership (V, N, S) int8;
    skew (V, S) int32 -> minima (V, S) int32, elig (V, N) int8.  One
    variant may drop the leading axis: (N,), (N,), (N, S), (S,)."""
    single = vtime.dim() == 1
    if single:
        vtime, runnable = vtime[None], runnable[None]
        membership, skew = membership[None], skew[None]
    if vtime.device.type == "cpu":
        minima, elig = minskew_plain(vtime, runnable, membership, skew)
    else:
        minima, elig = _launch(vtime, runnable, membership, skew)
    return (minima[0], elig[0]) if single else (minima, elig)


def _launch(vtime, runnable, membership, skew):
    if vtime.device.type != "cuda":
        raise ValueError(f"minskew: no kernel for device {vtime.device}")
    v, n, s = membership.shape
    dev = vtime.device
    _check("vtime", vtime, torch.int32, (v, n), dev)
    _check("runnable", runnable, torch.int8, (v, n), dev)
    _check("membership", membership, torch.int8, (v, n, s), dev)
    _check("skew", skew, torch.int32, (v, s), dev)
    if v > 65535 or n > 65535 * 128:
        raise ValueError(f"minskew: V={v}, N={n} exceed the launch grid")
    minima = torch.full((v, s), INF, dtype=torch.int32, device=dev)
    elig = torch.zeros((v, n), dtype=torch.int8, device=dev)
    if v == 0 or n == 0 or s == 0:
        if s == 0:
            elig.copy_(runnable != 0)
        return minima, elig
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(vtime.data_ptr(), runnable.data_ptr(),
                     membership.data_ptr(), skew.data_ptr(),
                     minima.data_ptr(), elig.data_ptr(), v, n, s, stream)
    if err != 0:
        raise RuntimeError(f"minskew kernel launch failed: CUDA error {err}")
    minskew.launches += 1
    return minima, elig


minskew.launches = 0
