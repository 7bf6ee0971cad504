"""Bounded-skew eligibility (paper §3.2): the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/minskew.py``
(``_minima_kernel``, ``_elig_kernel``, wrapper ``minskew``).  Per
dispatch round the vectorized engine needs, for every scope, the min
vtime over its runnable members, and for every vtask whether it sits
within the skew bound of every scope it belongs to.  The kernel
(``csrc/minskew.cu``) takes a leading variant axis, so single runs
(V = 1) and batched sweeps (V variants) share it.

Bound on the H100: bytes, far below the cost of a launch at the
engine's shapes (115 KB at the main path's N = 16,384, S = 1).  So a
call is one device operation: one launch of ``minskew_cluster_kernel``,
one thread block cluster of R blocks per variant (:func:`plan` picks R
from N*S).  Each block takes a slab of rows, folds its partial scope
minima in shared memory, reads every rank's partials through the
cluster's distributed shared memory, and then decides its own rows'
eligibility from the minima held on chip.  The kernel writes both
outputs whole, so the wrapper allocates them with ``torch.empty`` and
launches nothing else.  See the source note.

On a CPU tensor the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.minskew_plain`); on a CUDA tensor it
launches the kernel or raises.  ``minskew.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import INF, minskew_plain

#: threads per block
THREADS = 1024
#: the largest cluster (non-portable above 8 on Hopper)
MAX_CLUSTER = 16
#: scopes per chunk whose minima a block holds on chip
CHUNK_S = 2048
#: membership bytes of its slab a block may keep in shared memory
SLAB_MAX = 192 * 1024
#: input bytes per block that :func:`plan` sizes the cluster for
CTA_BYTES = 8 * 1024
#: streaming multiprocessors of an H100 SXM
SMS = 132

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """The configured launcher, set up once; checks that the kernel was
    built with this module's constants."""
    lib = _build.load("minskew")
    consts = (ctypes.c_int * 4)()
    lib.minskew_constants.argtypes = [_P]
    lib.minskew_constants.restype = None
    lib.minskew_constants(consts)
    want = (THREADS, MAX_CLUSTER, CHUNK_S, SLAB_MAX)
    if tuple(consts) != want:
        raise RuntimeError(f"minskew: kernel built with {tuple(consts)}, "
                           f"module expects {want}")
    fn = lib.minskew_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


class Plan(NamedTuple):
    """A call's launch: see :func:`plan`."""
    cluster: int
    slab_rows: int
    kept_rows: int
    vec: bool
    chunks: int
    grid: Tuple[int, int]


@functools.lru_cache(maxsize=256)
def plan(v: int, n: int, s: int, aligned: bool = True,
         cluster: Optional[int] = None) -> Plan:
    """The kernel's launch for a (V, N, S) call: R blocks a cluster
    (enough that each takes about ``CTA_BYTES`` of input, 1 to 16; at
    most 8 for several variants, and V * R at most two blocks an SM),
    the rows of each block's slab, how many of them keep their
    membership in shared memory between the passes (all that fit in
    ``SLAB_MAX``), 16-byte membership loads where S is a multiple of
    16 and the pointer ``aligned``, and the chunks of ``CHUNK_S``
    scopes.  ``cluster`` overrides R.  Cached: the engine calls it with
    one shape every round."""
    if cluster is None:
        # clusters of 16 need 16 SMs of one GPC: only a few fit the card
        # at once, so several variants take clusters of at most 8
        cluster = min(MAX_CLUSTER if v == 1 else MAX_CLUSTER // 2,
                      _pow2_ceil(-(-n * (s + 5) // CTA_BYTES)))
        while cluster > 1 and v * cluster > 2 * SMS:
            cluster //= 2
    slab_rows = -(-n // cluster)
    return Plan(cluster, slab_rows,
                min(slab_rows, SLAB_MAX // max(1, min(s, CHUNK_S))),
                s % 16 == 0 and aligned, -(-s // CHUNK_S), (cluster, v))


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"minskew: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"minskew: {name} is {t.dtype}, expected {dtype}")
    if t.shape != shape:
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


def _launch(vtime, runnable, membership, skew, cluster=None):
    dev = vtime.device
    if dev.type != "cuda":
        raise ValueError(f"minskew: no kernel for device {dev}")
    v, n, s = membership.shape
    _check("vtime", vtime, torch.int32, (v, n), dev)
    _check("runnable", runnable, torch.int8, (v, n), dev)
    _check("membership", membership, torch.int8, (v, n, s), dev)
    _check("skew", skew, torch.int32, (v, s), dev)
    if v > 65535:
        raise ValueError(f"minskew: V={v} exceeds the launch grid")
    if v == 0 or n == 0 or s == 0:
        minima = torch.full((v, s), INF, dtype=torch.int32, device=dev)
        return minima, (runnable != 0).to(torch.int8)
    minima = torch.empty((v, s), dtype=torch.int32, device=dev)
    elig = torch.empty((v, n), dtype=torch.int8, device=dev)
    mem_ptr = membership.data_ptr()
    p = plan(v, n, s, mem_ptr % 16 == 0, cluster)
    args = (vtime.data_ptr(), runnable.data_ptr(), mem_ptr,
            skew.data_ptr(), minima.data_ptr(), elig.data_ptr(), v, n, s,
            p.cluster, p.kept_rows, p.vec)
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = _lib()(*args, _build.stream_ptr(torch, dev))
    else:
        with torch.cuda.device(dev):
            err = _lib()(*args, _build.stream_ptr(torch, dev))
    if err != 0:
        raise RuntimeError(f"minskew kernel launch failed: CUDA error {err}")
    minskew.launches += 1
    return minima, elig


minskew.launches = 0
