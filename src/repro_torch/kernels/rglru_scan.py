"""RG-LRU linear recurrence: the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/rglru_scan.py``
(``_kernel``, wrapper ``rglru_scan``): ``h_t = exp(log_a_t) * h_{t-1}
+ b_t`` over the sequence axis of float32 (B, S, W) inputs, from an
optional initial state h0 (B, W).  recurrentgemma's prefill runs it
once per recurrent layer.

Bound on the H100: bytes (log_a and b read once, h written once).  The
kernel (``csrc/rglru_scan.cu``) is a single-pass chained scan over S:
one warp per tile of ``TILE_W`` channels of one batch row and one chunk
of ``CHUNK`` time steps, the tile staged in shared memory by
asynchronous copies issued at block start; a local pass from 0 gives
the chunk's end value and its sum of log_a, the carry entering each
chunk is composed strictly in chunk order through flags in a workspace
(so every call gives the same bits), and an output pass re-runs the
recurrence from the carry.  See the source note.

The gradient, bound through :class:`RglruScan`, a
``torch.autograd.Function`` that saves log_a, h0 and the output h, is
:func:`rglru_scan_bwd`: ``csrc/rglru_scan_bwd.cu``, a chained scan run
from the last chunk (``g_t = dh_t + a_{t+1} g_{t+1}``; db, dlog_a and dh0
from g and the saved h) whose blocks stage all three inputs (log_a, dh
and the rows of h_{t-1}) before any wait and split a chunk of
``BWD_CHUNK`` steps over ``BWD_WARPS`` warps (``plan_bwd``).  The JAX
package differentiates its jnp scan; it has no backward Pallas kernel.
A call on CUDA tensors goes through it when grad mode is on and an input
requires grad; otherwise (serving) nothing is saved.

On a CPU tensor the wrappers compute the plain versions
(:func:`repro_torch.kernels.ref.rglru_plain`, through which autograd
runs, and :func:`repro_torch.kernels.ref.rglru_bwd_plain`); on a CUDA
tensor they launch the kernel or raise; on a meta tensor they take the
meta route (:mod:`repro_torch.kernels.work`: the CUDA route's
allocations, no launch).  Both paths check dtypes and shapes first.  ``rglru_scan.launches`` and ``rglru_scan_bwd.launches``
count launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.ref import rglru_bwd_plain, rglru_plain

#: time steps per chunk (T_c): rows of a block's staged tile
CHUNK = 256
#: channels per block (W_t): one warp, a lane each
TILE_W = 32
#: the backward's time steps per chunk (hops of its carry chain) and warps
#: per block (each a sub-chunk of ceil(rows / warps) steps): the
#: ``CHUNK`` and ``WARPS`` that ``csrc/rglru_scan_bwd.cu`` is built for
BWD_CHUNK = 256
BWD_WARPS = 8
SOURCE = "rglru_scan.cu"
BWD_SOURCE = "rglru_scan_bwd.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib():
    """The configured launcher and workspace-size functions, set up once."""
    lib = _build.load("rglru_scan")
    launch = lib.rglru_scan_launch
    launch.argtypes = [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P]
    launch.restype = _I
    ws = lib.rglru_scan_workspace_bytes
    ws.argtypes = [_I, _I, _I, _I]
    ws.restype = _L
    return launch, ws


@functools.lru_cache(maxsize=None)
def _lib_bwd():
    """The backward's launcher and workspace-size functions, set up
    once."""
    lib = _build.load("rglru_scan_bwd")
    launch = lib.rglru_scan_bwd_launch
    launch.argtypes = [_P] * 8 + [_L, _I, _I, _I, _I, _I, _P]
    launch.restype = _I
    ws = lib.rglru_scan_bwd_workspace_bytes
    ws.argtypes = [_I, _I, _I, _I]
    ws.restype = _L
    return launch, ws


def plan(bsz: int, s: int, w: int) -> dict:
    """The kernel's tiling of a (B, S, W) call: T_c, W_t, the chunks
    (hops of the carry chain) and the blocks of the grid."""
    n_chunks = -(-s // CHUNK)
    return {"chunk": CHUNK, "tile_w": TILE_W, "n_chunks": n_chunks,
            "grid": n_chunks * bsz * -(-w // TILE_W)}


def plan_bwd(bsz: int, s: int, w: int) -> dict:
    """The backward kernel's tiling of a (B, S, W) call: T_c, warps a
    block, W_t, the chunks (hops of the carry chain) and the blocks of
    the grid."""
    n_chunks = -(-s // BWD_CHUNK)
    return {"chunk": BWD_CHUNK, "warps": BWD_WARPS, "tile_w": TILE_W,
            "n_chunks": n_chunks, "grid": n_chunks * bsz * -(-w // TILE_W)}


def _check(log_a, h0, *others, what: str = "rglru_scan"):
    """log_a and ``others`` ((name, tensor) pairs) float32, contiguous,
    (B, S, W) on one device; h0 (B, W) or None."""
    if log_a.dim() != 3:
        raise ValueError(f"{what}: log_a and "
                         f"{', '.join(n for n, _ in others)} must be "
                         f"(B, S, W)")
    tensors = [("log_a", log_a), *others]
    if h0 is not None:
        tensors.append(("h0", h0))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected "
                            f"torch.float32")
        if t.device != log_a.device:
            raise ValueError(f"{what}: {name} on {t.device}, log_a on "
                             f"{log_a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    bsz, _, w = log_a.shape
    if any(t.shape != log_a.shape for _, t in others) or (
            h0 is not None and tuple(h0.shape) != (bsz, w)):
        shapes = ", ".join(f"{n} {tuple(t.shape)}" for n, t in others)
        raise ValueError(
            f"{what}: log_a {tuple(log_a.shape)}, {shapes}, h0 "
            f"{None if h0 is None else tuple(h0.shape)} disagree")


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log_a, b (B, S, W) float32; h0 (B, W) float32 or None (zeros)
    -> h (B, S, W) float32."""
    _check(log_a, h0, ("b", b))
    if log_a.device.type == "cpu":
        return rglru_plain(log_a, b, h0)
    if _build.grad_wanted(log_a, b, h0):
        return RglruScan.apply(log_a, b, h0)
    return _launch(log_a, b, h0)


def _launch(log_a, b, h0):
    if log_a.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru_scan: no kernel for device {log_a.device}")
    bsz, s, w = log_a.shape
    out = torch.empty_like(log_a)
    if out.numel() == 0:
        return out
    if log_a.device.type == "meta":     # the meta route: no launch
        torch.empty(work.rglru_ws_bytes(bsz, s, w, CHUNK, TILE_W),
                    dtype=torch.uint8, device=log_a.device)
        work.record(SOURCE, work.rglru_work(bsz, s, w, h0 is not None))
        return out
    launch, ws_bytes = _lib()
    n_ws = ws_bytes(bsz, s, w, CHUNK)
    ws = torch.empty(n_ws, dtype=torch.uint8, device=log_a.device)
    with torch.cuda.device(log_a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(log_a.data_ptr(), b.data_ptr(),
                     None if h0 is None else h0.data_ptr(), out.data_ptr(),
                     ws.data_ptr(), n_ws, bsz, s, w, CHUNK, TILE_W, stream)
    if err != 0:
        raise RuntimeError(
            f"rglru_scan kernel launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0


class RglruScan(torch.autograd.Function):
    """:func:`rglru_scan` on CUDA tensors with its gradient: forward
    through the kernel, backward through :func:`rglru_scan_bwd`.  Saves
    log_a, h0 and the output h (b is not needed)."""

    @staticmethod
    def forward(ctx, log_a, b, h0):
        h = _launch(log_a, b, h0)
        ctx.save_for_backward(log_a, h0, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        log_a, h0, h = ctx.saved_tensors
        # h0 is h_{-1} in dlog_a_0 whether or not it takes a gradient
        return rglru_scan_bwd(log_a, h, h0, dh.contiguous(),
                              want_dh0=ctx.needs_input_grad[2])


def rglru_scan_bwd(log_a: torch.Tensor, h: torch.Tensor,
                   h0: Optional[torch.Tensor], dh: torch.Tensor,
                   want_dh0: bool = True):
    """The gradient of :func:`rglru_scan` from its output: log_a, h, dh
    (B, S, W) float32 contiguous, h0 (B, W) or None -> (dlog_a, db, dh0),
    dh0 None where h0 is or ``want_dh0`` is false (h0 still enters
    dlog_a_0 as h_{-1}).  The CPU's plain version is
    :func:`repro_torch.kernels.ref.rglru_bwd_plain`; on CUDA tensors
    ``csrc/rglru_scan_bwd.cu`` launches or the call raises."""
    _check(log_a, h0, ("h", h), ("dh", dh), what="rglru_scan_bwd")
    if log_a.device.type == "cpu":
        dla, db, dh0 = rglru_bwd_plain(log_a, h, h0, dh)
        return dla, db, dh0 if want_dh0 else None
    if log_a.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru_scan_bwd: no kernel for device "
                         f"{log_a.device}")
    bsz, s, w = log_a.shape
    dla = torch.empty_like(log_a)
    db = torch.empty_like(log_a)
    dh0 = None if h0 is None or not want_dh0 else torch.empty_like(h0)
    if dla.numel() == 0:
        if dh0 is not None:
            dh0.zero_()
        return dla, db, dh0
    if log_a.device.type == "meta":     # the meta route: no launch
        torch.empty(work.rglru_bwd_ws_bytes(bsz, s, w, BWD_CHUNK, TILE_W),
                    dtype=torch.uint8, device=log_a.device)
        work.record(BWD_SOURCE, work.rglru_bwd_work(bsz, s, w,
                                                    h0 is not None))
        return dla, db, dh0
    launch, ws_bytes = _lib_bwd()
    n_ws = ws_bytes(bsz, s, w, BWD_CHUNK)
    ws = torch.empty(n_ws, dtype=torch.uint8, device=log_a.device)
    with torch.cuda.device(log_a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(log_a.data_ptr(), h.data_ptr(),
                     None if h0 is None else h0.data_ptr(), dh.data_ptr(),
                     dla.data_ptr(), db.data_ptr(),
                     None if dh0 is None else dh0.data_ptr(), ws.data_ptr(),
                     n_ws, bsz, s, w, BWD_CHUNK, TILE_W, stream)
    if err != 0:
        raise RuntimeError(
            f"rglru_scan_bwd kernel launch failed: CUDA error {err}")
    rglru_scan_bwd.launches += 1
    return dla, db, dh0


rglru_scan_bwd.launches = 0
