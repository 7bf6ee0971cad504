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

On a CPU tensor the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.rglru_plain`); on a CUDA tensor it
launches the kernel or raises.  Both paths check dtypes and shapes
first.  ``rglru_scan.launches`` counts launches.  The kernel has no
backward yet: on a CUDA tensor under grad the wrapper raises (ROADMAP
A8.2) rather than return an output without a gradient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_plain

#: time steps per chunk (T_c): rows of a block's staged tile
CHUNK = 256
#: channels per block (W_t): one warp, a lane each
TILE_W = 32

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


def plan(bsz: int, s: int, w: int) -> dict:
    """The kernel's tiling of a (B, S, W) call: T_c, W_t, the chunks
    (hops of the carry chain) and the blocks of the grid."""
    n_chunks = -(-s // CHUNK)
    return {"chunk": CHUNK, "tile_w": TILE_W, "n_chunks": n_chunks,
            "grid": n_chunks * bsz * -(-w // TILE_W)}


def _check(log_a, b, h0):
    if log_a.dim() != 3:
        raise ValueError("rglru_scan: log_a and b must be (B, S, W)")
    tensors = [("log_a", log_a), ("b", b)]
    if h0 is not None:
        tensors.append(("h0", h0))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan: {name} is {t.dtype}, expected "
                            f"torch.float32")
        if t.device != log_a.device:
            raise ValueError(f"rglru_scan: {name} on {t.device}, log_a on "
                             f"{log_a.device}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} is not contiguous")
    bsz, _, w = log_a.shape
    if b.shape != log_a.shape or (h0 is not None
                                  and tuple(h0.shape) != (bsz, w)):
        raise ValueError(
            f"rglru_scan: log_a {tuple(log_a.shape)}, b {tuple(b.shape)}, "
            f"h0 {None if h0 is None else tuple(h0.shape)} disagree")


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log_a, b (B, S, W) float32; h0 (B, W) float32 or None (zeros)
    -> h (B, S, W) float32."""
    _check(log_a, b, h0)
    if log_a.device.type == "cpu":
        return rglru_plain(log_a, b, h0)
    _build.refuse_grad("rglru_scan", log_a, b, h0)
    return _launch(log_a, b, h0)


def _launch(log_a, b, h0):
    if log_a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {log_a.device}")
    bsz, s, w = log_a.shape
    out = torch.empty_like(log_a)
    if out.numel() == 0:
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
