"""Batched hub message visibility (paper §3.4): the CUDA kernel and its
wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/hub_route.py``
(``_kernel``, wrapper ``hub_route``).  For messages sorted by
(link, send), per-link FIFO queuing gives
``end_i = max(send_i, end_{i-1, same link}) + ser_i`` and visibility
``end_i + lat[link_i]`` — a segmented max-plus scan, run by
``csrc/hub_route.cu`` as one launch a call: a single-pass scan with
decoupled look-back over tiles of ``TILE`` messages (a block per tile,
tiles taken from an atomic ticket, each tile's prefix composed from
its predecessors' published aggregates and stopped at the first
inclusive prefix or segment start).

Bound on the H100: about 16 B per message, 1.05 MB at the main path's
M = 65,600 (0.3 us at 3.35 TB/s): a launch costs more than the work, so
a call is one device operation.  The kernel's flags and counters live in
a scratch buffer kept per (device, stream) (:func:`_scratch`), zero-filled
once when it is allocated or grown; each call's flags carry an epoch kept
on the device, so nothing is reset between calls.

Serialization comes from the exact integer ``ser_ns`` (what the engine
passes), or from the float32 path ``size * 1e9 / bw`` computed here
with torch ops, exactly as the JAX wrapper does: float32 carries 24
mantissa bits, so 163 B at 1e9 B/s truncates to 162.

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.ref.hub_route_plain`); on CUDA tensors it
launches the kernel or raises.  ``hub_route.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import KernelArgumentError as _ArgError
from repro_torch.kernels.ref import hub_route_plain

#: messages per tile (a block of 256 threads, 4 messages a thread)
TILE = 1024
#: tiles the scratch holds when first allocated (M up to 4 Mi messages)
MIN_CAPACITY = 4096

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib():
    """The configured launcher and scratch-size function, set up once;
    checks that the kernel was built with this module's tile."""
    lib = _build.load("hub_route")
    lib.hub_route_tile.argtypes = []
    lib.hub_route_tile.restype = _I
    if lib.hub_route_tile() != TILE:
        raise RuntimeError(f"hub_route: kernel built with tile "
                           f"{lib.hub_route_tile()}, module expects {TILE}")
    fn = lib.hub_route_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    fn.restype = _I
    lib.hub_route_scratch_bytes.argtypes = [_I]
    lib.hub_route_scratch_bytes.restype = _L
    return fn, lib.hub_route_scratch_bytes


#: (device index, stream) -> (scratch tensor, capacity in tiles)
_scratches: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}


def _scratch(dev: torch.device, stream: int, tiles: int):
    """The scratch of (dev, stream) with room for ``tiles`` tiles.  Calls
    on one stream run in order, so they share it; two streams never do.
    Growing allocates a new zero-filled buffer (one fill on that call)
    with at least twice the capacity."""
    key = (dev.index, stream)
    have = _scratches.get(key)
    if have is not None and have[1] >= tiles:
        return have
    cap = max(MIN_CAPACITY, tiles, 2 * have[1] if have else 0)
    buf = torch.zeros(_lib()[1](cap), dtype=torch.uint8, device=dev)
    _scratches[key] = (buf, cap)
    return buf, cap


def _check(name, t, n, device):
    if t.device != device:
        raise _ArgError(f"hub_route: {name} on {t.device}, "
                        f"expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"hub_route: {name} is {t.dtype}, expected int32")
    if t.dim() != 1 or (n is not None and t.shape[0] != n):
        raise _ArgError(f"hub_route: {name} has shape {tuple(t.shape)}, "
                        f"expected ({n},)")
    if not t.is_contiguous():
        raise _ArgError(f"hub_route: {name} is not contiguous")


def serialization(size_bytes: torch.Tensor, link_id: torch.Tensor,
                  link_bw_Bps: torch.Tensor) -> torch.Tensor:
    """The float32 path: ``int32(f32(size) * 1e9 / bw[link])``."""
    bw = link_bw_Bps.to(torch.float32)[link_id.long()]
    return (size_bytes.to(torch.float32) * 1e9 / bw).to(torch.int32)


def hub_route(send_vtime: torch.Tensor, size_bytes: torch.Tensor,
              link_id: torch.Tensor, link_bw_Bps: torch.Tensor,
              link_lat_ns: torch.Tensor, *,
              ser_ns: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Visibility times (int32) for messages sorted by (link, send).

    send_vtime, size_bytes, link_id (M,) int32; link_bw_Bps and
    link_lat_ns (L,) per-link tables.  ``ser_ns`` (M,) int32 replaces
    the float32 size/bandwidth math with exact durations."""
    ser = (ser_ns.to(torch.int32) if ser_ns is not None
           else serialization(size_bytes, link_id, link_bw_Bps))
    if send_vtime.device.type == "cpu":
        return hub_route_plain(send_vtime, ser, link_id, link_lat_ns)
    return _launch(send_vtime, ser, link_id, link_lat_ns)


def _launch(send, ser, link, lat):
    dev = send.device
    if dev.type != "cuda":
        raise _ArgError(f"hub_route: no kernel for device {dev}")
    m = send.shape[0] if send.dim() == 1 else -1
    _check("send_vtime", send, None, dev)
    _check("ser", ser, m, dev)
    _check("link_id", link, m, dev)
    _check("link_lat_ns", lat, None, dev)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return out
    # a link_id outside the latency table trips the kernel's device-side
    # assert: a CUDA error at the next synchronisation, with no host read
    # here
    fn = _lib()[0]
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = _call(fn, dev, send, ser, link, lat, out, m)
    else:
        with torch.cuda.device(dev):
            err = _call(fn, dev, send, ser, link, lat, out, m)
    if err != 0:
        raise RuntimeError(f"hub_route kernel launch failed: "
                           f"CUDA error {err}")
    hub_route.launches += 1
    return out


def _call(fn, dev, send, ser, link, lat, out, m):
    stream = _build.stream_ptr(torch, dev)
    buf, cap = _scratch(dev, stream, -(-m // TILE))
    return fn(send.data_ptr(), ser.data_ptr(), link.data_ptr(),
              lat.data_ptr(), out.data_ptr(), buf.data_ptr(), m,
              lat.shape[0], cap, stream)


hub_route.launches = 0
