"""Batched hub message visibility (paper §3.4): the CUDA kernel and its
wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/hub_route.py``
(``_kernel``, wrapper ``hub_route``).  For messages sorted by
(link, send), per-link FIFO queuing gives
``end_i = max(send_i, end_{i-1, same link}) + ser_i`` and visibility
``end_i + lat[link_i]`` — a segmented max-plus scan, run by
``csrc/hub_route.cu`` in three phases (tile scans, a scan of the tile
aggregates, a fold of each tile's carry).

Bound on the H100: about 20 B per message, 1.3 MB at the main path's
M = 65,600 (under 1 us at 3.35 TB/s); the three launches dominate.

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
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import hub_route_plain

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """The configured launcher and the kernel's tile size, set up once."""
    lib = _build.load("hub_route")
    fn = lib.hub_route_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _P]
    fn.restype = _I
    lib.hub_route_tile.argtypes = []
    lib.hub_route_tile.restype = _I
    return fn, lib.hub_route_tile()


def _check(name, t, n, device):
    if t.device != device:
        raise ValueError(f"hub_route: {name} on {t.device}, "
                         f"expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"hub_route: {name} is {t.dtype}, expected int32")
    if t.dim() != 1 or (n is not None and t.shape[0] != n):
        raise ValueError(f"hub_route: {name} has shape {tuple(t.shape)}, "
                         f"expected ({n},)")
    if not t.is_contiguous():
        raise ValueError(f"hub_route: {name} is not contiguous")


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
    if send.device.type != "cuda":
        raise ValueError(f"hub_route: no kernel for device {send.device}")
    dev = send.device
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
    fn, tile = _lib()
    tiles = -(-m // tile)
    scratch = torch.empty(6 * tiles, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(send.data_ptr(), ser.data_ptr(), link.data_ptr(),
                 lat.data_ptr(), out.data_ptr(), scratch.data_ptr(), m,
                 lat.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"hub_route kernel launch failed: "
                           f"CUDA error {err}")
    hub_route.launches += 1
    return out


hub_route.launches = 0
