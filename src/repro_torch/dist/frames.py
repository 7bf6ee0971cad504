"""Packed binary wire format for the dist engine's per-round hot path.

Every pipe message is one frame: a 1-byte tag followed by the body.
The two per-round messages are fully ``struct``-packed — envelope and
clock records are fixed-size binary fields instead of pickled Python
objects, which is where most of the old per-round coordination cost
went (one pickle per Message/tuple, per round, per worker):

* ``STEP`` (coordinator -> worker): per-host window bounds + replica
  (vtime, state) updates + cross-partition envelope records, coalesced
  into a single message so one round costs one round-trip (the old
  protocol paid two: phase A sync + phase B run).
* ``REPLY`` (worker -> coordinator): progress flags/counters, per-host
  conservative next-event times, exported task-state deltas, and the
  outbox of envelope records.

Cold-path messages (handshake, finalize, reports, errors) ride
``PICKLE`` frames — a tag byte plus a pickled ``(tag, payload)`` pair.

Names never travel on the hot path: workers build bit-identical
replicas of the simulation, so hub/endpoint/task names are interned
into deterministic index tables at build time and records carry u16/u32
indexes.  The coordinator routes envelope records *without decoding
them* — it reads the destination-hub index and the forwarded send
vtime at fixed offsets and relays the record bytes verbatim to the
owning worker.

Message payloads are ``None`` for every built-in workload; a non-None
payload is pickled per record and carried opaquely (flagged by a
sentinel length), so arbitrary payloads still work without putting
pickle on the common path.

All integers are little-endian; vtimes are i64; ``-1`` encodes ``None``
for optional bounds / next-event times.
"""
from __future__ import annotations

import pickle
import struct
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.vtask import State

TAG_STEP = b"S"
TAG_REPLY = b"R"
TAG_PICKLE = b"P"

#: fixed State <-> wire index mapping (enum declaration order)
STATES: List[State] = list(State)
STATE_IDX: Dict[State, int] = {s: i for i, s in enumerate(STATES)}

_U32 = struct.Struct("<I")
_HOST_VT = struct.Struct("<iq")            # host id, vtime-or--1
_TASK_STATE = struct.Struct("<Iqb")        # task idx, vtime, state idx
#: envelope fixed part: src_hub u16, dst_hub u16, src_ep u32, dst_ep
#: u32, size i64, send_vtime i64, seq i64, sent_at i64, hops i32
_ENV = struct.Struct("<HHIIqqqqi")
_NO_PAYLOAD = 0xFFFFFFFF
#: reply header: flags u8, dispatches u32, wakes u32
_REPLY_HDR = struct.Struct("<BII")
FLAG_UNFINISHED = 1
FLAG_APPLIED = 2
FLAG_LAZY = 4

#: byte offsets of the two fields the coordinator reads while routing
#: (layout: HH hubs, II endpoints, then q size, q send_vtime, ...)
_ENV_DST_HUB_OFF = 2
_ENV_SEND_VT_OFF = 2 + 2 + 4 + 4 + 8


def pack_envelope(src_hub: int, dst_hub: int, src_ep: int, dst_ep: int,
                  size_bytes: int, send_vtime: int, seq: int,
                  sent_at: int, hops: int, payload: Any) -> bytes:
    head = _ENV.pack(src_hub, dst_hub, src_ep, dst_ep, size_bytes,
                     send_vtime, seq, sent_at, hops)
    if payload is None:
        return head + _U32.pack(_NO_PAYLOAD)
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    return head + _U32.pack(len(blob)) + blob


def scan_envelope(buf: bytes, off: int) -> Tuple[int, int, int]:
    """Routing-only scan: returns (dst_hub_idx, send_vtime, next_off)
    without decoding the record."""
    (dst_hub,) = struct.unpack_from("<H", buf, off + _ENV_DST_HUB_OFF)
    (send_vt,) = struct.unpack_from("<q", buf, off + _ENV_SEND_VT_OFF)
    end = off + _ENV.size
    (plen,) = _U32.unpack_from(buf, end)
    end += _U32.size
    if plen != _NO_PAYLOAD:
        end += plen
    return dst_hub, send_vt, end


def unpack_envelope(buf: bytes, off: int) -> Tuple[tuple, Any, int]:
    """Full decode (worker side): returns (fixed fields, payload,
    next_off)."""
    fields = _ENV.unpack_from(buf, off)
    end = off + _ENV.size
    (plen,) = _U32.unpack_from(buf, end)
    end += _U32.size
    payload = None
    if plen != _NO_PAYLOAD:
        payload = pickle.loads(buf[end:end + plen])
        end += plen
    return fields, payload, end


def _pack_host_vts(items: Iterable[Tuple[int, Optional[int]]]) -> bytes:
    items = list(items)
    return _U32.pack(len(items)) + b"".join(
        _HOST_VT.pack(h, -1 if v is None else v) for h, v in items)


def _unpack_host_vts(buf: bytes, off: int
                     ) -> Tuple[Dict[int, Optional[int]], int]:
    (n,) = _U32.unpack_from(buf, off)
    off += _U32.size
    out: Dict[int, Optional[int]] = {}
    for _ in range(n):
        h, v = _HOST_VT.unpack_from(buf, off)
        off += _HOST_VT.size
        out[h] = None if v < 0 else v
    return out, off


def _pack_task_states(states: Dict[int, Tuple[int, int]]) -> bytes:
    return _U32.pack(len(states)) + b"".join(
        _TASK_STATE.pack(i, vt, st) for i, (vt, st) in states.items())


def _unpack_task_states(buf: bytes, off: int
                        ) -> Tuple[Dict[int, Tuple[int, int]], int]:
    (n,) = _U32.unpack_from(buf, off)
    off += _U32.size
    out: Dict[int, Tuple[int, int]] = {}
    for _ in range(n):
        i, vt, st = _TASK_STATE.unpack_from(buf, off)
        off += _TASK_STATE.size
        out[i] = (vt, st)
    return out, off


def _pack_envs(records: List[bytes]) -> bytes:
    return _U32.pack(len(records)) + b"".join(records)


def pack_step(bounds: Dict[int, Optional[int]],
              updates: Dict[int, Tuple[int, int]],
              envelopes: List[bytes]) -> bytes:
    return b"".join((TAG_STEP, _pack_host_vts(bounds.items()),
                     _pack_task_states(updates), _pack_envs(envelopes)))


def unpack_step(frame: bytes) -> Tuple[Dict[int, Optional[int]],
                                       Dict[int, Tuple[int, int]],
                                       bytes, int, int]:
    """Returns (bounds, updates, buffer, env_offset, n_envelopes); the
    caller iterates envelope records with :func:`unpack_envelope`."""
    off = 1
    bounds, off = _unpack_host_vts(frame, off)
    updates, off = _unpack_task_states(frame, off)
    (n_env,) = _U32.unpack_from(frame, off)
    return bounds, updates, frame, off + _U32.size, n_env


def pack_reply(*, unfinished: bool, applied: bool, lazy_changed: bool,
               dispatches: int, wakes: int,
               next_times: Dict[int, Optional[int]],
               task_states: Dict[int, Tuple[int, int]],
               envelopes: List[bytes]) -> bytes:
    flags = ((FLAG_UNFINISHED if unfinished else 0)
             | (FLAG_APPLIED if applied else 0)
             | (FLAG_LAZY if lazy_changed else 0))
    return b"".join((TAG_REPLY, _REPLY_HDR.pack(flags, dispatches, wakes),
                     _pack_host_vts(next_times.items()),
                     _pack_task_states(task_states),
                     _pack_envs(envelopes)))


class Reply:
    """Decoded REPLY frame; envelope records stay as opaque byte
    slices (the coordinator only routes them)."""

    __slots__ = ("unfinished", "applied", "lazy_changed", "dispatches",
                 "wakes", "next_times", "task_states", "envelopes")

    def __init__(self, frame: bytes):
        flags, self.dispatches, self.wakes = _REPLY_HDR.unpack_from(
            frame, 1)
        self.unfinished = bool(flags & FLAG_UNFINISHED)
        self.applied = bool(flags & FLAG_APPLIED)
        self.lazy_changed = bool(flags & FLAG_LAZY)
        off = 1 + _REPLY_HDR.size
        self.next_times, off = _unpack_host_vts(frame, off)
        self.task_states, off = _unpack_task_states(frame, off)
        (n_env,) = _U32.unpack_from(frame, off)
        off += _U32.size
        #: (dst_hub_idx, send_vtime, record bytes) per envelope
        self.envelopes: List[Tuple[int, int, bytes]] = []
        for _ in range(n_env):
            dst_hub, send_vt, end = scan_envelope(frame, off)
            self.envelopes.append((dst_hub, send_vt, frame[off:end]))
            off = end


def pack_pickle(tag: str, payload: Any) -> bytes:
    return TAG_PICKLE + pickle.dumps((tag, payload),
                                     protocol=pickle.HIGHEST_PROTOCOL)


def unpack_pickle(frame: bytes) -> Tuple[str, Any]:
    return pickle.loads(frame[1:])
