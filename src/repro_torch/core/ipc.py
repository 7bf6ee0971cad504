"""Simulation-aware IPC (paper §3.4): messages, endpoints, hubs.

* **Message** separates timing control from data movement: metadata holds
  addressing + virtual-time info (send vtime, computed visibility time);
  the payload rides alongside (the shared-memory path of the paper is an
  in-process reference, which is exactly zero-copy here).
* **Endpoint** proxies a component's communication interface.  Each has a
  per-receiver incoming queue ordered by visibility time; the scheduler
  reads the queue head as a dispatch hint.
* **Hub** is the kernel-resident router: lightweight routing + latency
  control on the common path.  ``hook`` is the eBPF analogue — a pure
  function (msg, hub state) -> extra_latency_ns / rerouting that runs
  inline in the hub without a context switch.  Heavier behavior is a
  modeled component behind the same endpoint—hub interface
  (``ModeledHubComponent``).

Latency model on the common path (per link): serialization (size/bw) +
propagation (latency_ns) + FIFO queuing (link busy-until tracking).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.vtime import SEC


@dataclasses.dataclass
class Message:
    src: str
    dst: str
    size_bytes: int
    send_vtime: int
    visibility_time: int = 0
    payload: Any = None
    seq: int = 0
    hops: int = 0

    def sort_key(self):
        # (visibility, src, per-src seq): a process-independent total
        # order.  seq is assigned per *sender* (see Hub.send), so the
        # same simulation produces the same tie-break whether it runs in
        # one process or sharded across dist workers — a global counter
        # would encode which process happened to assign it.
        return (self.visibility_time, self.src, self.seq)


@dataclasses.dataclass
class LinkSpec:
    bandwidth_bps: float = 10e9 * 8      # 10 GB/s default
    latency_ns: int = 2_000              # 2 us
    mtu: int = 0                         # 0 = no segmentation


class Endpoint:
    """A component port.  ``owner`` is the vtask that receives here."""

    def __init__(self, name: str, owner=None):
        self.name = name
        self.owner = owner
        self.hub: Optional["Hub"] = None
        self._queue: List[Tuple[Tuple[int, int], Message]] = []
        self._waiters: List[Any] = []    # vtasks blocked on this endpoint

    # receiver side --------------------------------------------------------
    def deliver(self, msg: Message) -> None:
        heapq.heappush(self._queue, (msg.sort_key(), msg))
        head = self._queue[0][1].visibility_time
        if self.owner is not None:
            self.owner.inbox_hint = head
        if self._waiters:
            # index the (possibly new) head visibility for receivers that
            # blocked here, so the scheduler's wake pass finds them
            # without scanning; prune waiters that have moved on
            keep = []
            for t in self._waiters:
                r = t._wait_reason
                if r is not None and r[0] == "recv" and r[1] is self:
                    keep.append(t)
                    if t.sched is not None:
                        t.sched._wait_push(t, head)
            self._waiters = keep

    def head_visibility(self) -> Optional[int]:
        return self._queue[0][1].visibility_time if self._queue else None

    def pop_visible(self, vtime: int) -> Optional[Message]:
        """Messages become visible only in virtual-time order."""
        if self._queue and self._queue[0][1].visibility_time <= vtime:
            _, msg = heapq.heappop(self._queue)
            if self.owner is not None:
                self.owner.inbox_hint = self.head_visibility()
            return msg
        return None

    def pending(self) -> int:
        return len(self._queue)


HookFn = Callable[[Message, Dict[str, Any]], int]


class Hub:
    """Kernel-resident message router with per-link latency control."""

    def __init__(self, name: str, default_link: LinkSpec = LinkSpec()):
        self.name = name
        self._src_seq: Dict[str, int] = {}        # per-sender message seq
        self.endpoints: Dict[str, Endpoint] = {}
        self.links: Dict[Tuple[str, str], LinkSpec] = {}
        self.default_link = default_link
        self.hooks: List[HookFn] = []
        # ingress hooks run only on the hub that owns the destination
        # endpoint (the local-delivery branch of route()), so a
        # cross-host message is charged exactly once — at the receiver
        self.ingress_hooks: List[HookFn] = []
        self.state: Dict[str, Any] = {}           # hook scratch state
        self.busy_until: Dict[Tuple[str, str], int] = {}
        self.stats = {"messages": 0, "bytes": 0, "queued_ns": 0}
        self.peers: Dict[str, "Hub"] = {}         # distributed hub instances
        self.peer_link: LinkSpec = LinkSpec(bandwidth_bps=25e9 * 8,
                                            latency_ns=10_000)
        # per-peer link specs (heterogeneous topologies) + per-link
        # visibility-time accounting.  ``peer_link`` stays as the default
        # for peers without an explicit entry (back-compat).
        self.peer_links: Dict[str, LinkSpec] = {}
        self.peer_stats: Dict[str, Dict[str, int]] = {}

    # wiring -----------------------------------------------------------------
    def attach(self, ep: Endpoint) -> Endpoint:
        self.endpoints[ep.name] = ep
        ep.hub = self
        return ep

    def connect(self, a: str, b: str, link: LinkSpec) -> None:
        self.links[(a, b)] = link
        self.links[(b, a)] = link

    def add_hook(self, fn: HookFn) -> None:
        """eBPF-analogue: inline, pure extra-latency/steering program."""
        self.hooks.append(fn)

    def add_ingress_hook(self, fn: HookFn) -> None:
        """Receiver-side hook: runs only when *this* hub delivers the
        message to a local endpoint (after any cross-host forwarding),
        e.g. per-host receive-clock skew.  Add-only, like hooks."""
        self.ingress_hooks.append(fn)

    def peer_with(self, other: "Hub", link: Optional[LinkSpec] = None):
        """Distributed hub instance (paper §3.5): one logical hub spanning
        hosts; cross-instance messages carry addressing+visibility
        metadata over the host interconnect link.

        ``link`` is recorded per peer pair, so different pairs may use
        different interconnects (fast intra-rack vs slow cross-rack); the
        per-pair latency is the conservative lookahead of that channel."""
        self.peers[other.name] = other
        other.peers[self.name] = self
        if link is not None:
            self.peer_link = link
            other.peer_link = link
        # pin the pair's link at peering time (each direction from the
        # sender's current default when none is given) so a later
        # peer_with on some *other* pair cannot retroactively change
        # this channel via the shared scalar
        self.peer_links[other.name] = link or self.peer_link
        other.peer_links[self.name] = link or other.peer_link

    def lookahead_ns(self, peer_name: str) -> int:
        """Guaranteed minimum delay of any message sent to ``peer_name``:
        a message sent at t is never visible there before t + lookahead."""
        return self.peer_links.get(peer_name, self.peer_link).latency_ns

    # data path ----------------------------------------------------------------
    def _link(self, src: str, dst: str) -> LinkSpec:
        return self.links.get((src, dst), self.default_link)

    def send(self, src: str, dst: str, size_bytes: int, send_vtime: int,
             payload: Any = None) -> Message:
        seq = self._src_seq.get(src, 0)
        self._src_seq[src] = seq + 1
        msg = Message(src=src, dst=dst, size_bytes=size_bytes,
                      send_vtime=send_vtime, payload=payload, seq=seq)
        return self.route(msg)

    def route(self, msg: Message) -> Message:
        msg.hops += 1
        extra = 0
        for hook in self.hooks:
            extra += int(hook(msg, self.state))
        # hooks may only *add* latency: a negative total would let a
        # message undercut the link's guaranteed lookahead and break
        # conservative cross-host synchronization.
        extra = max(0, extra)
        if msg.dst not in self.endpoints:
            # cross-host: forward to the distributed hub instance owning dst
            for peer in self.peers.values():
                if msg.dst in peer.endpoints:
                    link = self.peer_links.get(peer.name, self.peer_link)
                    sent_at = msg.send_vtime
                    msg.send_vtime = self._serialize(msg, ("__peer__",
                                                           peer.name),
                                                     link, extra)
                    if getattr(peer, "is_remote", False):
                        # dist engine: the peer hub lives in another OS
                        # process (repro_torch.dist.worker.RemotePeer).  The
                        # owning worker replays route() on its replica
                        # and performs the per-link accounting there.
                        return peer.forward(self.name, msg, sent_at)
                    routed = peer.route(msg)
                    self._account_peer(peer.name, routed, sent_at, link)
                    return routed
            raise KeyError(f"hub {self.name}: unknown endpoint {msg.dst}")
        if self.ingress_hooks:
            # same add-only contract as sender hooks: clamped as a
            # group so a (buggy) negative hook cannot undercut the
            # link's guaranteed lookahead
            extra += max(0, sum(int(fn(msg, self.state))
                                for fn in self.ingress_hooks))
        link = self._link(msg.src, msg.dst)
        msg.visibility_time = self._serialize(msg, (msg.src, msg.dst),
                                              link, extra)
        self.endpoints[msg.dst].deliver(msg)
        self.stats["messages"] += 1
        self.stats["bytes"] += msg.size_bytes
        return msg

    def _account_peer(self, peer_name: str, msg: Message, sent_at: int,
                      link: LinkSpec) -> None:
        """Per-link visibility-time accounting: every cross-host message
        must satisfy visibility >= send + link latency (slack >= 0), which
        is exactly the invariant the per-link lookahead relies on."""
        st = self.peer_stats.setdefault(
            peer_name, {"messages": 0, "bytes": 0,
                        "min_slack_ns": None, "max_visibility_ns": 0})
        st["messages"] += 1
        st["bytes"] += msg.size_bytes
        slack = msg.visibility_time - sent_at - link.latency_ns
        st["min_slack_ns"] = (slack if st["min_slack_ns"] is None
                              else min(st["min_slack_ns"], slack))
        st["max_visibility_ns"] = max(st["max_visibility_ns"],
                                      msg.visibility_time)

    def _serialize(self, msg: Message, link_key, link: LinkSpec,
                   extra_ns: int) -> int:
        ser_ns = int(msg.size_bytes * 8 / link.bandwidth_bps * SEC)
        start = max(msg.send_vtime, self.busy_until.get(link_key, 0))
        self.stats["queued_ns"] += start - msg.send_vtime
        end = start + ser_ns
        self.busy_until[link_key] = end
        return end + link.latency_ns + extra_ns


class ModeledHubComponent:
    """Detailed connection behavior as a modeled component behind the same
    endpoint—hub interface (paper: 'more detailed connection behavior can
    instead be modeled as a separate component ... at higher overhead').

    Wrap as a vtask body with ``switch_vtask_body``: it drains its ingress
    endpoint, applies a per-message service model, and re-routes."""

    def __init__(self, name: str, hub: Hub, service_fn):
        self.name = name
        self.hub = hub
        self.ingress = hub.attach(Endpoint(f"{name}.in"))
        self.service_fn = service_fn       # (msg) -> (service_ns, out_dst)
