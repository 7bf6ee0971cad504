"""Worker side of the multi-process dist engine.

Each OS worker process builds the *full* declarative
:class:`~repro_torch.sim.simulation.Simulation` (fork happens before build, so
every worker derives a bit-identical replica of all hosts, hubs, tasks,
scopes, and injection wiring) but *executes* only the schedulers of its
own host partition.  Everything outside the partition is a passive
replica used for three things:

* **Message replay** — a cross-partition message is serialized on the
  sender's hub (channel queuing + lookahead, exactly as in-process),
  shipped over the pipe as a packed binary envelope record
  (``repro_torch.dist.frames``), and replayed through ``dest_hub.route()`` on
  the owner, which computes the same visibility time the in-process
  engines would (per-channel ``busy_until`` only ever sees traffic from
  one sender, and pipes are FIFO, so replay order matches).
* **Proxy refresh** — :class:`~repro_torch.core.orchestrator.ProxyVTask`
  mirrors keep pointing at the local replica of the remote task; the
  coordinator broadcasts (vtime, state) *deltas* for proxied tasks, the
  worker applies them to the replicas, and the existing lazy
  pin-bound sync then works unchanged.
* **Accounting replay** — per-link visibility-slack stats for a
  cross-partition channel are computed on the destination owner
  (against its replica of the sender hub) and merged by the
  coordinator.

Because replicas are bit-identical, all name tables (hubs, endpoints,
tasks) are derived deterministically at build time and the wire carries
only integer indexes — see ``repro_torch.dist.frames``.

One coordinator round = one ``STEP`` -> ``REPLY`` exchange: the worker
injects envelopes, applies replica updates, runs one conservative
window per owned host (skipping hosts that are provably quiescent below
their bound), and replies with its outbox + clock state.  A worker that
owns *every* host (``n_workers == 1``) instead receives one
``run_all`` and free-runs the in-process async engine to completion —
no cross-partition channels exist, so there is nothing to mediate.

Safety: the coordinator computes a window's bounds from each host's
last-reported conservative next-event time, *capped* by the forwarded
send vtime of any envelope being delivered in the same STEP (a
delivered message can wake a receiver no earlier than that).  Bounds
are therefore always conservative, a message produced inside round
``r`` has visibility ``>= lb[sender] + lookahead >= EIT(receiver)``,
and the schedulers' strict window gate never consumes anything at or
past the receiver's bound — so delivering cross-partition messages one
round later is invisible to the simulation, which is what makes the
dist engine bit-identical to ``async``/``barrier``.
"""
from __future__ import annotations

import traceback
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.ipc import Message
from repro_torch.core.scheduler import DeadlockError
from repro_torch.dist import frames
from repro_torch.sim.report import HostReport

#: legacy in-process envelope: (src_hub, dst_hub, Message, send vtime)
Envelope = Tuple[str, str, Any, int]


class RemotePeer:
    """Stand-in for a peered hub owned by another worker.  Quacks just
    enough like a Hub for ``Hub.route``'s forwarding branch: name,
    endpoint membership (the local replica's), and ``forward`` instead
    of ``route``."""

    is_remote = True

    def __init__(self, replica_hub, outbox: List[Envelope]):
        self.name = replica_hub.name
        self.endpoints = replica_hub.endpoints
        self._outbox = outbox

    def forward(self, src_hub: str, msg, sent_at: int):
        self._outbox.append((src_hub, self.name, msg, sent_at))
        return msg


class DistWorker:
    def __init__(self, sim, worker_id: int,
                 partitions: List[List[int]]):
        self.sim = sim
        self.id = worker_id
        self.owned = sorted(partitions[worker_id])
        self.owner = {h: w for w, hosts in enumerate(partitions)
                      for h in hosts}
        self.outbox: List[Envelope] = []
        # dist replicas are wired exactly like the async engine; the
        # coordinator (not Orchestrator.run) drives the clock protocol.
        sim.mode = "async"
        sim.build()
        self.orch = sim.orchestrator
        self.hub_host = {hub.name: h for h, hub in self.orch.hubs.items()}
        self.hubs_by_name = {hub.name: hub
                             for hub in self.orch.hubs.values()}
        self.lookahead = self.orch.lookahead_map()
        # deterministic wire index tables — identical in every worker
        # (and in the coordinator, which receives them at handshake)
        # because all replicas build bit-identically.
        self.hub_names = sorted(self.hubs_by_name)
        self.hub_idx = {n: i for i, n in enumerate(self.hub_names)}
        self.ep_names = sorted({ep for hub in self.hubs_by_name.values()
                                for ep in hub.endpoints})
        self.ep_idx = {n: i for i, n in enumerate(self.ep_names)}
        self.task_names = [t.name for t in sim.tasks]
        self.task_idx = {n: i for i, n in enumerate(self.task_names)}
        self.task_by_idx = list(sim.tasks)
        # swap cross-partition peers of *owned* hubs for RemotePeer
        # stubs; replica hubs of other partitions never send.
        for h in self.owned:
            hub = self.orch.hubs.get(h)
            if hub is None:
                continue
            for pname in list(hub.peers):
                if self.owner[self.hub_host[pname]] != self.id:
                    hub.peers[pname] = RemotePeer(
                        self.hubs_by_name[pname], self.outbox)
        self.tasks_by_name = {
            t.name: t for sched in self.orch.hosts.values()
            for t in sched.tasks if t.kind != "proxy"}
        # owned tasks some other partition mirrors through a proxy: their
        # (vtime, state) deltas are exported to the coordinator every
        # round; replicas start bit-identical, so only changes travel.
        self.exports = sorted({
            p.remote.name for p in self.orch.proxies
            if self.owner[p.remote.host] == self.id
            and self.owner[p.host] != self.id})
        self._last_export: Dict[str, Tuple[int, int]] = {
            n: self._task_wire_state(n) for n in self.exports}
        # remote tasks mirrored by a proxy on one of *our* hosts: the
        # coordinator uses this interest set to skip broadcasting
        # irrelevant updates (and to skip this worker entirely when a
        # round carries nothing for it).
        self.imports = sorted({
            p.remote.name for p in self.orch.proxies
            if self.owner[p.host] == self.id
            and self.owner[p.remote.host] != self.id})

    def _task_wire_state(self, name: str) -> Tuple[int, int]:
        t = self.tasks_by_name[name]
        return (t.vtime, frames.STATE_IDX[t.state])

    # -- protocol phases -----------------------------------------------------
    def handshake(self) -> Dict[str, Any]:
        return {"hosts": self.owned,
                "lookahead": self.lookahead,
                "hub_host": self.hub_host,
                "hub_names": self.hub_names,
                "task_names": self.task_names,
                "exports": self.exports,
                "imports": self.imports,
                "next_times": self.next_times(),
                "unfinished": self.unfinished(),
                # membership timeline (identical in every replica): the
                # coordinator mirrors the async engine's epoch-scoped
                # LBTS clamps from this
                "join_vtime": dict(self.orch.join_vtime)}

    def inject(self, frame: bytes, off: int, n_env: int) -> None:
        """Replay cross-partition envelope records on the owned
        destination hub (visibility computation identical to the
        in-process route) and mirror the sender-side per-link accounting
        on our replica of the sender hub."""
        for _ in range(n_env):
            fields, payload, off = frames.unpack_envelope(frame, off)
            (src_hub_i, dst_hub_i, src_ep_i, dst_ep_i, size_bytes,
             send_vtime, seq, sent_at, hops) = fields
            msg = Message(src=self.ep_names[src_ep_i],
                          dst=self.ep_names[dst_ep_i],
                          size_bytes=size_bytes, send_vtime=send_vtime,
                          payload=payload, seq=seq, hops=hops)
            src_name = self.hub_names[src_hub_i]
            dst_name = self.hub_names[dst_hub_i]
            routed = self.hubs_by_name[dst_name].route(msg)
            src_hub = self.hubs_by_name[src_name]
            link = src_hub.peer_links.get(dst_name, src_hub.peer_link)
            src_hub._account_peer(dst_name, routed, sent_at, link)

    def apply_updates(self, updates: Dict[int, Tuple[int, int]]) -> bool:
        """Refresh replicas of remote tasks from the coordinator's
        broadcast deltas; proxies pick the new values up at the next
        lazy sync.  Returns True iff anything changed (progress
        signal)."""
        changed = False
        for idx, (vtime, state_i) in updates.items():
            task = self.task_by_idx[idx]
            if self.owner[task.host] == self.id:
                continue
            state = frames.STATES[state_i]
            if task.vtime != vtime or task.state is not state:
                task.vtime = vtime
                task.state = state
                changed = True
        return changed

    def next_times(self) -> Dict[int, Optional[int]]:
        return {h: self.orch.hosts[h].next_time() for h in self.owned}

    def unfinished(self) -> bool:
        return any(self.orch.hosts[h].has_unfinished()
                   for h in self.owned)

    def _pack_outbox(self) -> List[bytes]:
        records = [frames.pack_envelope(
            self.hub_idx[src], self.hub_idx[dst],
            self.ep_idx[msg.src], self.ep_idx[msg.dst],
            msg.size_bytes, msg.send_vtime, msg.seq, sent_at, msg.hops,
            msg.payload) for src, dst, msg, sent_at in self.outbox]
        # drain in place: the RemotePeer stubs hold a reference to this
        # exact list, so rebinding would silently disconnect them.
        self.outbox.clear()
        return records

    def _export_deltas(self) -> Dict[int, Tuple[int, int]]:
        out: Dict[int, Tuple[int, int]] = {}
        for n in self.exports:
            cur = self._task_wire_state(n)
            if cur != self._last_export[n]:
                self._last_export[n] = cur
                out[self.task_idx[n]] = cur
        return out

    def step(self, frame: bytes) -> bytes:
        """One coalesced coordinator round: inject + apply + run one
        conservative window per owned host, mirroring one host iteration
        of ``Orchestrator._run_async`` (including the quiescent-host
        skip), and reply with outbox + clock state."""
        bounds, updates, buf, off, n_env = frames.unpack_step(frame)
        self.inject(buf, off, n_env)
        applied = self.apply_updates(updates)
        stats = self.orch.stats
        d0 = sum(self.orch.hosts[h].stats.dispatches for h in self.owned)
        w0 = sum(self.orch.hosts[h].stats.wakes for h in self.owned)
        lazy_changed = False
        for h in self.owned:
            sched = self.orch.hosts[h]
            bound = bounds.get(h)
            if self.orch._lazy_sync(h, bound):
                lazy_changed = True
            elif sched.quiescent_below(bound):
                stats["quiescent_skips"] += 1
                continue
            if bound is not None:
                start = sched.next_time()
                if start is not None and bound > start:
                    stats["max_window_ns"] = max(
                        stats["max_window_ns"], bound - start)
            sched.run_until(bound)
        return frames.pack_reply(
            unfinished=self.unfinished(), applied=applied,
            lazy_changed=lazy_changed,
            dispatches=sum(self.orch.hosts[h].stats.dispatches
                           for h in self.owned) - d0,
            wakes=sum(self.orch.hosts[h].stats.wakes
                      for h in self.owned) - w0,
            next_times=self.next_times(),
            task_states=self._export_deltas(),
            envelopes=self._pack_outbox())

    #: sole-worker heartbeat cadence: free-run this many engine rounds
    #: between ticks so the coordinator's per-reply timeout stays a
    #: liveness bound, not a cap on total run length
    RUN_ALL_CHUNK = 20_000

    def run_all(self, max_rounds: int, tick) -> Dict[str, Any]:
        """Sole-worker fast path: this worker owns every host, so there
        are no cross-partition channels, no proxies to refresh remotely,
        and nothing for the coordinator to mediate — free-run the
        in-process async engine instead of paying one pipe round-trip
        per conservative window.  Runs in bounded chunks, calling
        ``tick()`` between chunks to heartbeat the coordinator."""
        status, detail, info = "ok", "", {}
        remaining = max_rounds
        try:
            while True:
                chunk = min(self.RUN_ALL_CHUNK, remaining)
                if self.orch._run_async(chunk, raise_on_exhaust=False):
                    break
                remaining -= chunk
                if remaining <= 0:
                    status = "deadlock"
                    detail = (f"dist engine exceeded {max_rounds} "
                              f"rounds without finishing")
                    break
                tick()
        except DeadlockError as e:
            status, detail, info = "deadlock", str(e), e.info
        return {"status": status, "detail": detail, "info": info,
                "rounds": self.orch.stats["epochs"]}

    def final_report(self) -> Dict[str, Any]:
        orch = self.orch
        self.orch._note_staleness()
        owned_hubs = [orch.hubs[h] for h in self.owned if h in orch.hubs]
        links = {}
        for hub in self.hubs_by_name.values():
            for peer, st in hub.peer_stats.items():
                if self.owner[self.hub_host[peer]] == self.id:
                    links[f"{hub.name}->{peer}"] = dict(st)
        staleness = max((p.max_staleness_ns
                         for h in self.owned
                         for p in orch._host_proxies.get(h, ())),
                        default=0)
        # §3.3 cell state is per host and only the owner executed these
        # hosts, so each worker's snapshots are authoritative and
        # disjoint — the coordinator merges them by host key.
        cells = {}
        for h in self.owned:
            snap = orch.hosts[h].cells.snapshot()
            if snap is not None:
                cells[str(h)] = snap
        # live sections: per-task entries restricted to owned tasks (the
        # owner executed them; the rest is deterministic build-time data
        # the coordinator dedups)
        owned_tasks = {t.name for t in self.sim.tasks
                       if self.owner[t.host] == self.id}
        live = {}
        for wl in self.sim.workloads:
            sec = wl.live_report(owned_tasks)
            if sec is not None:
                live[wl.name] = sec
        # control-plane sections: controller state lives on exactly one
        # host (the facade co-locates source/LB/controller), so only the
        # owner of the controller task reports a non-None section and
        # the coordinator's first-non-empty merge is authoritative
        control = {}
        for wl in self.sim.workloads:
            fn = getattr(wl, "control_report", None)
            sec = fn(owned_tasks) if fn is not None else None
            if sec is not None:
                control[wl.name] = sec
        return {
            "cells": cells,
            "live": live,
            "control": control,
            "membership": self.orch.membership_timeline(),
            "hosts": [HostReport.from_sched(h, orch.hosts[h].stats)
                      for h in self.owned],
            "messages": sum(h.stats["messages"] for h in owned_hubs),
            "bytes": sum(h.stats["bytes"] for h in owned_hubs),
            "links": links,
            "tasks": {t.name: {"vtime": t.vtime, "state": t.state.value,
                               "host": t.host}
                      for t in self.sim.tasks
                      if self.owner[t.host] == self.id},
            "progress": {wl.name: dict(wl.progress())
                         for wl in self.sim.workloads},
            "horizon": max((t.vtime for h in self.owned
                            for t in orch.hosts[h].tasks
                            if t.kind != "proxy"), default=0),
            "proxy_syncs": orch.stats["proxy_syncs"],
            "max_proxy_staleness_ns": staleness,
            "max_window_ns": orch.stats["max_window_ns"],
        }


def worker_main(sim, worker_id: int, partitions: List[List[int]],
                conn) -> None:
    """Process entry point: build, handshake, then serve coordinator
    frames until ``finalize``.  Any exception is shipped back as an
    ``("error", traceback)`` pickle frame so the coordinator fails fast
    instead of hanging on a dead pipe."""
    try:
        worker = DistWorker(sim, worker_id, partitions)
        conn.send_bytes(frames.pack_pickle("ready", worker.handshake()))
        while True:
            frame = conn.recv_bytes()
            tag = frame[:1]
            if tag == frames.TAG_STEP:
                conn.send_bytes(worker.step(frame))
            elif tag == frames.TAG_PICKLE:
                sub, payload = frames.unpack_pickle(frame)
                if sub == "run_all":
                    def tick():
                        conn.send_bytes(frames.pack_pickle("tick", None))
                    conn.send_bytes(frames.pack_pickle(
                        "ran_all", worker.run_all(payload, tick)))
                elif sub == "finalize":
                    conn.send_bytes(frames.pack_pickle(
                        "report", worker.final_report()))
                    return
                else:
                    raise ValueError(
                        f"unknown coordinator message {sub!r}")
            else:
                raise ValueError(f"unknown frame tag {tag!r}")
    except (EOFError, KeyboardInterrupt):
        return
    except BaseException:
        try:
            conn.send_bytes(frames.pack_pickle(
                "error", traceback.format_exc()))
        except (BrokenPipeError, OSError):
            pass
