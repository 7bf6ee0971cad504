"""The Workload protocol: reusable vtask program factories.

A workload declares *what runs*, independent of where it runs and what
faults are injected:

* :meth:`Workload.fabrics` — the logical message fabrics it needs.
* :meth:`Workload.programs` — one :class:`Program` per vtask: a body
  factory plus the endpoints it owns (name + fabric).
* :meth:`Workload.traffic` — program-pair traffic weights, consumed by
  declarative placement (``Orchestrator.co_locate``).
* :meth:`Workload.scopes` — bounded-skew synchronization scopes.
* :meth:`Workload.progress` — named progress arrays surfaced in the
  :class:`~repro_torch.sim.report.SimReport` (and the observable blast radius
  of fault injections).

Bodies never reference hosts, hubs, or schedulers — the
:class:`~repro_torch.sim.simulation.Simulation` wires those, so the same
workload runs single-host, sharded across an orchestrated cluster, or
under any :class:`~repro_torch.sim.scenario.Scenario` without modification.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch.core.ipc import Endpoint
from repro_torch.sim.topology import FabricSpec


@dataclasses.dataclass(frozen=True)
class EndpointSpec:
    """An endpoint a program owns: attach ``name`` to fabric ``fabric``."""
    name: str
    fabric: str


#: A body factory: receives the program's own endpoints (name -> Endpoint)
#: and returns the vtask generator.
BodyFactory = Callable[[Dict[str, Endpoint]], Iterator]


@dataclasses.dataclass
class Program:
    """One vtask, declaratively: name, body factory, owned endpoints.

    ``on_fail`` lets a workload intercept the fault plan: when the
    scenario resolves a failure for this program (an explicit
    ``FailTask`` or a ``FailHost`` expansion), the facade calls
    ``on_fail(failspec)`` at build time instead of blindly wrapping the
    body.  Return ``"kill"`` to keep the normal early-close wrapper
    (the workload just observed the death — e.g. a live trainer noting
    which shard host dies and when), or ``"survive"`` to suppress it
    (the program reacts to the failure itself, like a live program
    running detection + checkpoint recovery).

    ``handle``: a :class:`~repro_torch.sim.scenario.TaskHandle` the facade
    fills with the spawned VTask, so bodies that need their own vtime
    (live programs making vtime-gated decisions) can read it.
    """
    name: str
    make_body: BodyFactory
    endpoints: Tuple[EndpointSpec, ...] = ()
    kind: str = "modeled"            # "modeled" | "live"
    cell: Optional[str] = None
    on_fail: Optional[Callable[[Any], str]] = None
    handle: Optional[Any] = None


#: -- vectorized-engine op descriptors ------------------------------------
#: A workload that can be compiled by the vectorized engine lowers each
#: *modeled* program body to a flat op list (`Workload.vec_ops`).  The
#: descriptors mirror the generator actions one-for-one: the vectorized
#: compiler (``repro_torch.sim.vectorized``) proves the lowering admissible
#: (single-producer channels, no live calls, ...) and raises
#: ``UnsupportedByEngine`` otherwise — a workload returning ``None``
#: simply opts out.


@dataclasses.dataclass(frozen=True)
class VecCompute:
    """Modeled compute: advance the task's vtime by ``ns``."""
    ns: int


@dataclasses.dataclass(frozen=True)
class VecSend:
    """Send ``size_bytes`` from owned endpoint ``endpoint`` to ``dst``."""
    endpoint: str
    dst: str
    size_bytes: int


@dataclasses.dataclass(frozen=True)
class VecRecv:
    """Blocking receive on owned endpoint ``endpoint`` (payload unused —
    payload-dependent control flow is not lowerable)."""
    endpoint: str


@dataclasses.dataclass(frozen=True)
class VecMark:
    """Progress side effect: ``progress()[array][index] = value``, placed
    exactly where the generator body performs the assignment (so fault
    injections truncate progress identically in every engine)."""
    array: str
    index: int
    value: int


@dataclasses.dataclass(frozen=True)
class ScopeSpec:
    """A bounded-skew scope over ``members`` (None = every program of the
    declaring workload).  Spanning hosts it becomes a global scope with
    proxy vtasks; on one host, a plain :class:`~repro_torch.core.scope.Scope`."""
    name: str
    skew_bound_ns: int
    members: Optional[Tuple[str, ...]] = None


class Workload:
    """Base class; subclasses override :meth:`programs` at minimum."""

    name: str = "workload"

    def fabrics(self) -> List[FabricSpec]:
        return []

    def programs(self) -> List[Program]:
        raise NotImplementedError

    def traffic(self) -> Dict[Tuple[str, str], float]:
        return {}

    def scopes(self) -> List[ScopeSpec]:
        return []

    def progress(self) -> Dict[str, Any]:
        return {}

    def reset(self) -> None:
        """Clear run-scoped state (progress arrays, timelines, replay
        cursors).  Workloads allocate their progress buffers in
        ``__init__``, so without a reset a Workload instance reused
        across two ``Simulation.run()`` calls carries the first run's
        progress into the second's report (and a stale parent array
        double-counts in the dist engine's max-merge).
        ``Simulation.build()`` and the dist coordinator call this once
        per run, before anything executes; the default is a no-op for
        stateless workloads."""
        return None

    def vec_ops(self) -> Optional[Dict[str, List[Any]]]:
        """Program name -> flat op list (:class:`VecCompute` /
        :class:`VecSend` / :class:`VecRecv` / :class:`VecMark`),
        action-for-action identical to the generator bodies.  ``None``
        (the default) means the workload has no vectorized lowering and
        ``Simulation.run(engine="vectorized")`` raises
        ``UnsupportedByEngine``."""
        return None

    # -- live-execution hooks (repro_torch.sim.live) -------------------------------
    def live_mode(self) -> Optional[str]:
        """``"record"``/``"replay"`` for live workloads (the ledger
        mode), ``None`` for modeled ones.  The facade uses it to reject
        record mode under the dist engine (forked workers measuring wall
        time cannot produce one coherent trace)."""
        return None

    def live_fns(self) -> Dict[str, Any]:
        """Program name -> the real callable it wraps.  The dist engine
        pickles nothing (workers are forked), but a live fn that cannot
        be pickled is a reliable proxy for fork-unsafe captured state
        (JAX handles, locks, open files), so ``engine="dist"`` checks
        these at the facade and raises a clear error naming the fn."""
        return {}

    def live_report(self, tasks: Optional[set] = None
                    ) -> Optional[Dict[str, Any]]:
        """Post-run live section for :attr:`SimReport.live` (``None``
        for modeled workloads).  ``tasks`` restricts per-task entries to
        a subset — dist workers pass the task names they own, so the
        coordinator can merge disjoint worker sections."""
        return None
