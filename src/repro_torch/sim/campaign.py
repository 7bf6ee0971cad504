"""Fault-campaign harness: swept fault grids, outcome classification,
and delta-minimized reproducers (ROADMAP item 4).

A :class:`Campaign` takes a *base* simulation factory (``make_sim:
Scenario -> Simulation`` — a fresh simulation per call, since built
simulations are single-shot) and a :class:`FaultGrid` — axes over
injection **type** x **target** x **vtime** x **count** plus per-type
knobs.  Every grid point becomes one Scenario, every point runs
deterministically (vectorized ``sweep`` fast path on ``device`` where
the compiled surface allows, per-point async fallback otherwise; a
missing card, a failed kernel build or launch raises instead of falling
back, so a report's ``fast_path`` always says where the points ran;
execution order is
a seeded permutation but results are keyed by grid index, so reports
are order-independent), and every outcome is classified against a
fault-free baseline:

* ``crash``               — the engine raised (hub routing on a
                            corrupted payload, a dead dist worker, …);
                            the traceback is captured in the report and
                            the sweep *continues*.
* ``invariant-violation`` — a task went FAULTY (progress preemption) or
                            a link's visibility slack went negative, or
                            a user invariant hook returned violations.
* ``deadlock``            — ``SimReport.status == "deadlock"``.
* ``divergence``          — the run completed but its *functional
                            fingerprint* (task states/hosts, progress
                            arrays, message/byte totals) differs from
                            the baseline: the fault changed what
                            happened, not just when.
* ``ok``                  — masked or timing-only fault.

Every failing point is **delta-minimized** to a smallest reproducer:
greedy injection dropping to a fixpoint, then binary-shrinking integer
fields (vtimes, steps, offsets, extras) toward 0 and targets toward the
front of the target axis — clkscrew's parameter-grid search harness
applied to vtime/placement/fault axes.  The result is a replayable
``fault_repro/v1`` JSON spec whose serialization is byte-identical
across runs *and across campaign engines* (minimization trials always
run on the in-process reference engine; classification uses only
engine-independent report fields).

CLI::

    python -m repro_torch.sim.campaign list
    python -m repro_torch.sim.campaign run --base rack_ring@v1 --json out.json
    python -m repro_torch.sim.campaign minimize --base serve_smoke@v1 --point 3
    python -m repro_torch.sim.campaign smoke          # the CI gate
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import time
import traceback as _traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.sim.report import SimReport, _jsonable
from repro_torch.sim.scenario import (BitFlip, ClockSkew, DegradeLink,
                                FailHost, FailTask, Injection,
                                Interference, JoinHost, Scenario,
                                Straggler)
from repro_torch.sim.simulation import Simulation

OUTCOMES = ("ok", "deadlock", "invariant-violation", "crash",
            "divergence")

REPRO_SCHEMA = "fault_repro/v1"
REPORT_SCHEMA = "campaign_report/v1"

#: engine used for baseline, fallback points, and every minimization
#: trial: in-process, works for any host count, and classification
#: reads only engine-independent fields — so reproducer specs come out
#: byte-identical no matter which engine the campaign itself ran on
REF_ENGINE = "async"


def _ref_run(sim: Simulation) -> SimReport:
    """Run on the in-process reference engine.  Single-host sims stay
    on their constructed mode (the plain scheduler — bit-identical to
    async on every field classification reads)."""
    if sim.topology.n_hosts == 1:
        return sim.run()
    return sim.run(engine=REF_ENGINE)


# ---------------------------------------------------------------------------
# injection <-> JSON (the reproducer spec's vocabulary)
# ---------------------------------------------------------------------------

_INJECTION_TYPES: Dict[str, type] = {
    "Straggler": Straggler, "FailTask": FailTask, "FailHost": FailHost,
    "DegradeLink": DegradeLink, "Interference": Interference,
    "BitFlip": BitFlip, "ClockSkew": ClockSkew, "JoinHost": JoinHost,
}


def injection_to_dict(inj: Injection) -> dict:
    """Type-tagged, None-stripped, JSON-able encoding of one
    injection (tuples become lists; ``injection_from_dict`` restores
    them)."""
    d = {k: _jsonable(v)
         for k, v in dataclasses.asdict(inj).items() if v is not None}
    d["type"] = type(inj).__name__
    return d


def injection_from_dict(d: dict) -> Injection:
    kind = d.get("type")
    cls = _INJECTION_TYPES.get(kind)
    if cls is None:
        raise ValueError(f"unknown injection type {kind!r}; expected "
                         f"one of {sorted(_INJECTION_TYPES)}")
    kw = {k: v for k, v in d.items() if k != "type"}
    if cls is DegradeLink and kw.get("hosts") is not None:
        kw["hosts"] = tuple(kw["hosts"])
    return cls(**kw)


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

#: injection builders per grid type.  Signature:
#: (target, vtime, knobs, host_of) -> Injection.  ``host_of`` coerces a
#: task-name target to its placed host for host-typed injections.
#: Extend the campaign vocabulary by registering here.
BUILDERS: Dict[str, Callable[..., Injection]] = {}


def _builder(name):
    def deco(fn):
        BUILDERS[name] = fn
        return fn
    return deco


@_builder("straggler")
def _b_straggler(target, vtime, knobs, host_of):
    # timing-only: the vtime axis has no trigger here (a straggler is
    # active for the whole run)
    return Straggler(str(target), float(knobs.get("slowdown", 3.0)))


@_builder("fail_task")
def _b_fail_task(target, vtime, knobs, host_of):
    return FailTask(str(target), at_vtime=int(vtime))


@_builder("fail_host")
def _b_fail_host(target, vtime, knobs, host_of):
    return FailHost(host=host_of(target), at_vtime=int(vtime))


@_builder("degrade_link")
def _b_degrade_link(target, vtime, knobs, host_of):
    return DegradeLink(fabric=str(target),
                       extra_ns=int(knobs.get("extra_ns", 25_000)),
                       from_vtime=int(vtime))


@_builder("bitflip")
def _b_bitflip(target, vtime, knobs, host_of):
    return BitFlip(str(target), at_vtime=int(vtime),
                   bit=int(knobs.get("bit", 0)))


@_builder("join_host")
def _b_join_host(target, vtime, knobs, host_of):
    # membership churn: the vtime axis is the join time.  vtime 0 means
    # a founding member (not a late join), so clamp to >= 1 — the grid's
    # shared vtime axis routinely starts at 0.
    return JoinHost(host=host_of(target), at_vtime=max(1, int(vtime)))


@_builder("clock_skew")
def _b_clock_skew(target, vtime, knobs, host_of):
    # the vtime axis is the skew magnitude: a constant receive-side
    # offset on the target host
    return ClockSkew(host=host_of(target), offset_ns=int(vtime),
                     drift_ppm=int(knobs.get("drift_ppm", 0)))


@dataclasses.dataclass(frozen=True)
class GridPoint:
    """One materialized grid point: its stable index in axis-product
    order (reports and reproducers key on this, not on execution
    order), the axis values that produced it, and the Scenario."""
    index: int
    type: str
    target: Any
    vtime: int
    count: int
    scenario: Scenario


class FaultGrid:
    """The swept parameter space: ``types x targets x vtimes x counts``
    (+ per-type ``knobs``).  ``count=k`` expands a point into ``k``
    injections of the same type on ``k`` consecutive targets (wrapping
    around the target axis) — correlated faults, not independent
    singles."""

    def __init__(self, *, types: Sequence[str],
                 targets: Sequence[Any],
                 vtimes: Sequence[int],
                 counts: Sequence[int] = (1,),
                 knobs: Optional[Dict[str, Any]] = None):
        unknown = [t for t in types if t not in BUILDERS]
        if unknown:
            raise ValueError(f"unknown fault types {unknown}; "
                             f"registered: {sorted(BUILDERS)}")
        if not types or not targets or not vtimes or not counts:
            raise ValueError("every grid axis needs at least one value")
        bad = [c for c in counts if not 1 <= c <= len(targets)]
        if bad:
            raise ValueError(f"counts {bad} outside 1..{len(targets)} "
                             f"(the target axis length)")
        self.types = list(types)
        self.targets = list(targets)
        self.vtimes = [int(v) for v in vtimes]
        self.counts = [int(c) for c in counts]
        self.knobs = dict(knobs or {})

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (len(self.types), len(self.targets), len(self.vtimes),
                len(self.counts))

    @property
    def n_points(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def to_dict(self) -> dict:
        return {"types": list(self.types),
                "targets": [_jsonable(t) for t in self.targets],
                "vtimes": list(self.vtimes),
                "counts": list(self.counts),
                "knobs": _jsonable(self.knobs),
                "shape": list(self.shape),
                "n_points": self.n_points}

    def points(self, host_of: Callable[[Any], int]) -> List[GridPoint]:
        """Materialize every point in axis-product order (stable
        indices)."""
        out = []
        for idx, (ftype, t_i, vtime, count) in enumerate(
                itertools.product(self.types,
                                  range(len(self.targets)),
                                  self.vtimes, self.counts)):
            build = BUILDERS[ftype]
            injs = tuple(
                build(self.targets[(t_i + k) % len(self.targets)],
                      vtime, self.knobs, host_of)
                for k in range(count))
            target = self.targets[t_i]
            name = (f"campaign:{idx}:{ftype}:{target}"
                    f"@{vtime}x{count}")
            out.append(GridPoint(index=idx, type=ftype, target=target,
                                 vtime=vtime, count=count,
                                 scenario=Scenario(name, injs)))
        return out


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------


def functional_fingerprint(report: SimReport) -> dict:
    """The schedule- and engine-independent subset used for the
    divergence check: what happened, not when or how fast.  Every field
    here is in the cross-engine harness's CORE_FIELDS bar, so the same
    point classifies identically under async, dist, or the vectorized
    exact tier."""
    return {"status": report.status,
            "tasks": {n: {"state": t["state"], "host": t["host"]}
                      for n, t in report.tasks.items()},
            "progress": _jsonable(report.progress),
            "messages": report.messages,
            "bytes": report.bytes}


def default_invariants(report: SimReport) -> List[str]:
    """Built-in invariant checks: FAULTY tasks (progress preemption)
    and negative per-link visibility slack (a conservative-lookahead
    breach — by construction impossible unless an engine bug)."""
    out = []
    for name, t in sorted(report.tasks.items()):
        if t["state"] == "faulty":
            out.append(f"task {name} went faulty")
    for link, st in sorted(report.links.items()):
        slack = st.get("min_slack_ns")
        if slack is not None and slack < 0:
            out.append(f"link {link} min_slack_ns={slack} < 0")
    return out


def classify(report: SimReport, baseline: dict,
             invariants: Optional[Callable[[SimReport], List[str]]]
             = None) -> Tuple[str, str]:
    """(outcome, detail) for a completed run.  Severity ladder:
    invariant-violation > deadlock > divergence > ok (crash never
    reaches here — the run raised instead of returning a report)."""
    violations = default_invariants(report)
    if invariants is not None:
        violations += [str(v) for v in invariants(report)]
    if violations:
        return "invariant-violation", "; ".join(violations)
    if report.status == "deadlock":
        return "deadlock", report.detail
    fp = functional_fingerprint(report)
    if fp != baseline:
        diffs = [k for k in fp if fp[k] != baseline[k]]
        return "divergence", f"fingerprint differs on {diffs}"
    return "ok", ""


# ---------------------------------------------------------------------------
# the campaign
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CampaignReport:
    """JSON-able campaign result: grid shape, per-point outcomes (grid
    order), outcome histogram, minimized reproducer specs, and
    throughput.  Everything except ``wall_s``/``points_per_s`` is
    deterministic for a fixed (base, grid, seed)."""
    base: str
    seed: int
    engine: str
    grid: dict
    baseline: dict
    points: List[dict]
    histogram: Dict[str, int]
    reproducers: List[dict]
    wall_s: float
    points_per_s: float
    fast_path: str
    schema: str = REPORT_SCHEMA

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)


class Campaign:
    """Sweep ``grid`` over ``make_sim`` and classify every point.

    ``make_sim(scenario)`` must return a *fresh, unbuilt* Simulation
    wired with the given scenario.  ``engine``:

    * ``"auto"`` — vectorized ``sweep`` in one batched round loop on
      ``device`` (None means ``"cuda"``: the ``minskew`` and
      ``hub_route`` kernels) for the admissible points, per-point async
      for the rest (BitFlip / ClockSkew grids, inadmissible surfaces).
    * ``"async"`` / ``"barrier"`` / ``"single"`` — per-point in-process.
    * ``"dist"`` — per-point over ``n_workers`` OS workers; a
      :class:`~repro_torch.dist.coordinator.DistWorkerError` on one point
      classifies that point as ``crash`` (worker traceback captured)
      and the campaign continues.

    ``invariants`` is an optional hook ``SimReport -> [violation
    strings]`` merged with the default checks.  ``device`` is the
    sweep's only: point runs and minimization trials stay on the
    reference engines, which take no device."""

    def __init__(self, make_sim: Callable[[Scenario], Simulation],
                 grid: FaultGrid, *, seed: int = 0,
                 engine: str = "auto", n_workers: int = 2,
                 invariants: Optional[Callable] = None,
                 base_name: str = "custom",
                 worker_timeout: float = 60.0,
                 max_trials: int = 400,
                 device=None):
        if engine not in ("auto", "single", "async", "barrier", "dist"):
            raise ValueError(f"unknown campaign engine {engine!r}")
        self.make_sim = make_sim
        self.grid = grid
        self.seed = int(seed)
        self.engine = engine
        self.n_workers = n_workers
        self.invariants = invariants
        self.base_name = base_name
        self.worker_timeout = worker_timeout
        self.max_trials = max_trials
        self.device = device
        # resolved lazily by _prepare()
        self._baseline_report: Optional[SimReport] = None
        self._baseline_fp: Optional[dict] = None
        self._placement: Dict[str, int] = {}
        self._n_hosts: int = 0
        self._points: Optional[List[GridPoint]] = None

    # -- setup ---------------------------------------------------------------
    def _prepare(self) -> None:
        if self._points is not None:
            return
        base = self.make_sim(Scenario("baseline"))
        report = self._run_ref(base)
        if report.status != "ok":
            raise ValueError(
                f"campaign baseline must run clean, got "
                f"{report.status!r}: {report.detail}")
        self._baseline_report = report
        self._baseline_fp = functional_fingerprint(report)
        self._n_hosts = base.topology.n_hosts
        self._placement = dict(base.placement)
        self._points = self.grid.points(self._host_of)

    def _host_of(self, target: Any) -> int:
        """Coerce a target-axis value to a host id: ints pass through
        (range-checked at build time by the injection itself), task
        names resolve via the baseline placement."""
        if isinstance(target, bool):
            raise ValueError(f"bad host target {target!r}")
        if isinstance(target, int):
            return target
        if target in self._placement:
            return self._placement[target]
        raise ValueError(
            f"target {target!r} is neither a host id nor a placed "
            f"program; placed: {sorted(self._placement)}")

    def _run_ref(self, sim: Simulation) -> SimReport:
        return _ref_run(sim)

    # -- point execution -----------------------------------------------------
    def _run_point(self, scenario: Scenario) -> Tuple[str, str, str]:
        """(outcome, detail, traceback) for one grid point on the
        campaign engine.  Every exception — a corrupted payload blowing
        up hub routing in-process, a dist worker dying mid-point — is a
        ``crash`` classification, never a campaign abort."""
        try:
            sim = self.make_sim(scenario)
            if self.engine == "dist":
                report = sim.run(engine="dist",
                                 n_workers=self.n_workers,
                                 worker_timeout=self.worker_timeout)
            elif self.engine == "auto":
                report = self._run_ref(sim)
            else:
                report = sim.run(engine=self.engine)
        except Exception as e:              # noqa: BLE001 - classified
            tb = getattr(e, "worker_traceback", "") \
                or _traceback.format_exc()
            return "crash", f"{type(e).__name__}: {e}", tb
        outcome, detail = classify(report, self._baseline_fp,
                                   self.invariants)
        return outcome, detail, ""

    def _sweepable(self, scenario: Scenario) -> bool:
        # JoinHost rides the same fallback path as the data/ingress
        # injections: membership epochs are conservative-engine
        # machinery, so the sweep compiler refuses them at build
        return not any(isinstance(inj, (BitFlip, ClockSkew, JoinHost))
                       for inj in scenario.injections)

    def _try_sweep(self, points: List[GridPoint]
                   ) -> Optional[Dict[int, Tuple[str, str, str]]]:
        """Vectorized fast path: one batched round loop over every
        admissible point, on ``self.device``.  Returns None when the
        surface refuses (fall back to per-point runs); per-lane results
        are exact-tier bit-identical to the reference engines, so
        classification matches.  Only the surface's refusals fall back:
        a missing card (``RuntimeError``), a failed build or launch
        (``RuntimeError``) and a kernel refusing its tensors propagate,
        so the kernels never silently drop out of a campaign."""
        from repro_torch.kernels._build import KernelArgumentError
        from repro_torch.sim.vectorized import (RoundsExhausted,
                                                UnsupportedByEngine)
        try:
            base = self.make_sim(Scenario("sweep-base"))
            res = base.sweep([p.scenario for p in points],
                             device=self.device)
            if res.tier != "exact":
                return None
        except (UnsupportedByEngine, ValueError, RoundsExhausted) as exc:
            # a kernel refusing its tensors is a ValueError too, and a
            # fault of the port, not a refusal of the surface
            if isinstance(exc, KernelArgumentError):
                raise
            return None
        out = {}
        for p, rep in zip(points, res.reports):
            outcome, detail = classify(rep, self._baseline_fp,
                                       self.invariants)
            out[p.index] = (outcome, detail, "")
        return out

    # -- run -----------------------------------------------------------------
    def run(self, *, minimize: bool = True,
            minimize_outcomes: Sequence[str] = (
                "crash", "invariant-violation", "deadlock",
                "divergence")) -> CampaignReport:
        import numpy as np

        self._prepare()
        points = self._points
        t0 = time.perf_counter()
        results: Dict[int, Tuple[str, str, str]] = {}
        fast_path = "per-point"

        order = np.random.default_rng(self.seed).permutation(
            len(points))
        if self.engine == "auto":
            sweepable = [p for p in points
                         if self._sweepable(p.scenario)]
            if sweepable:
                swept = self._try_sweep(sweepable)
                if swept is not None:
                    results.update(swept)
                    fast_path = ("sweep" if len(swept) == len(points)
                                 else "mixed")
        for i in order:
            p = points[int(i)]
            if p.index in results:
                continue
            results[p.index] = self._run_point(p.scenario)

        histogram = {o: 0 for o in OUTCOMES}
        point_rows = []
        for p in points:
            outcome, detail, tb = results[p.index]
            histogram[outcome] += 1
            row = {"index": p.index, "scenario": p.scenario.name,
                   "type": p.type, "target": _jsonable(p.target),
                   "vtime": p.vtime, "count": p.count,
                   "outcome": outcome, "detail": detail}
            if tb:
                row["traceback"] = tb
            point_rows.append(row)

        reproducers = []
        if minimize:
            for p in points:
                outcome = results[p.index][0]
                if outcome in minimize_outcomes and outcome != "ok":
                    reproducers.append(
                        self.minimize_point(p, outcome))
        wall = time.perf_counter() - t0
        return CampaignReport(
            base=self.base_name, seed=self.seed, engine=self.engine,
            grid=self.grid.to_dict(), baseline=self._baseline_fp,
            points=point_rows, histogram=histogram,
            reproducers=reproducers, wall_s=wall,
            points_per_s=(len(points) / wall if wall > 0
                          else float("inf")),
            fast_path=fast_path)

    # -- minimization --------------------------------------------------------
    def _outcome_of(self, injections: Sequence[Injection],
                    counter: List[int]) -> str:
        """One minimization trial, always on the reference engine (the
        spec must not depend on the campaign engine)."""
        if counter[0] >= self.max_trials:
            raise RuntimeError(
                f"minimization exceeded max_trials={self.max_trials}")
        counter[0] += 1
        try:
            sim = self.make_sim(Scenario("min-trial",
                                         tuple(injections)))
            report = self._run_ref(sim)
        except Exception:                   # noqa: BLE001 - classified
            return "crash"
        return classify(report, self._baseline_fp,
                        self.invariants)[0]

    def _shrink_int(self, injs: List[Injection], i: int, field: str,
                    target: str, counter: List[int],
                    floor: int = 0) -> None:
        """Binary-shrink one integer field toward ``floor`` while the
        outcome class is preserved (in place)."""
        cur = getattr(injs[i], field)
        if cur is None or not isinstance(cur, int) or cur <= floor:
            return
        lo, hi = floor, cur
        while lo < hi:
            mid = (lo + hi) // 2
            trial = list(injs)
            trial[i] = dataclasses.replace(injs[i], **{field: mid})
            if self._outcome_of(trial, counter) == target:
                hi = mid
            else:
                lo = mid + 1
        injs[i] = dataclasses.replace(injs[i], **{field: hi})

    def _with_target(self, inj: Injection, raw: Any) -> Injection:
        if isinstance(inj, (Straggler, FailTask, BitFlip)):
            return dataclasses.replace(inj, task=str(raw))
        if isinstance(inj, (FailHost, ClockSkew)):
            return dataclasses.replace(inj, host=self._host_of(raw))
        if isinstance(inj, DegradeLink) and inj.fabric is not None:
            return dataclasses.replace(inj, fabric=str(raw))
        return inj

    def _target_index(self, inj: Injection) -> Optional[int]:
        """Position of this injection's target on the grid's target
        axis (None when it is not on the axis — nothing to shrink)."""
        for j, t in enumerate(self.grid.targets):
            if self._with_target(inj, t) == inj:
                return j
        return None

    def minimize_point(self, point: GridPoint,
                       outcome: Optional[str] = None) -> dict:
        """Delta-minimize one failing grid point to a smallest
        reproducer preserving its outcome class: greedy injection drop
        to a fixpoint, then binary-shrink integer fields toward 0 and
        targets toward the front of the target axis.  Returns the
        ``fault_repro/v1`` spec (see :func:`spec_to_bytes` for the
        byte-stable serialization)."""
        self._prepare()
        if outcome is None:
            outcome = self._run_point(point.scenario)[0]
        if outcome == "ok":
            raise ValueError(
                f"point {point.index} ({point.scenario.name}) is not "
                f"failing; nothing to minimize")
        counter = [0]
        injs = list(point.scenario.injections)
        # confirm the target class reproduces on the reference engine
        # (engine-independent by construction; asserted for safety)
        ref = self._outcome_of(injs, counter)
        if ref != outcome:
            raise RuntimeError(
                f"point {point.index}: outcome {outcome!r} on the "
                f"campaign engine but {ref!r} on {REF_ENGINE} — "
                f"engine-dependent classification is a bug")
        # 1. greedy drop to a fixpoint
        changed = True
        while changed and len(injs) > 1:
            changed = False
            i = 0
            while i < len(injs) and len(injs) > 1:
                trial = injs[:i] + injs[i + 1:]
                if self._outcome_of(trial, counter) == outcome:
                    injs = trial
                    changed = True
                else:
                    i += 1
        # 2. binary-shrink integer fields
        shrink_fields = {
            Straggler: (), FailTask: ("at_vtime", "at_compute"),
            FailHost: ("at_vtime",),
            DegradeLink: ("extra_ns", "from_vtime"),
            BitFlip: ("at_vtime", "at_step", "bit"),
            ClockSkew: ("offset_ns", "drift_ppm"),
            Interference: ("bursts", "burst_ns"),
        }
        for i in range(len(injs)):
            for field in shrink_fields.get(type(injs[i]), ()):
                self._shrink_int(injs, i, field, outcome, counter)
        # 3. binary-shrink targets toward the front of the target axis
        for i in range(len(injs)):
            cur = self._target_index(injs[i])
            if cur is None or cur == 0:
                continue
            lo, hi = 0, cur
            while lo < hi:
                mid = (lo + hi) // 2
                trial = list(injs)
                trial[i] = self._with_target(
                    injs[i], self.grid.targets[mid])
                if self._outcome_of(trial, counter) == outcome:
                    hi = mid
                else:
                    lo = mid + 1
            injs[i] = self._with_target(injs[i],
                                        self.grid.targets[hi])
        return {
            "schema": REPRO_SCHEMA,
            "base": self.base_name,
            "outcome": outcome,
            "point": {"index": point.index, "type": point.type,
                      "target": _jsonable(point.target),
                      "vtime": point.vtime, "count": point.count},
            "injections": [injection_to_dict(inj) for inj in injs],
            "seed": self.seed,
            "trials": counter[0],
        }


def spec_to_bytes(spec: dict) -> bytes:
    """The byte-stable serialization the CI smoke compares: sorted
    keys, fixed indent, trailing newline."""
    return (json.dumps(spec, indent=1, sort_keys=True) + "\n").encode()


def spec_scenario(spec: dict) -> Scenario:
    if spec.get("schema") != REPRO_SCHEMA:
        raise ValueError(f"not a {REPRO_SCHEMA} spec: "
                         f"schema={spec.get('schema')!r}")
    injs = tuple(injection_from_dict(d) for d in spec["injections"])
    return Scenario(f"repro:{spec['base']}:{spec['point']['index']}",
                    injs)


def replay_spec(spec: dict,
                make_sim: Callable[[Scenario], Simulation], *,
                invariants: Optional[Callable] = None
                ) -> Tuple[str, str]:
    """Replay a reproducer spec standalone: run its injections against
    a fresh base, classify against a fresh fault-free baseline, and
    return (outcome, detail).  The outcome must equal
    ``spec["outcome"]`` — asserted by the CLI and tests."""
    fp = functional_fingerprint(_ref_run(make_sim(Scenario("baseline"))))
    try:
        report = _ref_run(make_sim(spec_scenario(spec)))
    except Exception as e:                  # noqa: BLE001 - classified
        return "crash", f"{type(e).__name__}: {e}"
    return classify(report, fp, invariants)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _campaign_for(base_ref: str, *, seed: int, engine: str,
                  n_workers: int, device=None) -> Campaign:
    from repro_torch.sim import registry
    ent = registry.entry(base_ref)
    if ent.grid is None:
        raise SystemExit(
            f"{ent.ref} has no default fault grid; campaign bases: "
            f"{[e for e in registry.names() if registry.entry(e).grid]}")
    return Campaign(ent.make, ent.grid(), seed=seed, engine=engine,
                    n_workers=n_workers, base_name=ent.ref, device=device)


def _cmd_list() -> int:
    from repro_torch.sim import registry
    rows = []
    for ref in registry.names():
        ent = registry.entry(ref)
        kind = "campaign-base" if ent.grid is not None else "scenario"
        rows.append(f"  {ref:24s} [{kind}] {ent.description}")
    print("registered scenarios (load with "
          "repro_torch.sim.registry.load(ref)):")
    print("\n".join(rows))
    return 0


def _cmd_run(args) -> int:
    camp = _campaign_for(args.base, seed=args.seed, engine=args.engine,
                         n_workers=args.n_workers, device=args.device)
    report = camp.run(minimize=not args.no_minimize)
    if args.json:
        with open(args.json, "w") as f:
            f.write(report.to_json() + "\n")
    print(f"campaign {args.base}: {report.grid['n_points']} points "
          f"({report.fast_path}) in {report.wall_s:.2f}s "
          f"({report.points_per_s:.1f} pts/s)")
    print(f"  histogram: {report.histogram}")
    print(f"  reproducers: {len(report.reproducers)}")
    return 0


def _cmd_minimize(args) -> int:
    camp = _campaign_for(args.base, seed=args.seed, engine=args.engine,
                         n_workers=args.n_workers, device=args.device)
    camp._prepare()
    points = {p.index: p for p in camp._points}
    if args.point not in points:
        raise SystemExit(f"point {args.point} outside the grid "
                         f"(0..{len(points) - 1})")
    spec = camp.minimize_point(points[args.point])
    out = spec_to_bytes(spec).decode()
    if args.json:
        with open(args.json, "w") as f:
            f.write(out)
    print(out, end="")
    return 0


def _cmd_smoke(device=None) -> int:
    """The CI gate: a small seeded grid over the serve campaign base
    must (1) produce the pinned outcome histogram, (2) yield
    byte-identical reproducer specs across two independent runs, and
    (3) replay each reproducer standalone to its recorded outcome."""
    from repro_torch.sim import registry
    ent = registry.entry("serve_smoke@v1")
    camp = Campaign(ent.make, ent.grid(), seed=0, base_name=ent.ref,
                    device=device)
    report = camp.run()
    expect = {"ok": 4, "deadlock": 6, "invariant-violation": 0,
              "crash": 4, "divergence": 2}
    assert report.histogram == expect, (
        f"campaign smoke histogram drifted:\n got: {report.histogram}"
        f"\nwant: {expect}")
    assert report.reproducers, "no reproducers from a failing grid"
    rerun = Campaign(ent.make, ent.grid(), seed=0,
                     base_name=ent.ref, device=device).run()
    for a, b in zip(report.reproducers, rerun.reproducers):
        assert spec_to_bytes(a) == spec_to_bytes(b), (
            f"re-running minimization changed the reproducer spec:\n"
            f"{a}\nvs\n{b}")
    for spec in report.reproducers:
        outcome, detail = replay_spec(spec, ent.make)
        assert outcome == spec["outcome"], (
            f"reproducer replays to {outcome!r}, spec says "
            f"{spec['outcome']!r} ({detail})")
    print(f"campaign smoke ok: {report.grid['n_points']} points, "
          f"histogram {report.histogram}, "
          f"{len(report.reproducers)} reproducers byte-stable + "
          f"replayable ({report.points_per_s:.1f} pts/s)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim.campaign",
        description="fault-campaign harness over registered scenario "
                    "bases")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list registered scenarios and "
                               "campaign bases")
    for name in ("run", "minimize"):
        p = sub.add_parser(name)
        p.add_argument("--base", required=True,
                       help="registry ref, e.g. rack_ring@v1")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--engine", default="auto",
                       choices=("auto", "single", "async", "barrier",
                                "dist"))
        p.add_argument("--n-workers", type=int, default=2)
        p.add_argument("--json", help="write the result to this path")
        p.add_argument("--device", default="cuda",
                       help="the sweep fast path's device (cpu or cuda)")
        if name == "run":
            p.add_argument("--no-minimize", action="store_true")
        else:
            p.add_argument("--point", type=int, required=True,
                           help="grid-point index to minimize")
    sp = sub.add_parser("smoke", help="CI gate: pinned histogram + "
                                      "byte-identical minimization")
    sp.add_argument("--device", default="cuda",
                    help="the sweep fast path's device (cpu or cuda)")
    args = ap.parse_args(argv)
    if args.cmd == "list":
        return _cmd_list()
    if args.cmd == "run":
        return _cmd_run(args)
    if args.cmd == "minimize":
        return _cmd_minimize(args)
    return _cmd_smoke(args.device)


if __name__ == "__main__":
    raise SystemExit(main())
