"""Record/replay cost ledger for live workloads.

The live-execution subsystem (`repro_torch.sim.live`) runs *real* stack
callables — train steps, checkpoint saves/restores, re-mesh rebuilds —
under simulated time.  Virtual time must advance by how long the call
actually took, but measured wall spans are nondeterministic, and the
cross-engine bar (tests/engine_harness.py) demands bit-identical
results.  SimBricks' lesson (PAPERS.md): composed live+modeled
components stay useful only if runs are repeatable.  The ledger
resolves the tension with two modes:

* ``record`` — :meth:`CostLedger.charge` executes the real callable,
  measures its wall span with ``perf_counter_ns``, scales it by the
  clock ``calibration`` (the pvclock analogue: simulated-ns per
  host-ns), clamps to >= 1 ns, and appends ``{label, cost_ns}`` to the
  per-task trace.  One record run per scenario; the trace is saved as
  versioned JSON (``live_trace/v1``).

  **Multi-driver recording** (SplitSim's isolation concern, PAPERS.md):
  one record run may capture several live drivers — e.g. a trainer and
  a serve stack sharing a ledger — because the in-process engines
  dispatch one live call at a time, so per-task wall spans are
  sequential by construction and never bleed into each other.  The
  ledger *enforces* that sequential-recording phase: a ``charge`` that
  starts while another task's span is still being measured (a nested
  charge, or a driver running off-thread) raises
  :class:`LiveTraceError` immediately instead of silently
  double-counting overlapped wall time in two tasks' costs.

  Optional trace-meta keys a recorder may pin for auditability:
  ``meta["fail_probe"]`` (how a derived fail-at vtime was computed:
  probe span, calibration, margin — see
  ``repro_torch.sim.live.FAIL_PROBE_MARGIN_STEPS``) and per-scenario
  parameter blocks (``meta["recovery"]``, ``meta["serve"]``,
  ``meta["colocated"]`` — including the full open-loop arrival
  schedule, so a replay never re-derives it from an RNG stream).
* ``replay`` — ``charge`` does *not* execute the callable.  It pops the
  next recorded entry for the task, verifies the label matches (a
  scenario that diverges from its trace fails fast, naming the task and
  the expected/actual step key), and returns the pinned integer cost.
  Replayed costs flow through cost-derived
  :class:`~repro_torch.core.vtask.LiveCall` actions, which every engine
  executes bit-identically — so a recorded live scenario passes the
  same equivalence bar as a fully modeled one.

Determinism argument: a live body's control-flow decisions (when to
checkpoint, when a failure is detected) depend only on step indices and
task vtimes.  Replay reproduces every vtime from the recorded integer
costs, so it re-derives exactly the decision sequence the record run
took; the label check turns any divergence into an immediate
:class:`LiveTraceMismatch` instead of silent drift.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

TRACE_SCHEMA = "live_trace/v1"


class LiveTraceError(ValueError):
    """A trace file is malformed or has an unknown schema version."""


class LiveTraceMismatch(RuntimeError):
    """Replay diverged from the recorded trace: a task asked for a cost
    the trace does not have (missing task, exhausted entries, or a label
    that does not match the recorded sequence)."""


class CostLedger:
    """Per-(task, step) wall-time ledger; see the module docstring.

    ``meta`` is an opaque dict stored alongside the trace — scenario
    parameters the record run derived (e.g. the fail-at vtime it picked
    from a probe step) that replays must reuse verbatim.
    """

    def __init__(self, mode: str, *, calibration: float = 1.0,
                 tasks: Optional[Dict[str, List[dict]]] = None,
                 meta: Optional[Dict[str, Any]] = None):
        if mode not in ("record", "replay"):
            raise ValueError(f"mode must be 'record' or 'replay', "
                             f"got {mode!r}")
        if calibration <= 0:
            raise ValueError(f"calibration must be > 0, got {calibration}")
        self.mode = mode
        self.calibration = float(calibration)
        self.tasks: Dict[str, List[dict]] = tasks if tasks is not None \
            else {}
        self.meta: Dict[str, Any] = meta if meta is not None else {}
        self._cursor: Dict[str, int] = {}
        # (task, label) currently measuring a wall span, or None —
        # the sequential-recording guard (see module docstring)
        self._measuring: Optional[Tuple[str, str]] = None

    # -- constructors --------------------------------------------------------
    @classmethod
    def record(cls, *, calibration: float = 1.0,
               meta: Optional[Dict[str, Any]] = None) -> "CostLedger":
        return cls("record", calibration=calibration, meta=meta)

    @classmethod
    def replay(cls, trace: Union[str, pathlib.Path, Dict[str, Any]]
               ) -> "CostLedger":
        """Replay ledger from a trace dict or a JSON file path."""
        if isinstance(trace, (str, pathlib.Path)):
            path = pathlib.Path(trace)
            try:
                data = json.loads(path.read_text())
            except FileNotFoundError:
                raise LiveTraceError(f"live trace not found: {path}")
            except json.JSONDecodeError as e:
                raise LiveTraceError(f"live trace {path} is not valid "
                                     f"JSON: {e}")
        else:
            data = trace
        schema = data.get("schema")
        if schema != TRACE_SCHEMA:
            raise LiveTraceError(
                f"unsupported live trace schema {schema!r} "
                f"(this build reads {TRACE_SCHEMA!r})")
        tasks = data.get("tasks")
        if not isinstance(tasks, dict):
            raise LiveTraceError("live trace has no 'tasks' mapping")
        return cls("replay", calibration=float(data.get("calibration",
                                                        1.0)),
                   tasks=tasks, meta=dict(data.get("meta", {})))

    # -- the one verb --------------------------------------------------------
    def charge(self, task: str, label: str,
               fn: Optional[Callable] = None, args: tuple = (),
               kwargs: Optional[dict] = None) -> Tuple[Any, int]:
        """Record mode: run ``fn`` and return ``(result, measured
        cost_ns)``; replay mode: skip ``fn`` and return ``(None, pinned
        cost_ns)`` from the trace, failing fast on any divergence."""
        if self.mode == "record":
            if self._measuring is not None:
                raise LiveTraceError(
                    f"concurrent record: task {task!r} asked to measure "
                    f"{label!r} while task {self._measuring[0]!r} is "
                    f"still measuring {self._measuring[1]!r} — recorded "
                    f"wall spans must not overlap (each would absorb "
                    f"the other's wall time).  Live drivers record in "
                    f"sequential phases: the in-process engines "
                    f"guarantee this by dispatching one live call at a "
                    f"time; do not nest charge() calls or record from "
                    f"threads")
            self._measuring = (task, label)
            try:
                t0 = time.perf_counter_ns()
                result = fn(*args, **(kwargs or {})) if fn is not None \
                    else None
                span = time.perf_counter_ns() - t0
            finally:
                self._measuring = None
            # zero/negative spans (sub-ns callables, clock warp under a
            # virtualized timer) must still advance vtime: a 0-cost live
            # call would let a task spin without progressing, breaking
            # conservative lookahead
            cost = max(1, int(round(span * self.calibration)))
            self.tasks.setdefault(task, []).append(
                {"label": label, "cost_ns": cost})
            return result, cost
        entries = self.tasks.get(task)
        if entries is None:
            raise LiveTraceMismatch(
                f"live trace has no recorded costs for task {task!r} "
                f"(asked for step {label!r}); recorded tasks: "
                f"{sorted(self.tasks)}")
        i = self._cursor.get(task, 0)
        if i >= len(entries):
            raise LiveTraceMismatch(
                f"task {task!r}: trace exhausted after {len(entries)} "
                f"recorded calls but the scenario asked for {label!r} — "
                f"scenario/trace mismatch (re-record the trace)")
        rec = entries[i]
        if rec.get("label") != label:
            raise LiveTraceMismatch(
                f"task {task!r}: replay diverged at call #{i}: "
                f"scenario asked for {label!r} but the trace recorded "
                f"{rec.get('label')!r} — scenario/trace mismatch")
        self._cursor[task] = i + 1
        cost = int(rec["cost_ns"])
        if cost <= 0:
            raise LiveTraceError(
                f"task {task!r}: recorded cost_ns={cost} at {label!r} "
                f"is not positive — corrupt trace")
        return None, cost

    def rewind(self) -> None:
        """Reset the replay cursors to the start of the trace, so a
        replay ledger can drive the same scenario again (a Workload
        instance rebuilt for a second ``Simulation.run()`` calls this
        from its build-time ``reset()``).  Record-mode ledgers have no
        cursor; re-running a record workload is caught by the
        workload's own reset (one record run per ledger)."""
        self._cursor.clear()

    # -- persistence ---------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"schema": TRACE_SCHEMA, "calibration": self.calibration,
                "meta": self.meta, "tasks": self.tasks}

    def save(self, path: Union[str, pathlib.Path]) -> pathlib.Path:
        if self.mode != "record":
            raise LiveTraceError("only a record-mode ledger can be saved")
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=1,
                                   sort_keys=True) + "\n")
        return path
