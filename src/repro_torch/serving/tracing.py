"""Lightweight step tracing: Chrome trace-event JSON for Perfetto.

The engine brackets its phases (``plan`` / ``admit`` / ``dispatch`` /
``sync`` / ``harvest``, nested under a per-iteration ``step`` span) with
``tracer.span(...)`` context managers.  ``ChromeTracer`` records each as a
complete ("X") event — begin timestamp plus duration in microseconds on one
thread track, which Perfetto nests by containment — plus optional instant
("i") and counter ("C") events for pool occupancy tracks.  The output of
``save()``/``to_json()`` is the standard Trace Event Format object
(``{"traceEvents": [...]}``) loadable at https://ui.perfetto.dev.

When tracing is off the engine holds the module-level ``NULL_TRACER``:
``span()`` returns one reusable no-op context manager and the counter/
instant hooks return immediately, so the instrumented hot path costs a
single attribute call per phase — near-zero overhead by construction, no
``if tracing:`` forests at the call sites.

``validate_trace`` is the schema check CI and the tests run against the
emitted JSON: every event must carry the trace-event required fields
(``ph``/``name``/``ts``/``pid``/``tid``, ``dur`` for "X"), which is what
"loads in Perfetto" means mechanically.
"""

from __future__ import annotations

import json
import time
from typing import Optional

_VALID_PHASES = {"X", "B", "E", "i", "I", "C", "M"}


class _Span:
    """One timed section; appends a complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "ChromeTracer", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        tr = self._tracer
        t1 = time.perf_counter()
        ev = {"name": self._name, "ph": "X", "pid": tr.pid, "tid": tr.tid,
              "ts": (self._t0 - tr._epoch) * 1e6,
              "dur": (t1 - self._t0) * 1e6}
        if self._args:
            ev["args"] = self._args
        tr._events.append(ev)


class _NullSpan:
    """Reusable no-op context manager (one shared instance)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL_SPAN = _NullSpan()


class ChromeTracer:
    """Collects Chrome trace events; ``save()`` writes Perfetto-ready JSON."""

    enabled = True

    def __init__(self, path: Optional[str] = None, pid: int = 0, tid: int = 0,
                 process_name: str = "serving-engine"):
        self.path = path
        self.pid = pid
        self.tid = tid
        self._epoch = time.perf_counter()
        self._events: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": process_name}}]

    def span(self, name: str, **args) -> _Span:
        """Context manager timing one section: ``with tracer.span("plan"):``.
        Keyword args land in the event's ``args`` (visible on click in
        Perfetto)."""
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        ev = {"name": name, "ph": "i", "pid": self.pid, "tid": self.tid,
              "ts": (time.perf_counter() - self._epoch) * 1e6, "s": "t"}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, name: str, **values) -> None:
        """Counter track (e.g. pool occupancy over time)."""
        self._events.append({
            "name": name, "ph": "C", "pid": self.pid, "tid": self.tid,
            "ts": (time.perf_counter() - self._epoch) * 1e6, "args": values})

    @property
    def events(self) -> list[dict]:
        return self._events

    def span_counts(self) -> dict[str, int]:
        """How many completed spans were recorded per name (CI asserts the
        plan/dispatch/harvest coverage of every engine iteration on this)."""
        out: dict[str, int] = {}
        for ev in self._events:
            if ev["ph"] == "X":
                out[ev["name"]] = out.get(ev["name"], 0) + 1
        return out

    def to_json(self) -> dict:
        return {"traceEvents": self._events, "displayTimeUnit": "ms"}

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("no trace output path given")
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path


class NullTracer:
    """No-op tracer: one shared null span, empty event list."""

    enabled = False
    events: list = []

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **args) -> None:
        return None

    def counter(self, name: str, **values) -> None:
        return None

    def span_counts(self) -> dict:
        return {}

    def to_json(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def save(self, path: Optional[str] = None) -> str:
        raise ValueError("tracing was not enabled: nothing to save")


NULL_TRACER = NullTracer()


def validate_trace(trace) -> int:
    """Check Trace Event Format conformance; returns the event count.

    Accepts the object form (``{"traceEvents": [...]}``) or a bare event
    list.  Raises ``ValueError`` on the first malformed event — this is the
    machine-checkable version of "the trace loads in Perfetto".
    """
    if isinstance(trace, dict):
        events = trace.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("trace object lacks a traceEvents list")
    elif isinstance(trace, list):
        events = trace
    else:
        raise ValueError(f"not a trace: {type(trace).__name__}")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        ph = ev.get("ph")
        if ph not in _VALID_PHASES:
            raise ValueError(f"event {i} has invalid phase {ph!r}")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"event {i} lacks a name")
        if "pid" not in ev or "tid" not in ev:
            raise ValueError(f"event {i} lacks pid/tid")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"event {i} has invalid ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i} has invalid dur {dur!r}")
    return len(events)


def load_trace(path: str) -> list[dict]:
    """Load + validate a saved trace file; returns its event list."""
    with open(path) as f:
        trace = json.load(f)
    validate_trace(trace)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


__all__ = ["ChromeTracer", "NullTracer", "NULL_TRACER", "validate_trace",
           "load_trace"]
