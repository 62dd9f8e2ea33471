"""Per-request span trees on `perf_counter` clocks.

One `Trace` is one request's life: a root ``request`` span plus children
for every stage the serving stack walks — queue wait, plan/degrade, the
cache lookup, the hot launch, the device sync (with any ivf completeness
rescan as *its* child), the warm probe (annotated with WarmGuard
retry/hedge/breaker decisions), the tier merge, and the finish. The async
three-phase dispatch (executor.launch_plans / finish_plans) means these
stages do NOT share a call stack: span handles are *carried* — on
`ServeRequest`, `PendingExecution`, and `InFlightPlans` — across the
launch/finish boundary, which is why spans here are explicit begin/end
records in a flat parent-linked list, not context managers.

Batched execution shares device work across requests: one dispatch unit's
launch serves every member request. `FanSpan` records one measured
(t0, t1) interval into *each* member request's trace, so per-request trees
stay complete while the measurement happens exactly once.

Span ids are deterministic — sequential ints in creation order within a
trace, with trace ids sequential per tracer — so two runs of the same
workload produce the same tree identifiers (the flight-recorder diffing
contract).

Disabled tracing is a no-op fast path: `Tracer(enabled=False).trace()`
returns the shared `NULL_TRACE` singleton whose methods do nothing, and
the instrumented call sites guard their span construction on
``tracer.enabled`` — the serving path's cost when off is one attribute
check per site (gated at <= 5% p50 overhead when ON by
``check_bench_regression.py --obs-only``).

Doctest (the span-tree contract in miniature):

>>> tr = Tracer(enabled=True)
>>> t = tr.trace("request", req_id=7)
>>> q = t.begin("queue")
>>> t.end(q, wait_ms=1.5)
>>> _ = t.add("cache_lookup", t0=0.1, t1=0.2, outcome="miss")
>>> t.finish()
>>> [s.name for s in t.spans]
['request', 'queue', 'cache_lookup']
>>> [s.parent_id for s in t.spans]
[-1, 0, 0]
>>> tr.trace("request") is not t      # fresh trace, fresh deterministic id
True
>>> off = Tracer(enabled=False)
>>> off.trace("request") is NULL_TRACE
True
"""
from __future__ import annotations

import time


def _jsonable(v):
    """Annotation values as JSON-serializable primitives (tuples of rung
    strings, numpy scalars, etc. arrive from the serving stack)."""
    if isinstance(v, (str, bool, type(None))):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:
        f = float(v)
    except (TypeError, ValueError):
        return repr(v)
    return int(f) if f.is_integer() and abs(f) < 2**53 else f


class Span:
    """One timed stage. ``t1 is None`` while open; times are raw
    `perf_counter` seconds (exports normalize to a common base)."""

    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "ann")

    def __init__(self, name: str, span_id: int, parent_id: int, t0: float,
                 ann: dict | None = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: float | None = None
        self.ann: dict = dict(ann) if ann else {}

    def annotate(self, key: str, value) -> None:
        self.ann[key] = value

    def fault(self, site: str) -> None:
        self.ann.setdefault("faults", []).append(site)

    @property
    def dur_ms(self) -> float | None:
        return None if self.t1 is None else (self.t1 - self.t0) * 1e3

    def to_dict(self) -> dict:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "t0": self.t0, "t1": self.t1,
                "dur_ms": self.dur_ms,
                "ann": {k: _jsonable(v) for k, v in self.ann.items()}}


class Trace:
    """One request's span tree: a flat parent-linked span list plus an
    open-span stack for call-stack-scoped stages. Pin reasons accumulate
    (``slo`` | ``degraded`` | ``fault`` | ``failed``) and decide flight-
    recorder retention."""

    enabled = True
    __slots__ = ("trace_id", "spans", "pins", "_open", "_clock", "_recorder",
                 "finished")

    def __init__(self, clock, recorder, trace_id: str, name: str = "request",
                 ann: dict | None = None):
        self._clock = clock
        self._recorder = recorder
        self.trace_id = trace_id
        root = Span(name, 0, -1, clock(), ann)
        self.spans: list[Span] = [root]
        self._open: list[int] = [0]
        self.pins: list[str] = []
        self.finished = False

    # -- span construction -------------------------------------------------
    def begin(self, name: str, t0: float | None = None, **ann) -> int:
        """Open a child of the current open span; returns its span id (the
        handle carried across launch/finish boundaries)."""
        sid = len(self.spans)
        parent = self._open[-1] if self._open else 0
        self.spans.append(Span(name, sid, parent,
                               self._clock() if t0 is None else t0, ann))
        self._open.append(sid)
        return sid

    def _begin_at(self, name: str, t0: float, ann: dict | None) -> int:
        """Hot-path `begin`: pre-read clock, annotations as a plain dict
        (no kwargs packing). `FanSpan` calls this once per member trace —
        the per-span cost here is what the <=5% tracer-tax gate buys."""
        spans = self.spans
        sid = len(spans)
        o = self._open
        spans.append(Span(name, sid, o[-1] if o else 0, t0, ann))
        o.append(sid)
        return sid

    def end(self, span_id: int, t1: float | None = None, **ann) -> None:
        sp = self.spans[span_id]
        if sp.t1 is None:
            sp.t1 = self._clock() if t1 is None else t1
        if ann:
            sp.ann.update(ann)
        if self._open and self._open[-1] == span_id:
            self._open.pop()
        elif span_id in self._open:
            self._open.remove(span_id)

    def _end_at(self, span_id: int, t1: float, ann: dict | None) -> None:
        """Hot-path `end` (the `FanSpan` member loop): shared clock reading
        and a shared annotation dict, no kwargs packing."""
        sp = self.spans[span_id]
        if sp.t1 is None:
            sp.t1 = t1
        if ann:
            sp.ann.update(ann)
        o = self._open
        if o and o[-1] == span_id:
            o.pop()
        elif span_id in o:
            o.remove(span_id)

    def end_current(self, t1: float | None = None, **ann) -> None:
        """End the deepest open non-root span (the re-queue path re-opens
        ``queue`` spans whose ids the scheduler doesn't carry)."""
        if len(self._open) > 1:
            self.end(self._open[-1], t1=t1, **ann)

    def add(self, name: str, t0: float, t1: float, **ann) -> int:
        """Record an already-measured, closed span under the current open
        span (the batch-shared stages fan in through here)."""
        sid = len(self.spans)
        parent = self._open[-1] if self._open else 0
        sp = Span(name, sid, parent, t0, ann)
        sp.t1 = t1
        self.spans.append(sp)
        return sid

    # -- annotations / pinning --------------------------------------------
    def annotate(self, key: str, value) -> None:
        """Annotate the ROOT span (request-level facts: served, e2e, …)."""
        self.spans[0].ann[key] = value

    def annotate_current(self, key: str, value) -> None:
        self.spans[self._open[-1] if self._open else 0].ann[key] = value

    def fault(self, site: str) -> None:
        """An injected fault fired while this trace was active: annotate
        the deepest open span and pin the trace."""
        self.spans[self._open[-1] if self._open else 0].fault(site)
        self.pin("fault")

    def pin(self, reason: str) -> None:
        if reason not in self.pins:
            self.pins.append(reason)

    # -- lifecycle ---------------------------------------------------------
    def finish(self, t1: float | None = None, **ann) -> None:
        """Close every open span (root last), stamp final annotations, and
        deliver to the flight recorder. Idempotent."""
        if self.finished:
            return
        end = self._clock() if t1 is None else t1
        spans, o = self.spans, self._open
        while o:
            sp = spans[o.pop()]
            if sp.t1 is None:
                sp.t1 = end
        if ann:
            spans[0].ann.update(ann)
        self.finished = True
        if self._recorder is not None:
            self._recorder.record(self)

    @property
    def root(self) -> Span:
        return self.spans[0]

    @property
    def duration_ms(self) -> float | None:
        return self.root.dur_ms

    def children(self, span_id: int) -> list[Span]:
        return [s for s in self.spans if s.parent_id == span_id]

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "pins": list(self.pins),
                "duration_ms": self.duration_ms,
                "spans": [s.to_dict() for s in self.spans]}


class _NullTrace:
    """Shared no-op trace: every disabled-path span call lands here."""

    enabled = False
    trace_id = ""
    finished = True

    @property
    def pins(self):
        return ()

    @property
    def spans(self):
        return ()

    def begin(self, name, t0=None, **ann):
        return 0

    def end(self, span_id, t1=None, **ann):
        pass

    def end_current(self, t1=None, **ann):
        pass

    def add(self, name, t0, t1, **ann):
        return 0

    def annotate(self, key, value):
        pass

    def annotate_current(self, key, value):
        pass

    def fault(self, site):
        pass

    def pin(self, reason):
        pass

    def finish(self, t1=None, **ann):
        pass


class _NullSpan:
    """Shared no-op fan-span (disabled path of `Tracer.fan`)."""

    def annotate(self, key, value):
        pass

    def fault(self, site):
        pass

    def end(self, t1=None, **ann):
        return 0.0


NULL_TRACE = _NullTrace()
NULL_SPAN = _NullSpan()


class FanSpan:
    """One measured operation recorded into several request traces at once
    (a dispatch unit's launch/sync serves every member request). Begins on
    construction; `end()` closes the span in every member trace with ONE
    shared clock reading, so the interval is identical across trees."""

    __slots__ = ("_pairs", "t0", "_clock")

    def __init__(self, traces, name: str, clock=time.perf_counter, **ann):
        self._clock = clock
        self.t0 = t0 = clock()
        seen: set[int] = set()
        pairs: list[tuple] = []
        shared = ann or None
        for t in traces:
            if t is None or not t.enabled or id(t) in seen:
                continue
            seen.add(id(t))
            pairs.append((t, t._begin_at(name, t0, shared)))
        self._pairs = pairs

    def annotate(self, key: str, value) -> None:
        for t, sid in self._pairs:
            t.spans[sid].ann[key] = value

    def fault(self, site: str) -> None:
        for t, sid in self._pairs:
            t.spans[sid].fault(site)
            t.pin("fault")

    def end(self, t1: float | None = None, **ann) -> float:
        """Close in every member trace; returns the duration in ms."""
        t1 = self._clock() if t1 is None else t1
        shared = ann or None
        for t, sid in self._pairs:
            t._end_at(sid, t1, shared)
        return (t1 - self.t0) * 1e3


class TraceGroup:
    """Annotation fan-out (no span of its own): the active sink RagDB
    pushes around a whole batch's launch/finish so faults firing at batch
    scope (hot.launch, hot.wedge, hot.finish_error) land in EVERY member
    request's trace."""

    __slots__ = ("_traces",)

    def __init__(self, traces):
        seen: set[int] = set()
        self._traces = []
        for t in traces:
            if t is None or not t.enabled or id(t) in seen:
                continue
            seen.add(id(t))
            self._traces.append(t)

    def annotate(self, key: str, value) -> None:
        for t in self._traces:
            t.annotate_current(key, value)

    def fault(self, site: str) -> None:
        for t in self._traces:
            t.fault(site)


class Tracer:
    """Trace factory + the active-sink stack fault sites annotate through.

    The active stack makes "annotate whatever is being traced right now"
    possible from modules that cannot hold trace handles (`serving.faults`
    is dependency-free and fires deep inside the warm client): RagDB and
    the executor push the relevant sink (a `TraceGroup` around a batch, a
    `FanSpan` around a warm probe) and `FaultPlan.fires` / `WarmGuard`
    call `fault` / `annotate_active` on whatever is on top.
    """

    def __init__(self, enabled: bool = True, recorder=None,
                 clock=time.perf_counter):
        self.enabled = bool(enabled)
        self.recorder = recorder
        self.clock = clock
        self._seq = 0
        self._active: list = []

    @property
    def traces_started(self) -> int:
        return self._seq

    def trace(self, name: str = "request", **ann):
        """A fresh trace (deterministic sequential id), or `NULL_TRACE`
        when disabled — the only allocation the disabled path skips."""
        if not self.enabled:
            return NULL_TRACE
        self._seq += 1
        return Trace(self.clock, self.recorder, f"t{self._seq:06d}",
                     name, ann)

    def fan(self, traces, name: str, **ann):
        if not self.enabled:
            return NULL_SPAN
        return FanSpan(traces, name, clock=self.clock, **ann)

    # -- active-sink stack (fault / guard annotation) ----------------------
    def push(self, sink) -> None:
        if self.enabled:
            self._active.append(sink)

    def pop(self) -> None:
        if self._active:
            self._active.pop()

    def fault(self, site: str) -> None:
        if self._active:
            self._active[-1].fault(site)

    def annotate_active(self, key: str, value) -> None:
        if self._active:
            self._active[-1].annotate(key, value)
