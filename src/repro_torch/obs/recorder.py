"""Flight recorder: a bounded ring of completed traces + pinned tails.

The ring (`cap` most recent traces) answers "what did the last N requests
look like"; the pin list answers "what went wrong" — any trace finishing
with a non-empty pin set (``slo`` past-deadline, ``degraded`` ladder
rungs or warm failover, ``fault`` injected-fault annotation, ``failed``
explicit shed) is retained up to `pin_cap` even after the ring rolls past
it. Both bounds are hard: memory is O(cap + pin_cap) traces regardless of
how long the server runs (`pin_drops` counts pinned traces refused at the
bound — the gate in ``check_bench_regression.py --obs-only`` asserts both
invariants on a live run).

Exports: `to_dict()`/`dump()` is the JSON schema `tools/trace_report.py`
reads; `trace_events()`/`dump_perfetto()` is the Chrome/Perfetto
``trace_event`` timeline format (one pseudo-thread per trace, ``ph: "X"``
complete events, microsecond timestamps normalized to the earliest span).

>>> from repro_torch.obs.tracer import Tracer
>>> rec = FlightRecorder(cap=2, pin_cap=1)
>>> tr = Tracer(enabled=True, recorder=rec)
>>> for i in range(3):
...     t = tr.trace("request", req_id=i)
...     if i == 0:
...         t.pin("failed")
...     t.finish()
>>> len(rec.ring), [t.root.ann["req_id"] for t in rec.ring]
(2, [1, 2])
>>> [t.root.ann["req_id"] for t in rec.pinned]    # survived the ring roll
[0]
>>> sorted(e["ph"] for e in rec.trace_events())[:2]
['M', 'M']
"""
from __future__ import annotations

import json
from collections import deque

SCHEMA = "repro.obs.flight_recorder/v1"


class FlightRecorder:

    def __init__(self, cap: int = 256, pin_cap: int = 128):
        self.cap = int(cap)
        self.pin_cap = int(pin_cap)
        self.ring: deque = deque(maxlen=self.cap)
        self.pinned: list = []
        self.pin_drops = 0
        self.recorded = 0

    def __len__(self) -> int:
        return len(self.ring)

    def record(self, trace) -> None:
        """Called by `Trace.finish`. Pinning is automatic: the trace pinned
        itself when it saw a fault/degradation/SLO-miss/failure."""
        self.recorded += 1
        self.ring.append(trace)
        if trace.pins:
            if len(self.pinned) < self.pin_cap:
                self.pinned.append(trace)
            else:
                self.pin_drops += 1

    def traces(self) -> list:
        """Every retained trace, pinned first, deduplicated by trace id
        (a pinned trace still inside the ring appears once)."""
        seen: set[str] = set()
        out = []
        for t in list(self.pinned) + list(self.ring):
            if t.trace_id in seen:
                continue
            seen.add(t.trace_id)
            out.append(t)
        return out

    def find(self, **root_ann) -> list:
        """Retained traces whose ROOT annotations match every given
        key=value (the chaos audit looks requests up by req_id)."""
        return [t for t in self.traces()
                if all(t.root.ann.get(k) == v for k, v in root_ann.items())]

    # -- JSON dump (the trace_report.py input schema) ----------------------
    def to_dict(self, calibration=None) -> dict:
        return {"schema": SCHEMA,
                "cap": self.cap, "pin_cap": self.pin_cap,
                "recorded": self.recorded, "pin_drops": self.pin_drops,
                "pinned": [t.trace_id for t in self.pinned],
                "traces": [t.to_dict() for t in self.traces()],
                "calibration": calibration}

    def dump(self, path: str, calibration=None) -> dict:
        d = self.to_dict(calibration=calibration)
        with open(path, "w") as f:
            json.dump(d, f, indent=1)
        return d

    # -- Chrome/Perfetto trace_event export --------------------------------
    def trace_events(self) -> list[dict]:
        """``trace_event`` list: per-trace thread-name metadata (``ph: M``)
        plus one complete event (``ph: X``) per closed span, timestamps in
        microseconds from the earliest recorded span."""
        traces = self.traces()
        t_base = min((s.t0 for t in traces for s in t.spans),
                     default=0.0)
        events: list[dict] = []
        for tid, t in enumerate(traces):
            label = t.trace_id
            req_id = t.root.ann.get("req_id")
            if req_id is not None:
                label += f" req={req_id}"
            if t.pins:
                label += " [" + ",".join(t.pins) + "]"
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tid, "args": {"name": label}})
            for s in t.spans:
                if s.t1 is None:
                    continue
                d = s.to_dict()
                events.append({
                    "name": s.name, "cat": "serve", "ph": "X",
                    "ts": (s.t0 - t_base) * 1e6,
                    "dur": (s.t1 - s.t0) * 1e6,
                    "pid": 1, "tid": tid,
                    "args": {"span_id": s.span_id,
                             "parent_id": s.parent_id, **d["ann"]}})
        return events

    def to_perfetto(self) -> dict:
        return {"traceEvents": self.trace_events(),
                "displayTimeUnit": "ms"}

    def dump_perfetto(self, path: str) -> dict:
        d = self.to_perfetto()
        with open(path, "w") as f:
            json.dump(d, f, indent=1)
        return d
