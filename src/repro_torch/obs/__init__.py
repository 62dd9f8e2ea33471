"""Observability for the serving stack: per-request span trees, a bounded
flight recorder, and the cost-model calibration audit.

Zero-dependency by design (stdlib only — not even numpy): `api.executor`,
`api.ragdb`, `serving.scheduler`, and `serving.faults` all thread trace
context through their hot paths, so this package must be importable from
every layer without creating a cycle, and the disabled fast path must cost
one attribute check.
"""
from repro_torch.obs.calibration import CalibrationTable, pow2_bucket
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.tracer import (NULL_SPAN, NULL_TRACE, FanSpan, Span, Trace,
                                    TraceGroup, Tracer)

__all__ = [
    "CalibrationTable", "pow2_bucket", "FlightRecorder", "Tracer", "Trace",
    "Span", "FanSpan", "TraceGroup", "NULL_TRACE", "NULL_SPAN",
]
