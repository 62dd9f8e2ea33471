"""Cost-model calibration audit: predicted vs measured, per executed plan.

The planner prices every plan from static log-log curves measured at bench
time (`planner.CostModel`); production traffic drifts. This table closes
the loop the ROADMAP's "learned, self-tuning planner" needs: every
dispatch unit the executor finishes records (engine, arena-N bucket, fused
group count, k) -> (predicted ms from `PhysicalPlan.est_cost_ms`, measured
host launch ms + device sync ms, rows/terms actually scanned), and the
serving scheduler adds per-request end-to-end samples under the same keys.
Recording is ALWAYS-ON (tracer-independent): two dict updates and four
`perf_counter` reads per unit, independent of batch size.

The audit surfaces in three places: a ``calibration:`` line in
`RagDB.explain()`, the ``calibration`` section of
``results/bench_serving.json``, and the predicted-vs-measured scatter +
regret summary in ``tools/trace_report.py``.

Predicted cost is the planner's per-PROGRAM estimate (the representative
plan's `est_cost_ms`): a fused unit's estimate already prices "one scan
replaces G" — comparing it against the unit's measured wall time is the
promise-vs-delivery the regret summary scores. Units carrying no estimate
(no cost model loaded, unpriced engine) are counted but excluded from
ratios.

>>> t = CalibrationTable()
>>> t.record_unit(engine="ref", n_rows=1000, groups=2, k=8, rows=4,
...               predicted_ms=2.0, launch_ms=0.5, sync_ms=2.5,
...               rows_scanned=1000)
>>> t.record_unit(engine="ref", n_rows=1000, groups=2, k=8, rows=4,
...               predicted_ms=2.0, launch_ms=0.5, sync_ms=3.5,
...               rows_scanned=1000)
>>> snap = t.snapshot()
>>> key, = snap["units"]
>>> key
'engine=ref|n=1024|g=2|k=8'
>>> snap["units"][key]["count"], round(snap["units"][key]["ratio"], 2)
(2, 1.75)
>>> t.engines()
['ref']
>>> pow2_bucket(1000), pow2_bucket(1024), pow2_bucket(1)
(1024, 1024, 1)
"""
from __future__ import annotations

from collections import deque


def pow2_bucket(n) -> int:
    """Smallest power of two >= n (the planner's `bucket_rows` twin, kept
    dependency-free here): arena sizes and batch shapes bucket the same
    way so calibration keys line up with compiled-program shapes."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def _key_str(key: tuple) -> str:
    engine, nb, g, k = key
    return f"engine={engine}|n={nb}|g={g}|k={k}"


class CalibrationTable:
    """Bounded-memory aggregate table + a recent-sample reservoir (the
    scatter's raw points). Aggregates are exact sums; the reservoir keeps
    the most recent ``sample_cap`` unit records."""

    def __init__(self, sample_cap: int = 4096):
        # (engine, n_bucket, groups, k) -> aggregate dict
        self.units: dict[tuple, dict] = {}
        # (engine, n_bucket, k) -> end-to-end aggregate (scheduler-fed)
        self.e2e: dict[tuple, dict] = {}
        self.samples: deque = deque(maxlen=int(sample_cap))
        self.recorded = 0

    def record_unit(self, *, engine: str, n_rows: int, groups: int, k: int,
                    rows: int, predicted_ms: float | None, launch_ms: float,
                    sync_ms: float, rows_scanned: int,
                    terms_scanned: int = 0) -> None:
        """One finished dispatch unit: ``rows`` is the real query rows it
        served, ``launch_ms`` the host-side dispatch cost, ``sync_ms`` the
        device_get wait (+ any completeness rescan)."""
        device_ms = float(launch_ms) + float(sync_ms)
        key = (engine, pow2_bucket(n_rows), int(groups), int(k))
        u = self.units.get(key)
        if u is None:
            u = self.units[key] = {
                "count": 0, "rows": 0, "rows_scanned": 0, "terms_scanned": 0,
                "launch_ms": 0.0, "sync_ms": 0.0, "device_ms": 0.0,
                "device_ms_max": 0.0,
                "priced": 0, "predicted_ms": 0.0, "priced_device_ms": 0.0}
        u["count"] += 1
        u["rows"] += int(rows)
        u["rows_scanned"] += int(rows_scanned)
        u["terms_scanned"] += int(terms_scanned)
        u["launch_ms"] += float(launch_ms)
        u["sync_ms"] += float(sync_ms)
        u["device_ms"] += device_ms
        u["device_ms_max"] = max(u["device_ms_max"], device_ms)
        if predicted_ms is not None:
            u["priced"] += 1
            u["predicted_ms"] += float(predicted_ms)
            u["priced_device_ms"] += device_ms
        self.recorded += 1
        self.samples.append(
            (engine, key[1], int(groups), int(k),
             None if predicted_ms is None else float(predicted_ms),
             device_ms))

    def observe_e2e(self, *, engine: str, n_rows: int, k: int,
                    e2e_ms: float) -> None:
        """One served request's arrival->result time (scheduler-fed; the
        device-side unit record cannot see queue wait or pipelining)."""
        key = (engine, pow2_bucket(n_rows), int(k))
        d = self.e2e.get(key)
        if d is None:
            d = self.e2e[key] = {"count": 0, "sum_ms": 0.0, "max_ms": 0.0}
        d["count"] += 1
        d["sum_ms"] += float(e2e_ms)
        d["max_ms"] = max(d["max_ms"], float(e2e_ms))

    # -- views -------------------------------------------------------------
    def engines(self) -> list[str]:
        return sorted({key[0] for key in self.units})

    def per_engine(self) -> dict[str, dict]:
        """Engine-level rollup: measured/predicted ratio over priced units
        (the regret headline), plus coverage counts."""
        out: dict[str, dict] = {}
        for key, u in self.units.items():
            e = out.setdefault(key[0], {
                "buckets": 0, "count": 0, "rows": 0,
                "predicted_ms": 0.0, "priced_device_ms": 0.0,
                "device_ms": 0.0, "priced": 0})
            e["buckets"] += 1
            for f in ("count", "rows", "predicted_ms", "priced_device_ms",
                      "device_ms", "priced"):
                e[f] += u[f]
        for e in out.values():
            e["ratio"] = (e["priced_device_ms"] / e["predicted_ms"]
                          if e["predicted_ms"] > 0 else None)
        return out

    def snapshot(self) -> dict:
        """The ``calibration`` section schema of bench_serving.json."""
        units = {}
        for key in sorted(self.units):
            u = dict(self.units[key])
            u["device_ms_mean"] = u["device_ms"] / max(u["count"], 1)
            u["predicted_ms_mean"] = (u["predicted_ms"] / u["priced"]
                                      if u["priced"] else None)
            u["ratio"] = (u["priced_device_ms"] / u["predicted_ms"]
                          if u["predicted_ms"] > 0 else None)
            units[_key_str(key)] = u
        e2e = {}
        for key in sorted(self.e2e):
            d = dict(self.e2e[key])
            d["mean_ms"] = d["sum_ms"] / max(d["count"], 1)
            engine, nb, k = key
            e2e[f"engine={engine}|n={nb}|k={k}"] = d
        return {"recorded": self.recorded,
                "engines": self.per_engine(),
                "units": units, "e2e": e2e,
                "samples": [list(s) for s in self.samples]}

    def explain_line(self) -> str:
        """One `RagDB.explain()` line: coverage + the headline ratio."""
        if not self.recorded:
            return "no unit samples yet"
        pe = self.per_engine()
        pred = sum(e["predicted_ms"] for e in pe.values())
        meas = sum(e["priced_device_ms"] for e in pe.values())
        ratio = (f", measured/predicted x{meas / pred:.2f}"
                 if pred > 0 else " (no priced units)")
        return (f"{self.recorded} unit samples, {len(self.units)} "
                f"(engine,N,G,k) buckets across {len(pe)} engine(s)"
                f"{ratio}")
