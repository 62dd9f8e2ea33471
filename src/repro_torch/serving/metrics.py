"""Serving observability: monotonic-clock histograms + labeled counters.

The serving loop measures four stages per request — queue wait (arrival ->
service start), plan (lower + compile + degrade), device (launch -> sync),
and end-to-end — each on `time.perf_counter`-style monotonic clocks, never
wall time. Percentiles are exact (sorted-sample interpolation over every
observation), because serving benchmarks here run 1e3–1e5 requests and the
whole point is the tail: a p999 from a lossy sketch would defeat the audit.

`MetricsRegistry` is the one aggregation point: the scheduler and the load
harness both write into it, and `snapshot()` is the schema that
`benchmarks/bench_serving.py` dumps into `results/bench_serving.json`
(documented in docs/api.md). Histograms and counters both take labels, so
per-engine and per-tenant breakdowns (the head-vs-tail tenant p99 report)
share one primitive; unlabeled series keep their bare name in the snapshot.
"""
from __future__ import annotations

import numpy as np

#: The percentile set every histogram reports. p999 is the acceptance
#: criterion's tail; p50 anchors the "p99 blows past 10x p50" overload test.
PERCENTILES = (50.0, 95.0, 99.0, 99.9)

#: Explicit percentile -> snapshot-key map. Every consumer (regression
#: gates, bench reports, docs/api.md) reads these exact keys, so the label
#: is part of the schema — never derived by string munging.
PERCENTILE_LABELS = {50.0: "p50", 95.0: "p95", 99.0: "p99", 99.9: "p999"}


def percentile_label(p) -> str:
    """Stable snapshot key for a percentile value.

    Replaces a derivation that re-built the key by stripping characters
    from ``str(p)`` — fragile because it silently mangled labels for inputs
    it was never tested on: ``str(50).rstrip('0')`` is ``"5"``, so merely
    rewriting `PERCENTILES` with ints would have relabeled p50 as p5 and
    every gate reading ``snapshot()["p50"]`` would KeyError (or compare
    against a default and pass vacuously).

    >>> [percentile_label(p) for p in PERCENTILES]
    ['p50', 'p95', 'p99', 'p999']
    >>> percentile_label(50) == percentile_label(50.0) == 'p50'
    True
    >>> percentile_label(99.95)    # outside the map: exact digits, no dot
    'p9995'
    >>> percentile_label(10.0)
    'p10'
    """
    key = PERCENTILE_LABELS.get(float(p))
    if key is not None:
        return key
    return "p" + f"{float(p):g}".replace(".", "")


class Histogram:
    """Append-only latency histogram (values in ms, monotonic-clock deltas).

    >>> h = Histogram()
    >>> for v in range(1, 101):
    ...     h.observe(float(v))
    >>> s = h.snapshot()
    >>> s["count"], s["p50"], s["max"]
    (100, 50.5, 100.0)
    >>> Histogram().snapshot()["count"]
    0
    """

    __slots__ = ("_values",)

    def __init__(self):
        self._values: list[float] = []

    def observe(self, value_ms: float) -> None:
        self._values.append(float(value_ms))

    def __len__(self) -> int:
        return len(self._values)

    def values(self) -> np.ndarray:
        return np.asarray(self._values, np.float64)

    def snapshot(self) -> dict:
        """count/mean/max plus p50/p95/p99/p999 (linear interpolation)."""
        if not self._values:
            return {"count": 0}
        v = np.sort(self.values())
        out = {"count": int(v.size),
               "mean": float(v.mean()),
               "max": float(v[-1])}
        pcts = np.percentile(v, PERCENTILES)
        for p, x in zip(PERCENTILES, pcts):
            out[percentile_label(p)] = float(x)
        return out


def _flat_key(name: str, labels: tuple) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={val}" for k, val in labels) + "}"


class MetricsRegistry:
    """Named histograms + labeled counters with one `snapshot()` dump.

    Both primitives are keyed (name, sorted label items), so per-engine and
    per-tenant breakdowns need no side tables; unlabeled series flatten to
    their bare name, labeled ones to ``name{k=v,...}``:

    >>> m = MetricsRegistry()
    >>> m.inc("requests", engine="ivf"); m.inc("requests", engine="ivf")
    >>> m.inc("requests", engine="ref")
    >>> m.hist("e2e_ms").observe(1.5)
    >>> m.hist("e2e_ms", tenant=3).observe(9.0)
    >>> snap = m.snapshot()
    >>> snap["counters"]["requests{engine=ivf}"]
    2
    >>> snap["histograms"]["e2e_ms"]["count"]
    1
    >>> snap["histograms"]["e2e_ms{tenant=3}"]["count"]
    1
    >>> m.hist_labels("e2e_ms")
    [(), (('tenant', 3),)]
    """

    def __init__(self):
        self._hists: dict[tuple, Histogram] = {}
        self._counters: dict[tuple, int] = {}

    def hist(self, name: str, **labels) -> Histogram:
        key = (name, tuple(sorted(labels.items())))
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram()
        return h

    def hist_labels(self, name: str) -> list[tuple]:
        """Every label combination a histogram name was observed under
        (sorted; ``()`` is the unlabeled series)."""
        return sorted(lbl for (n, lbl) in self._hists if n == name)

    def inc(self, name: str, by: int = 1, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        self._counters[key] = self._counters.get(key, 0) + by

    def counter(self, name: str, **labels) -> int:
        return self._counters.get((name, tuple(sorted(labels.items()))), 0)

    def counter_total(self, name: str) -> int:
        """Sum of a counter across all label combinations."""
        return sum(v for (n, _), v in self._counters.items() if n == name)

    def snapshot(self) -> dict:
        """The bench_serving.json per-scenario schema: every histogram's
        percentile summary + every counter, both flattened to
        `name{k=v,...}` (bare name when unlabeled)."""
        counters = {}
        for (name, labels), v in sorted(self._counters.items()):
            counters[_flat_key(name, labels)] = v
        return {"histograms": {_flat_key(n, lbl): h.snapshot()
                               for (n, lbl), h in sorted(self._hists.items())},
                "counters": counters}
