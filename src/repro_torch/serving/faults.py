"""Deterministic, seeded fault injection + the resilience primitives that
survive it.

Every failure mode the chaos suite exercises is *scheduled*, not random: a
`FaultPlan` derives one counted RNG stream per injection *site* (a dotted
string like ``"warm.error"`` or ``"txn.ingest.commit"``) from ``(seed,
site)``, so whether call #i at a site faults is a pure function of the plan's
seed — re-running the same workload against the same plan replays the exact
same fault schedule. That determinism is what lets the chaos tests assert
bit-identity against a fault-free twin instead of merely "it didn't crash".

Sites injected across the stack (each draws from its own stream):

================  ============================================================
site              where it fires
================  ============================================================
warm.error        SplitStackClient pushdown query/query_hybrid raises
                  WarmTierError before the round trip
warm.stall        same call sites, sleeps ``stall_s`` before answering
split.filter_bug  the legacy non-pushdown filter bug (filter_bug_rate shim)
hot.launch        RagDB.launch raises HotLaunchError before device dispatch
hot.wedge         RagDB.finish stalls ``stall_s`` (wedged in-flight batch)
hot.finish_error  RagDB.finish raises WedgedBatchError
cache.stale       RagDB.launch reads the *newest* cache entry for the plan's
                  snapshot-free key, ignoring commit epochs (a poisoned read
                  the epoch guard must reject)
txn.<op>.<point>  TransactionLog crash points between write steps; op in
                  {ingest, update, delete}, point in {prepare, intent,
                  commit, alloc, ivf, lex} — raises CrashError
================  ============================================================

This module is intentionally dependency-free (numpy + stdlib only) so that
``core.transactions`` and ``core.splitstack`` can import the exception types
and `FaultPlan` without creating an api/serving import cycle.

The second half is the hardening side: `CircuitBreaker` and `WarmGuard`
implement per-call timeouts, bounded retry with exponential backoff + seeded
jitter, hedged probes, and a closed -> open -> half-open breaker that fails
over to hot-only serving instead of wedging. The harness is synchronous and
single-threaded, so "timeout" means the deadline is checked after the call
returns and a late result is *refused* (deadline semantics — the caller never
sees it), and a "hedge" is a counted second attempt issued when the primary
exceeds the hedge threshold; both are driven by an injectable clock/sleep
pair so fake-clock tests stay deterministic and instant.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np


# ---------------------------------------------------------------------------
# Exceptions
# ---------------------------------------------------------------------------

class FaultError(Exception):
    """Base class for every injected fault (never raised by real bugs)."""


class WarmTierError(FaultError):
    """Warm-tier round trip failed (injected at warm.error)."""


class HotLaunchError(FaultError):
    """Hot-tier device launch failed (injected at hot.launch)."""


class WedgedBatchError(FaultError):
    """In-flight batch wedged or errored at finish (hot.finish_error)."""


class CrashError(FaultError):
    """Simulated process crash between two write steps (txn.<op>.<point>).

    The TransactionLog's write-ahead intent journal guarantees that
    ``recover()`` after this lands on a snapshot bit-identical to either the
    pre-write or post-write state — never a torn mix.
    """


# ---------------------------------------------------------------------------
# Fault scheduling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FaultRule:
    """When a site fires, as a function of its per-site call index.

    ``at`` fires deterministically at exactly those call indices; ``rate``
    fires Bernoulli(rate) from the site's seeded stream, gated to the window
    ``[after, until)`` (None = unbounded). ``stall_s`` is the sleep duration
    for stall-type sites. The Bernoulli draw is taken on *every* call whenever
    ``rate > 0`` (even outside the window) so the stream stays aligned to the
    call index and narrowing the window never reshuffles later draws.
    """
    rate: float = 0.0
    at: tuple[int, ...] = ()
    after: int | None = None
    until: int | None = None
    stall_s: float = 0.0


class FaultPlan:
    """A seeded schedule of faults across named injection sites.

    >>> plan = FaultPlan(seed=7, rules={"warm.error": FaultRule(at=(1,))})
    >>> [plan.fires("warm.error") for _ in range(3)]
    [False, True, False]
    >>> plan.counters()["warm.error"]
    (3, 1)

    The same (seed, site, call index) always produces the same decision:

    >>> a = FaultPlan(seed=3, rules={"x": FaultRule(rate=0.5)})
    >>> b = FaultPlan(seed=3, rules={"x": FaultRule(rate=0.5)})
    >>> [a.fires("x") for _ in range(8)] == [b.fires("x") for _ in range(8)]
    True
    """

    def __init__(self, seed: int = 0,
                 rules: dict[str, FaultRule] | None = None, *,
                 sleep=None):
        self.seed = int(seed)
        self.rules: dict[str, FaultRule] = dict(rules or {})
        #: injectable sleep hook — fake-clock tests pass ``clock.advance`` so
        #: stalls advance virtual time instead of blocking the test.
        self.sleep = sleep if sleep is not None else time.sleep
        self.calls: dict[str, int] = {}
        self.fired: dict[str, int] = {}
        self._rngs: dict[str, np.random.Generator] = {}
        #: duck-typed observability hook (anything with ``.fault(site)``;
        #: RagDB.attach_faults points it at the obs.Tracer's active-sink
        #: stack). Kept duck-typed so this module stays dependency-free.
        self.obs = None

    def _rng(self, site: str) -> np.random.Generator:
        g = self._rngs.get(site)
        if g is None:
            h = hashlib.blake2b(f"{self.seed}:{site}".encode(),
                                digest_size=8).digest()
            g = np.random.default_rng(int.from_bytes(h, "little"))
            self._rngs[site] = g
        return g

    def fires(self, site: str) -> bool:
        """Advance the site's call counter and decide whether this call
        faults. Pure in (seed, site, call index)."""
        idx = self.calls.get(site, 0)
        self.calls[site] = idx + 1
        rule = self.rules.get(site)
        if rule is None:
            return False
        fire = idx in rule.at
        if rule.rate > 0.0:
            draw = bool(self._rng(site).random() < rule.rate)
            in_window = ((rule.after is None or idx >= rule.after)
                         and (rule.until is None or idx < rule.until))
            fire = fire or (draw and in_window)
        if fire:
            self.fired[site] = self.fired.get(site, 0) + 1
            if self.obs is not None:
                # the request(s) being traced right now carry the fault
                self.obs.fault(site)
        return fire

    def raise_if(self, site: str, exc: type = FaultError) -> None:
        """Raise ``exc(site)`` if the site fires on this call."""
        if self.fires(site):
            raise exc(site)

    def stall(self, site: str) -> float:
        """Sleep the site's ``stall_s`` if it fires; returns seconds slept."""
        rule = self.rules.get(site)
        if self.fires(site) and rule is not None and rule.stall_s > 0.0:
            self.sleep(rule.stall_s)
            return rule.stall_s
        return 0.0

    def crashes(self, op: str, point: str) -> None:
        """Crash-point hook for TransactionLog: raises CrashError if the
        site ``txn.<op>.<point>`` fires."""
        self.raise_if(f"txn.{op}.{point}", CrashError)

    def clear(self) -> None:
        """Stop all faults (rules dropped; counters and streams kept)."""
        self.rules.clear()

    def total_fired(self) -> int:
        return sum(self.fired.values())

    def counters(self) -> dict[str, tuple[int, int]]:
        """Per-site ``(calls, fired)`` audit dump."""
        return {s: (n, self.fired.get(s, 0))
                for s, n in sorted(self.calls.items())}

    @classmethod
    def storm(cls, seed: int = 0, *, warm_error: float = 0.05,
              warm_stall: float = 0.03, stall_s: float = 0.002,
              hot_launch: float = 0.02, finish_error: float = 0.01,
              cache_stale: float = 0.2, sleep=None) -> "FaultPlan":
        """The standard query-path fault storm used by chaos tests and
        ``bench_serving --chaos`` (txn crash points are injected separately
        by the crash-recovery grid, which needs per-point control)."""
        rules = {
            "warm.error": FaultRule(rate=warm_error),
            "warm.stall": FaultRule(rate=warm_stall, stall_s=stall_s),
            "hot.launch": FaultRule(rate=hot_launch),
            "hot.finish_error": FaultRule(rate=finish_error),
            "cache.stale": FaultRule(rate=cache_stale),
        }
        return cls(seed, {k: v for k, v in rules.items()
                          if v.rate > 0.0}, sleep=sleep)


# ---------------------------------------------------------------------------
# Resilience: breaker + guarded warm probes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResilienceConfig:
    """Knobs for WarmGuard (mirrored by SchedulerConfig's warm_* fields)."""
    timeout_ms: float | None = None   # refuse results slower than this
    hedge_ms: float | None = None     # issue a counted second attempt past this
    max_retries: int = 2              # attempts = max_retries + 1
    retry_base_ms: float = 1.0        # backoff = base * 2^attempt * jitter
    retry_jitter: float = 0.5         # jitter factor in [1, 1 + retry_jitter]
    breaker_failures: int = 3         # consecutive failures before tripping
    breaker_reset_s: float = 1.0      # open -> half-open probe delay


class CircuitBreaker:
    """closed -> open (after N consecutive failures) -> half-open (after
    reset_s) -> closed (on a successful probe) / open (on a failed one).

    While open, ``allow()`` is False and the caller skips the protected call
    entirely — for warm probes that means hot-only serving with an explicit
    degraded annotation instead of burning retries against a dead tier.
    """

    def __init__(self, failures: int, reset_s: float, *, clock,
                 on_transition=None):
        self.failures = max(1, int(failures))
        self.reset_s = float(reset_s)
        self.clock = clock
        self.on_transition = on_transition
        self.state = "closed"
        self.consecutive = 0
        self.opened_at = 0.0

    def _to(self, state: str) -> None:
        if state != self.state:
            self.state = state
            if self.on_transition is not None:
                self.on_transition(state)

    def allow(self) -> bool:
        if self.state == "open":
            if self.clock() - self.opened_at >= self.reset_s:
                self._to("half-open")   # one probe gets through
                return True
            return False
        return True

    def record_success(self) -> None:
        self.consecutive = 0
        self._to("closed")

    def record_failure(self) -> None:
        self.consecutive += 1
        if self.state == "half-open" or self.consecutive >= self.failures:
            self.opened_at = self.clock()
            self._to("open")


class WarmGuard:
    """Wraps a warm-tier probe with timeout / retry / hedge / breaker.

    ``call(fn)`` returns ``fn()``'s result, or None when the probe should be
    abandoned (breaker open, or retries exhausted) — the executor then serves
    that group hot-only and RagDB.finish stamps the explicit
    ``warm-unavailable`` degradation. Every decision is counted in the
    metrics registry: warm_errors, warm_timeouts, warm_retries, hedges,
    hedge_wins, warm_failovers, breaker_skips, breaker_{open,half-open,closed}.
    """

    def __init__(self, cfg: ResilienceConfig, *, clock, sleep, metrics,
                 seed: int = 0):
        self.cfg = cfg
        self.clock = clock
        self.sleep = sleep
        self.metrics = metrics
        self._rng = np.random.default_rng(int(seed))
        #: duck-typed obs.Tracer (RagDB.attach_tracer / Scheduler wire it):
        #: retry/hedge/breaker decisions annotate the active warm_probe span
        self.tracer = None
        self.breaker = CircuitBreaker(
            cfg.breaker_failures, cfg.breaker_reset_s, clock=clock,
            on_transition=lambda s: metrics.inc(f"breaker_{s}"))

    def _ann(self, key: str, value) -> None:
        if self.tracer is not None:
            self.tracer.annotate_active(key, value)

    @property
    def state(self) -> str:
        return self.breaker.state

    def _backoff(self, attempt: int) -> None:
        base = self.cfg.retry_base_ms * (2.0 ** attempt)
        jitter = 1.0 + self.cfg.retry_jitter * float(self._rng.random())
        self.sleep(base * jitter / 1e3)

    def call(self, fn):
        m = self.metrics
        if not self.breaker.allow():
            m.inc("breaker_skips")
            m.inc("warm_failovers")
            self._ann("breaker", "open")
            self._ann("failover", "breaker-skip")
            return None
        errors = timeouts = 0
        hedged = hedge_won = False
        attempts = self.cfg.max_retries + 1
        for attempt in range(attempts):
            t0 = self.clock()
            try:
                res = fn()
            except FaultError:
                m.inc("warm_errors")
                errors += 1
                self.breaker.record_failure()
                if self.breaker.state == "open":
                    break                      # tripped: stop burning retries
                if attempt < attempts - 1:
                    m.inc("warm_retries")
                    self._backoff(attempt)
                continue
            elapsed_ms = (self.clock() - t0) * 1e3
            to = self.cfg.timeout_ms
            if to is not None and elapsed_ms > to:
                # Synchronous harness: cancellation is impossible, so the
                # deadline is checked after the fact and the late result is
                # refused — the caller never observes it.
                m.inc("warm_timeouts")
                timeouts += 1
                self.breaker.record_failure()
                if self.breaker.state == "open":
                    break
                if attempt < attempts - 1:
                    m.inc("warm_retries")
                    self._backoff(attempt)
                continue
            hg = self.cfg.hedge_ms
            if hg is not None and elapsed_ms > hg:
                # Hedged probe: a second attempt "launched" at the hedge
                # threshold; keep whichever would have finished first.
                m.inc("hedges")
                hedged = True
                t1 = self.clock()
                try:
                    res2 = fn()
                    if hg + (self.clock() - t1) * 1e3 < elapsed_ms:
                        m.inc("hedge_wins")
                        hedge_won = True
                        res = res2
                except FaultError:
                    pass                        # hedge lost; primary stands
            self.breaker.record_success()
            if errors or timeouts or hedged:
                self._ann("attempts", attempt + 1)
                if errors:
                    self._ann("warm_errors", errors)
                if timeouts:
                    self._ann("warm_timeouts", timeouts)
                if hedged:
                    self._ann("hedged", True)
                if hedge_won:
                    self._ann("hedge_win", True)
            return res
        m.inc("warm_failovers")
        self._ann("failover", "breaker-tripped"
                  if self.breaker.state == "open" else "retries-exhausted")
        if errors:
            self._ann("warm_errors", errors)
        if timeouts:
            self._ann("warm_timeouts", timeouts)
        self._ann("breaker", self.breaker.state)
        return None
