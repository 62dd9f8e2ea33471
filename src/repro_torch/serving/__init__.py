"""Serving tier (port of ``repro.serving``): batched RAG engine + open-loop
load harness.

  engine.py     RAGEngine -- retrieval -> prompt assembly -> prefill -> decode
                (``scheduler=`` routes retrieval through the scheduler)
  scheduler.py  admission-controlled batching scheduler with deadline-aware
                plan degradation, staleness-bounded cache serves, bounded
                launch retry, and a wedged-batch watchdog
  faults.py     deterministic seeded fault injection (FaultPlan) + the
                resilience primitives (retry/hedge/circuit breaker)
  load.py       open-loop load harness (Poisson arrivals, Zipfian mix,
                interleaved writes) and scenario runner
  metrics.py    monotonic-clock histograms + labeled counters; the
                serving snapshot schema
"""
