"""Serving tier. This slice of the port carries `faults` (seeded fault
injection and the resilience primitives, which the commit log and the front
door use) and `engine` (`RAGEngine`: retrieval -> prompt -> prefill ->
decode); the scheduler and load harness arrive later."""
