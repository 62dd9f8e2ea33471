"""Serving tier. This slice of the port carries `faults` (seeded fault
injection and the resilience primitives), which the commit log and the
front door use; the scheduler, load harness and engine arrive later."""
