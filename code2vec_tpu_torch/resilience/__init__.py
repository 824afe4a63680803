"""Resilience: deterministic fault injection (``faults``)."""
