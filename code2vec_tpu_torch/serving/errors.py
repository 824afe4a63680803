"""Typed errors of the extractor bridge (the extractor half of
``code2vec_tpu/serving/errors.py``; the engine's errors come with the
serving engine, ROADMAP A7).

They subclass ``ValueError``: the prediction shell treats a
``ValueError`` from extraction as the user's to fix and prompts again
(``serving/predict.py``), and an extractor that is down must take that
path too instead of ending the shell.
"""
from __future__ import annotations


class ExtractorError(ValueError):
    """Base of the extractor bridge's typed failures."""


class ExtractorCrash(ExtractorError):
    """One extractor run failed for a reason of the infrastructure — it
    could not start, exited non-zero or on a signal, or ran past its
    timeout — rather than finding no path in its input. ``ExtractorPool``
    retries it and counts it against its circuit breaker."""


class ExtractorUnavailable(ExtractorError):
    """The circuit breaker is open: recent calls crashed one after another
    past the threshold, so the pool fails fast (no process started, no
    timeout waited) until the cooldown ends and a half-open probe
    succeeds."""
