"""Typed errors of the serving layer (``code2vec_tpu/serving/errors.py``
without the mesh's ``ReplicaDead``, ``AdoptionRejected`` and
``WireError``, which come with the mesh, ROADMAP A16).

Every way a serving request can fail without a model answer has a named
type, so callers route on it (shed: retry elsewhere with backoff;
expired: drop, the client already timed out; closed: this engine is
going away) instead of matching message text.

- The engine's errors subclass ``RuntimeError``, as the reference's do.
- The extractor bridge's errors subclass ``ValueError``: the prediction
  shell treats a ``ValueError`` from extraction as the user's to fix
  and prompts again (``serving/predict.py``), and an extractor that is
  down must take that path too instead of ending the shell.
"""
from __future__ import annotations


class ServingError(RuntimeError):
    """Base of the serving engine's typed request failures."""


class EngineClosed(ServingError):
    """The engine is shut down (or closing): the request was rejected at
    submit, or its future was failed by a non-draining ``close()``."""


class EngineOverloaded(ServingError):
    """Admission control shed this request: the bounded queue is full,
    the drain estimate exceeds the request's deadline, or a
    ``reject_all`` fault drill is armed. Nothing was enqueued."""


class DeadlineExceeded(ServingError):
    """The request was admitted but its SLO deadline passed while it
    waited in the queue; it was expired instead of dispatched."""


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
