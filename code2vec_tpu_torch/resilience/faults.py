"""Deterministic fault injection (a copy of
``code2vec_tpu/resilience/faults.py``'s spec grammar and plan).

A plan is armed with a spec of comma-separated ``<point>@<trigger>=<n>``
entries:

    slow_dispatch@req=0..63,reject_all@req=0..1
    nan_loss@step=120,sigterm@step=50
    corrupt_snapshot@save=2

Each fault point is a named site in the code that calls
``maybe_fire(<point>)``; the spec decides when it fires. The trigger
count is the ``step=`` the site passes or, for sites with no natural
step, the number of times the site has been reached. A single ``<n>``
fires once, at the first count ``>= n``; a window ``<lo>..<hi>``
(inclusive) fires at every count inside it and is done past ``hi``. The
trigger's key name (``step``, ``req``, ...) is documentation only.

What happens on fire is implemented at the site: the harness only
decides when. The catalog keeps every point name of the reference, so
one spec arms both packages (FAULT_INJECT, or the FAULT_INJECT
environment variable when the config leaves it unset; ``Trainer`` arms
it). The serving mesh's thread mode reaches ``reject_all`` at its
shared front queue; its worker modes reach ``kill_worker``,
``kill_worker_after_execute``, ``drop_heartbeat``, ``partition`` and
``spawn_fail`` and ``adopt_stall`` at the reference's places, each
counting its own reaches.

Stdlib only and thread-safe.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional

from code2vec_tpu_torch.telemetry import core as tele_core

logger = logging.getLogger(__name__)

#: every fault point a ``maybe_fire`` site may name, and what firing
#: does at its site
FAULT_POINTS: Dict[str, str] = {
    'slow_dispatch': 'serving/engine.py dispatcher: sleep '
                     'SLOW_DISPATCH_SECONDS before dispatching the '
                     'triggering micro-batch (admission control drills: '
                     'queue bound, shedding, deadline expiry).',
    'reject_all': 'serving/engine.py admission, and the serving mesh\'s '
                  'at serving/frontqueue.py FrontQueue.admit: the '
                  'triggering submit calls are shed with EngineOverloaded '
                  'regardless of queue state.',
    'nan_loss': 'training/trainer.py Trainer.fit: poison the triggering '
                "step's loss on the device (loss + nan; the divergence "
                'guard).',
    'sigterm': 'training/trainer.py Trainer.fit: send SIGTERM to this '
               'process once the step counter reaches the trigger '
               '(preemption-safe shutdown).',
    'hang_input': 'data/reader.py batch stream (the reader and the token '
                  'cache): block the input at the triggering batch (the '
                  'hang watchdog).',
    'corrupt_snapshot': 'checkpoints.py: truncate the files of the '
                        'just-written step snapshot (the restore '
                        'fallback).',
    'slow_step': 'training/trainer.py Trainer.fit: sleep '
                 'SLOW_STEP_SECONDS after the triggering train step(s).',
    'extractor_crash': 'serving/extractor_bridge.py pool call: the '
                       'triggering extractor invocation raises '
                       'ExtractorCrash as if the subprocess died (retries '
                       'and the circuit breaker).',
    'kill_worker': 'serving/mesh.py worker serve loop: SIGKILL this '
                   'replica worker process as the triggering dispatch '
                   'arrives, mid-batch, so the parent holds it in flight '
                   '(crash-safe redispatch and supervised restart).',
    'kill_worker_after_execute': 'serving/mesh.py worker serve loop: '
                                 'SIGKILL this replica worker after the '
                                 'triggering dispatch ran on the device '
                                 'but before its result frame: the work '
                                 'was done and lost, and the batch is '
                                 'redispatched.',
    'drop_heartbeat': 'serving/mesh.py worker heartbeat thread: the '
                      'triggering heartbeat(s) are silently skipped, the '
                      'shape of a hung but connected worker (the liveness '
                      'monitor, which the dispatch breaker cannot '
                      'replace).',
    'partition': 'serving/mesh.py parent receiver: the triggering '
                 'frame(s) from the worker are dropped as if the network '
                 'partitioned; results and heartbeats vanish while both '
                 'ends stay up (liveness detection and redispatch of the '
                 'blackholed batch).',
    'spawn_fail': 'serving/mesh.py ServingMesh._spawn_worker: the '
                  'triggering spawn attempt raises before the worker '
                  'process starts, the shape of an exec or resource '
                  'failure on the host (the restart budget\'s '
                  'accounting).',
    'adopt_stall': 'serving/mesh.py worker startup (also reached by '
                   'serving/mesh_worker.py): the triggering worker dials '
                   'in but stalls ADOPT_STALL_SECONDS before its ready '
                   'frame, the shape of a worker wedged in its cold start '
                   '(the adoption timeout drops the dial-in typed instead '
                   'of wedging the adoption loop).',
}

#: how long a fired ``hang_input`` blocks: only a watchdog abort ends the
#: run, and a leaked daemon thread in a test process still unwinds
HANG_SECONDS = 600.0

#: how long a fired ``slow_step`` stalls one step of the training loop
SLOW_STEP_SECONDS = 0.12

#: how long a fired ``adopt_stall`` delays a worker's ready frame: past
#: the adoption wait a drill sets, short enough that the stalled worker
#: unwinds inside a test's budget
ADOPT_STALL_SECONDS = 20.0

#: how long a fired ``slow_dispatch`` stalls the serving dispatcher: long
#: enough that an open-loop burst outruns the queue bound, short enough
#: for a drill inside a test's budget
SLOW_DISPATCH_SECONDS = 0.25


def parse_spec(spec: str) -> Dict[str, object]:
    """``'slow_dispatch@req=0..3,nan_loss@step=7'`` -> {point: trigger},
    a trigger being an ``int`` (single shot) or a ``(lo, hi)`` window.
    Raises ``ValueError`` on an unknown point or a malformed entry."""
    plan: Dict[str, object] = {}
    for entry in (spec or '').split(','):
        entry = entry.strip()
        if not entry:
            continue
        try:
            point, trigger = entry.split('@', 1)
            _key, value = trigger.split('=', 1)
            if '..' in value:
                lo_text, hi_text = value.split('..', 1)
                at: object = (int(lo_text), int(hi_text))
            else:
                at = int(value)
        except ValueError:
            raise ValueError(
                'FAULT_INJECT entry %r is not <point>@<trigger>=<int> or '
                '<point>@<trigger>=<lo>..<hi> (e.g. slow_dispatch@req=0..3)'
                % entry)
        if point not in FAULT_POINTS:
            raise ValueError(
                'FAULT_INJECT names unknown fault point %r; known points: '
                '%s (resilience/faults.py)'
                % (point, ', '.join(sorted(FAULT_POINTS))))
        if isinstance(at, tuple):
            if at[0] < 0 or at[1] < at[0]:
                raise ValueError(
                    'FAULT_INJECT entry %r: fire window must be '
                    '0 <= lo <= hi' % entry)
        elif at < 0:
            raise ValueError(
                'FAULT_INJECT entry %r: trigger count must be >= 0' % entry)
        plan[point] = at
    return plan


class FaultPlan:
    """The armed plan: which points fire, and at which trigger count."""

    # graftlint: guard FaultPlan._at,_site_counts,_fired by _lock
    def __init__(self, plan: Dict[str, object]):
        self._at = dict(plan)
        self._site_counts: Dict[str, int] = {}
        self._fired: set = set()
        self._lock = threading.Lock()

    def maybe_fire(self, point: str, step: Optional[int] = None) -> bool:
        with self._lock:
            at = self._at.get(point)
            if at is None or point in self._fired:
                return False
            if step is None:
                step = self._site_counts.get(point, 0)
                self._site_counts[point] = step + 1
            if isinstance(at, tuple):
                lo, hi = at
                if step > hi:
                    self._fired.add(point)  # window passed: done
                    return False
                if step < lo:
                    return False
            else:
                if step < at:
                    return False
                self._fired.add(point)
        logger.warning('FAULT_INJECT: firing %r at trigger count %d',
                       point, step)
        if tele_core.enabled():
            tele_core.registry().counter('resilience/faults_fired_total').inc()
        return True


# the process-global plan: None keeps every site at one attribute read
_PLAN: Optional[FaultPlan] = None


def configure(spec: str) -> Optional[FaultPlan]:
    """Arm (or clear, for an empty spec) the process-global plan;
    re-configuring resets what has fired."""
    global _PLAN
    plan = parse_spec(spec)
    _PLAN = FaultPlan(plan) if plan else None
    if _PLAN is not None:
        logger.warning('FAULT_INJECT armed: %s',
                       ', '.join('%s@%d..%d' % (p, n[0], n[1])
                                 if isinstance(n, tuple) else
                                 '%s@%d' % (p, n)
                                 for p, n in sorted(plan.items())))
    return _PLAN


def maybe_fire(point: str, step: Optional[int] = None) -> bool:
    """True when the armed plan says fault ``point`` fires now; the
    caller implements the fault."""
    if _PLAN is None:
        return False
    assert point in FAULT_POINTS, point
    return _PLAN.maybe_fire(point, step)


def active() -> bool:
    return _PLAN is not None


def corrupt_directory(path: str) -> None:
    """Truncate every regular file under ``path`` to one NUL byte: what a
    full disk or a writer killed mid-write leaves (the ``corrupt_snapshot``
    site in checkpoints.py)."""
    for dirpath, _dirs, files in os.walk(path):
        for name in files:
            try:
                with open(os.path.join(dirpath, name), 'wb') as f:
                    f.write(b'\0')
            except OSError:
                pass
    logger.warning('FAULT_INJECT: corrupted artifact directory `%s`', path)
