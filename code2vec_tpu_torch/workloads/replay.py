"""Paced open-loop traffic replay against a ``ServingMesh`` (the port of
``code2vec_tpu/workloads/replay.py``).

``plan_replay`` turns a profile into a deterministic admission plan: the
same records, seed and rate scale give the same admitted requests in the
same order (``admitted_fingerprint`` hashes the plan, and equals the
reference's on the same records). ``replay`` drives the mesh open loop
(submission times come from the plan, never from completions: a slow
fleet gets more concurrent load, as in production), routes each record
through its scenario's entry point (submit, submit_neighbors,
submit_blended), joins completions back to scenario labels, and
aggregates per scenario and language:

- quality: exact match and subtoken F1 against the recorded labels
  (``metrics.py``);
- traffic: delivered, shed and error counts, p50 and p99 latency from
  each request's submit to its future's completion (the reference reads
  the clock when its join loop reaches the future, which adds the wait
  behind earlier futures and, paced, the rest of the submission);
- the memo hit rate per scenario (the scenario-labeled ``memo/*``
  counters, read before and after);
- the SLO error budget's burn per scenario (``serving/slo.py``'s
  scenario tallies through ``mesh.stats()``);
- the open loop's timeline, which the reference's report lacks: the rate
  offered over the submission window, the rate delivered inside it, the
  backlog (sent, not yet answered) at its middle and its end, and the
  drain after it. A fleet that keeps up holds the backlog flat and
  drains at once; one that does not grows it through the window.
"""
from __future__ import annotations

import hashlib
import json
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from code2vec_tpu_torch.metrics import SubtokensEvaluationMetric
from code2vec_tpu_torch.telemetry import catalog
from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.workloads.scenario import Scenario, get_scenario

__all__ = ['plan_replay', 'admitted_fingerprint', 'replay']

#: the subtoken metric's OOV word: replay scores decoded word strings, so
#: only the literal matters
_OOV = '<OOV>'

#: the memo counters the per-scenario hit rate is read from (their
#: scenario-labeled instances)
_MEMO_COUNTERS = ('memo/hits_total', 'memo/misses_total')


def plan_replay(records: Sequence[dict], rate_scale: float = 1.0,
                seed: int = 0, limit: Optional[int] = None
                ) -> List[Tuple[float, dict]]:
    """The admission plan: ``[(t_submit, record), ...]``.

    Records are ordered by (t, position in the profile), so ties keep the
    profile's order, and paced at ``t / rate_scale``. ``limit`` samples
    with the seeded rng, the seed's only use: with no limit the plan
    does not depend on the seed."""
    if rate_scale <= 0:
        raise ValueError('rate_scale must be > 0 (got %r)' % rate_scale)
    indexed = sorted(enumerate(records),
                     key=lambda pair: (pair[1].get('t', 0.0), pair[0]))
    if limit is not None and limit < len(indexed):
        rng = random.Random(seed)
        keep = sorted(rng.sample(range(len(indexed)), limit))
        indexed = [indexed[i] for i in keep]
    return [(float(record.get('t', 0.0)) / rate_scale, dict(record))
            for _idx, record in indexed]


def admitted_fingerprint(plan: Sequence[Tuple[float, dict]]) -> str:
    """The sha256 of the admitted requests, in order: a replay is
    deterministic when its fingerprint is."""
    digest = hashlib.sha256()
    for t_submit, record in plan:
        digest.update(('%.9f' % t_submit).encode())
        digest.update(json.dumps(record, sort_keys=True).encode())
    return digest.hexdigest()


def _scenario_counters() -> Dict[str, int]:
    """Every scenario-labeled memo counter (name -> value) in the
    process's registry; empty with telemetry off."""
    if not tele_core.enabled():
        return {}
    out = {}
    for name, value in tele_core.registry().snapshot().items():
        if catalog.base_name(name) in _MEMO_COUNTERS \
                and name != catalog.base_name(name):
            out[name] = int(value)
    return out


def _top_words(results) -> List[str]:
    """The ranked words of one completed request (its first row: a
    profile record is one method)."""
    if not results:
        return []
    row = results[0]
    words = getattr(row, 'predicted_words', None)  # BlendResult
    if words is not None:
        return list(words)
    words = getattr(row, 'topk_predicted_words', None)  # predict rows
    if words is not None:
        return list(words)
    labels = getattr(row, 'labels', None)  # NeighborResult
    if labels is not None:
        return [str(label) for label in labels]
    return []


class _Arm:
    """One (scenario, language) cell of the report."""

    def __init__(self):
        self.requests = 0
        self.delivered = 0
        self.shed = 0
        self.errors = 0
        self.scored = 0
        self.exact = 0
        self.latencies_ms: List[float] = []
        self.subtokens = SubtokensEvaluationMetric(_OOV)

    def report(self) -> dict:
        lat = np.asarray(sorted(self.latencies_ms), dtype=np.float64)

        def pct(q):
            if lat.size == 0:
                return 0.0
            return float(lat[min(lat.size - 1, max(0, int(q * lat.size)))])
        return {
            'requests': self.requests,
            'delivered': self.delivered,
            'shed': self.shed,
            'errors': self.errors,
            'scored': self.scored,
            'exact_match': (self.exact / self.scored
                            if self.scored else 0.0),
            'f1': self.subtokens.f1,
            'precision': self.subtokens.precision,
            'recall': self.subtokens.recall,
            'p50_ms': round(pct(0.50), 3),
            'p99_ms': round(pct(0.99), 3),
        }


def _done_time(done_at: List[float]) -> float:
    """When a joined future completed: its callback's clock, or now (a
    waiter can return before the future runs its callbacks)."""
    return done_at[0] if done_at else time.perf_counter()


def _timeline(plan, sent: List[float], finished: List[Tuple[float, bool]],
              t_start: float, t_end: float) -> dict:
    """The open loop's offer against the fleet's answers, on the
    submission window [t_start, t_end]: the requests sent over it
    (offered), those delivered inside it, the backlog (sent and not yet
    answered, shed or failed) at its middle and at its end, and the
    seconds from its end to the last answer (the drain). A request that
    never finished (a join timeout) stays in the backlog."""
    window = t_end - t_start

    def backlog(at: float) -> int:
        return (sum(1 for t in sent if t <= at)
                - sum(1 for t, _ok in finished if t <= at))
    in_window = sum(1 for t, ok in finished if ok and t <= t_end)
    return {
        'planned_s': plan[-1][0] if plan else 0.0,
        'window_s': window,
        'sent': len(sent),
        'offered_rps': len(sent) / window if window > 0 else 0.0,
        'delivered_in_window': in_window,
        'delivered_rps': in_window / window if window > 0 else 0.0,
        'backlog_mid': backlog(t_start + window / 2),
        'backlog_end': backlog(t_end),
        'drain_s': max(0.0, max((t for t, _ok in finished),
                                default=t_end) - t_end),
    }


def _submit_one(mesh, scenario: Scenario, record: dict):
    """Route one record through its scenario's entry point."""
    kwargs = {'scenario': scenario.name,
              'language': record.get('language')}
    if scenario.kind == 'neighbors':
        payload = record.get('lines')
        if payload is None:
            payload = np.asarray(record['vector'], dtype=np.float32)
        return mesh.submit_neighbors(
            payload, k=record.get('k', scenario.k), **kwargs)
    if scenario.kind == 'blend':
        weight = record.get('weight')
        if weight is None:
            weight = scenario.blend_weight
        return mesh.submit_blended(
            record['lines'], weight=weight,
            k=record.get('k', scenario.k), **kwargs)
    return mesh.submit(record['lines'],
                       tier=record.get('tier', scenario.tier), **kwargs)


def replay(mesh, records: Sequence[dict], rate_scale: float = 1.0,
           seed: int = 0, limit: Optional[int] = None,
           pace: bool = True, timeout_s: float = 60.0) -> dict:
    """Replay a profile against a live mesh: the report per scenario and
    language.

    ``pace=False`` submits as fast as it can (pacing changes the wall
    time, not the admitted set). Sheds (``EngineOverloaded``) are an
    expected open-loop outcome and are counted, not raised."""
    from code2vec_tpu_torch.serving.errors import EngineOverloaded
    plan = plan_replay(records, rate_scale=rate_scale, seed=seed,
                       limit=limit)
    fingerprint = admitted_fingerprint(plan)
    memo_before = _scenario_counters()
    arms: Dict[Tuple[str, str], _Arm] = {}
    inflight: List[tuple] = []
    t_start = time.perf_counter()
    for t_submit, record in plan:
        scenario = get_scenario(record['scenario'])
        language = record.get('language') or '-'
        arm = arms.setdefault((scenario.name, language), _Arm())
        arm.requests += 1
        if pace:
            delay = t_submit - (time.perf_counter() - t_start)
            if delay > 0:
                time.sleep(delay)
        t0 = time.perf_counter()
        try:
            future = _submit_one(mesh, scenario, record)
        except EngineOverloaded:
            arm.shed += 1
            continue
        except Exception:
            arm.errors += 1
            continue
        done_at: List[float] = []
        future.add_done_callback(
            lambda _f, into=done_at: into.append(time.perf_counter()))
        inflight.append((arm, record, t0, done_at, future))
        if tele_core.enabled():
            tele_core.registry().counter('workloads/replayed_total').inc()
    t_end = time.perf_counter()
    finished: List[Tuple[float, bool]] = []   # (t_done, delivered)
    deadline = time.monotonic() + timeout_s
    for arm, record, t0, done_at, future in inflight:
        try:
            results = future.result(
                timeout=max(0.1, deadline - time.monotonic()))
        except EngineOverloaded:
            arm.shed += 1
            finished.append((_done_time(done_at), False))
            continue
        except Exception:
            arm.errors += 1
            if future.done():
                finished.append((_done_time(done_at), False))
            continue
        arm.delivered += 1
        t_done = _done_time(done_at)
        finished.append((t_done, True))
        arm.latencies_ms.append((t_done - t0) * 1e3)
        label = record.get('label')
        if label:
            words = _top_words(results)
            arm.scored += 1
            if words and words[0] == label:
                arm.exact += 1
            arm.subtokens.update_batch([(label, words)])
    memo_after = _scenario_counters()
    report: dict = {'fingerprint': fingerprint, 'admitted': len(plan),
                    'rate_scale': rate_scale, 'seed': seed,
                    'scenarios': {},
                    'timeline': _timeline(
                        plan, [t0 for _a, _r, t0, _d, _f in inflight],
                        finished, t_start, t_end)}
    for (name, language), arm in sorted(arms.items()):
        cell = arm.report()
        hits_key = catalog.labeled('memo/hits_total', 'scenario', name)
        misses_key = catalog.labeled('memo/misses_total', 'scenario', name)
        hits = memo_after.get(hits_key, 0) - memo_before.get(hits_key, 0)
        misses = (memo_after.get(misses_key, 0)
                  - memo_before.get(misses_key, 0))
        cell['memo_hit_rate'] = (hits / (hits + misses)
                                 if hits + misses else 0.0)
        report['scenarios'].setdefault(name, {})[language] = cell
    slo = mesh.stats().get('slo')
    if slo is not None:
        report['slo'] = {
            'good_total': slo.get('good_total'),
            'bad_total': slo.get('bad_total'),
            'slow_total': slo.get('slow_total'),
            'alerting': slo.get('alerting'),
            # the error budget's burn per scenario
            'scenarios': slo.get('scenarios', {}),
        }
        for key in ('availability_burn_fast', 'availability_burn_slow',
                    'p99_burn_fast', 'p99_burn_slow'):
            if key in slo:
                report['slo'][key] = slo[key]
    return report
