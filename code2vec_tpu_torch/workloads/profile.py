"""Durable traffic profiles: record, read, write, synthesize (the port of
``code2vec_tpu/workloads/profile.py``; files written by either package
read in the other).

A profile is JSONL: one header line (``{"workload_profile": 1, ...}``),
then one record per request:

- ``t``: the time since the profile's first request, in seconds (the
  replayer paces from it, at any rate scale);
- ``scenario``: the registry name the request belongs to;
- ``language``: 'java', 'csharp', or absent when unknown;
- ``lines``: the request's canonical context lines, or ``vector``: a raw
  code vector (a neighbor query submitted as an array records its query
  vector);
- ``label``: the true method name ('get|square') when known: the
  replayer scores exact match and subtoken F1 against it;
- ``k``, ``weight``, ``tier``: the entry point's arguments, when it
  takes them.

``ProfileRecorder`` is the mesh's admission tap
(``ServingMesh.record_traffic``): thread-safe, bounded, and cheap enough
to leave on; it stores strings and floats, never tensors.
``build_synthetic_profile`` drives the repo's corpus generators
(``scripts/gen_java_corpus.py``, ``gen_csharp_corpus.py``) through the
path-context extractor into a mixed Java and C# stream with seeded
exponential arrivals.
"""
from __future__ import annotations

import importlib.util
import json
import os
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from code2vec_tpu_torch.telemetry import core as tele_core
from code2vec_tpu_torch.telemetry.core import Counter

__all__ = ['PROFILE_VERSION', 'ProfileError', 'ProfileRecorder',
           'read_profile', 'write_profile', 'build_synthetic_profile']

PROFILE_VERSION = 1

#: the record keys the reader accepts: any other is a format error (a
#: profile is a durable artifact, so drift fails loud)
_RECORD_KEYS = frozenset(
    ('t', 'scenario', 'language', 'lines', 'vector', 'label', 'k',
     'weight', 'tier'))


class ProfileError(ValueError):
    """A traffic profile that does not parse as PROFILE_VERSION."""


def _validate_record(record: dict, where: str) -> dict:
    if not isinstance(record, dict):
        raise ProfileError('%s: record is not an object' % where)
    unknown = set(record) - _RECORD_KEYS
    if unknown:
        raise ProfileError('%s: unknown record keys %s'
                           % (where, sorted(unknown)))
    if not isinstance(record.get('scenario'), str):
        raise ProfileError('%s: record needs a scenario name' % where)
    if not isinstance(record.get('t'), (int, float)) or record['t'] < 0:
        raise ProfileError('%s: record needs a relative timestamp '
                           't >= 0' % where)
    has_lines = isinstance(record.get('lines'), list)
    has_vector = isinstance(record.get('vector'), list)
    if not (has_lines or has_vector):
        raise ProfileError("%s: record needs 'lines' (context lines) "
                           "or 'vector' (code-vector ref)" % where)
    return record


def write_profile(path: str, records: Sequence[dict],
                  meta: Optional[dict] = None) -> None:
    """Write a profile atomically (a temporary file, then a rename): a
    replayer racing a recorder's save never reads a torn profile."""
    header = {'workload_profile': PROFILE_VERSION,
              'records': len(records)}
    if meta:
        header.update(meta)
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        f.write(json.dumps(header) + '\n')
        for i, record in enumerate(records):
            _validate_record(record, 'record %d' % i)
            f.write(json.dumps(record, sort_keys=True) + '\n')
    os.replace(tmp, path)


def read_profile(path: str) -> Tuple[dict, List[dict]]:
    """(header, records); ``ProfileError`` on a file that is not a
    profile or holds a malformed record."""
    with open(path) as f:
        first = f.readline()
        try:
            header = json.loads(first)
        except ValueError:
            raise ProfileError('%s: header is not JSON' % path)
        if not isinstance(header, dict) \
                or header.get('workload_profile') != PROFILE_VERSION:
            raise ProfileError('%s: not a workload_profile v%d header'
                               % (path, PROFILE_VERSION))
        records = []
        for lineno, raw in enumerate(f, start=2):
            raw = raw.strip()
            if not raw:
                continue
            try:
                record = json.loads(raw)
            except ValueError:
                raise ProfileError('%s:%d: record is not JSON'
                                   % (path, lineno))
            records.append(_validate_record(record,
                                            '%s:%d' % (path, lineno)))
    return header, records


class ProfileRecorder:
    """The mesh's admission traffic tap (``ServingMesh.record_traffic``).

    Times are relative to the first recorded request. Bounded: past
    ``max_records`` new traffic is counted in ``dropped`` instead of
    growing without limit (recording is observability, not a durability
    contract)."""

    # submit runs on the callers' threads: _records, _t0 and dropped are
    # guarded by _lock
    # graftlint: guard ProfileRecorder._records,_t0,dropped by _lock
    def __init__(self, max_records: int = 100_000):
        self.max_records = max(1, int(max_records))
        self._lock = threading.Lock()
        self._records: List[dict] = []
        self._t0: Optional[float] = None
        self.dropped = 0
        self.recorded_total = Counter('workloads/recorded_total')

    def record(self, scenario: str, language: Optional[str] = None,
               lines: Optional[Sequence[str]] = None,
               vector=None, label: Optional[str] = None,
               tier: Optional[str] = None, k: Optional[int] = None,
               weight: Optional[float] = None) -> None:
        now = time.monotonic()
        record: dict = {'scenario': str(scenario)}
        if lines is not None:
            record['lines'] = [str(line) for line in lines]
        if vector is not None:
            # an array or a sequence -> plain floats (JSON-durable)
            record['vector'] = [float(v) for v in
                                getattr(vector, 'ravel', lambda: vector)()]
        if language is not None:
            record['language'] = str(language)
        if label is not None:
            record['label'] = str(label)
        if tier is not None:
            record['tier'] = str(tier)
        if k is not None:
            record['k'] = int(k)
        if weight is not None:
            record['weight'] = float(weight)
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            record['t'] = now - self._t0
            if len(self._records) >= self.max_records:
                self.dropped += 1
                return
            self._records.append(record)
        self.recorded_total.inc()
        if tele_core.enabled():
            tele_core.registry().counter('workloads/recorded_total').inc()

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def records(self) -> List[dict]:
        """A copy (the tap goes on recording)."""
        with self._lock:
            return [dict(record) for record in self._records]

    def save(self, path: str, meta: Optional[dict] = None) -> int:
        records = self.records()
        header_meta = {'source': 'recorded'}
        if meta:
            header_meta.update(meta)
        write_profile(path, records, meta=header_meta)
        return len(records)


# ------------------------------------------------- synthetic builders
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load_script(name: str):
    """Import a script of the repo's ``scripts/`` (not a package) by
    path, as ``scripts/gen_csharp_corpus.py`` loads the Java generator."""
    path = os.path.join(_REPO_ROOT, 'scripts', name + '.py')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _gen_sources(language: str, classes: int, seed: int,
                 out_dir: str, methods_per_class=(2, 3)) -> List[str]:
    """Write ``classes`` synthetic source files of one language; their
    paths (deterministic under the seed)."""
    gjc = _load_script('gen_java_corpus')
    rng = random.Random(seed)
    noun_pairs = ([(a, n) for a in gjc.ADJS for n in gjc.NOUNS]
                  + [(n1, n2) for n1 in gjc.NOUNS for n2 in gjc.NOUNS
                     if n1 != n2])
    rng.shuffle(noun_pairs)
    paths = []
    os.makedirs(out_dir, exist_ok=True)
    for i in range(classes):
        name = 'W%05d' % i
        if language == 'csharp':
            gcs = _load_script('gen_csharp_corpus')
            src = gcs.gen_csharp_class(rng, name, noun_pairs,
                                       methods_per_class)
            path = os.path.join(out_dir, name + '.cs')
        else:
            src = gjc.gen_class(rng, name, noun_pairs, methods_per_class)
            path = os.path.join(out_dir, name + '.java')
        with open(path, 'w') as f:
            f.write(src)
        paths.append(path)
    return paths


def build_synthetic_profile(
        config, workdir: str,
        classes_per_language: int = 3, seed: int = 7,
        rate_rps: float = 50.0,
        scenario_by_language: Optional[Dict[str, str]] = None,
        extractor_command: Optional[List[str]] = None,
        methods_per_class=(2, 3)) -> List[dict]:
    """A mixed Java and C# traffic stream: corpus-generator classes ->
    path-context extraction -> one record per method, interleaved under
    seeded exponential inter-arrivals.

    The same (seed, classes_per_language) give byte-identical records.
    It needs the extractor (``extractor/build/c2v-extract``) and raises
    the extractor's error when it is missing, so a caller sees the gap
    instead of replaying an empty stream."""
    from code2vec_tpu_torch.serving.extractor_bridge import Extractor
    scenario_by_language = dict(scenario_by_language or {
        'java': 'java_naming', 'csharp': 'csharp_naming'})
    extractor = Extractor(config, extractor_command=extractor_command)
    entries: List[dict] = []
    for language in sorted(scenario_by_language):
        paths = _gen_sources(language, classes_per_language, seed,
                             os.path.join(workdir, language),
                             methods_per_class=methods_per_class)
        for path in paths:
            try:
                lines, _hashes = extractor.extract_paths(path)
            except ValueError:
                continue  # a class none of whose members parsed
            for line in lines:
                entries.append({
                    'scenario': scenario_by_language[language],
                    'language': language,
                    'lines': [line],
                    'label': line.split(' ', 1)[0],
                })
    # interleave deterministically, then pace with exponential
    # inter-arrivals: an open-loop Poisson stream at rate_rps
    rng = random.Random(seed)
    rng.shuffle(entries)
    t = 0.0
    for entry in entries:
        entry['t'] = round(t, 6)
        t += rng.expovariate(rate_rps) if rate_rps > 0 else 0.0
    return entries
