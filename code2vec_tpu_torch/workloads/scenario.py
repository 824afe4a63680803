"""The scenario registry (the port of ``code2vec_tpu/workloads/
scenario.py``).

A ``Scenario`` names one kind of served traffic: the languages it
carries, the mesh entry point that serves it (``kind``), the output tier
it rides and the arrival rate synthetic builders give it. Profiles label
every record with a scenario name; the replayer routes each record
through the entry point its scenario's ``kind`` selects and aggregates
quality and latency per scenario.

The registry is one name table per process, so a profile recorded in one
process replays in another on names alone; ``register_scenario`` adds a
scenario without touching this module.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

__all__ = ['Scenario', 'UnknownScenario', 'register_scenario',
           'get_scenario', 'scenario_names', 'KINDS']

#: the mesh entry point a scenario's requests ride:
#: - 'predict'   -> ServingMesh.submit(tier=...)
#: - 'neighbors' -> ServingMesh.submit_neighbors(k=...)
#: - 'blend'     -> ServingMesh.submit_blended(weight=..., k=...)
KINDS = ('predict', 'neighbors', 'blend')


class UnknownScenario(KeyError):
    """A profile or a caller named a scenario the registry does not hold
    (typed, so a stale profile is told apart from any KeyError)."""


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named workload (immutable; shared across threads)."""

    name: str
    #: the languages its requests carry ('java', 'csharp')
    languages: Tuple[str, ...] = ('java',)
    #: the mesh entry point (KINDS)
    kind: str = 'predict'
    #: the output tier of 'predict' requests (other kinds ignore it)
    tier: str = 'topk'
    #: neighbors per query of 'neighbors' and 'blend' (None: the config's)
    k: Optional[int] = None
    #: the neighbor share of 'blend' (None: the config's)
    blend_weight: Optional[float] = None
    #: the arrival rate synthetic profile builders use (requests/s)
    rate_rps: float = 20.0
    description: str = ''

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError('Scenario.kind must be one of %s (got %r)'
                             % (KINDS, self.kind))
        if not self.languages:
            raise ValueError('Scenario.languages must be non-empty')


_lock = threading.Lock()
_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(scenario: Scenario,
                      replace: bool = False) -> Scenario:
    """Add a scenario to the registry. Registering an identical
    definition again is a no-op; a different one under a taken name
    raises unless ``replace=True`` (two benchmarks disagreeing on what a
    name means would corrupt every number kept per scenario)."""
    with _lock:
        existing = _REGISTRY.get(scenario.name)
        if existing is not None and existing != scenario and not replace:
            raise ValueError(
                'scenario %r is already registered with a different '
                'definition (pass replace=True to override)'
                % scenario.name)
        _REGISTRY[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    with _lock:
        scenario = _REGISTRY.get(name)
    if scenario is None:
        raise UnknownScenario(
            'unknown scenario %r (registered: %s) — profiles name '
            'scenarios by string; register it before replaying'
            % (name, sorted(_REGISTRY)))
    return scenario


def scenario_names() -> Tuple[str, ...]:
    with _lock:
        return tuple(sorted(_REGISTRY))


# ---- the built-in scenarios ----
#: one language's method naming over the micro-batched predict path
JAVA_NAMING = register_scenario(Scenario(
    'java_naming', languages=('java',), kind='predict', tier='topk',
    description='Java method naming (softmax top-k).'))
CSHARP_NAMING = register_scenario(Scenario(
    'csharp_naming', languages=('csharp',), kind='predict', tier='topk',
    description='C# method naming (softmax top-k).'))
#: the mixed-language softmax-only arm the retrieval blend is compared with
SOFTMAX_NAMING = register_scenario(Scenario(
    'softmax_naming', languages=('java', 'csharp'), kind='predict',
    tier='topk',
    description='Mixed-language naming, softmax head only (the '
                'retrieval A/B baseline).'))
#: retrieval-augmented naming: the softmax distribution blended with the
#: attached index's top-k neighbor labels (mesh.submit_blended)
RETRIEVAL_NAMING = register_scenario(Scenario(
    'retrieval_naming', languages=('java', 'csharp'), kind='blend',
    description='Mixed-language naming with the softmax distribution '
                'blended against attached-index neighbor labels.'))
#: nearest-method search over the index (the code-search entry point)
NEIGHBOR_SEARCH = register_scenario(Scenario(
    'neighbor_search', languages=('java',), kind='neighbors',
    description='Nearest-method search via the vectors tier + '
                'attached index.'))
