"""The scenario traffic plane (the port of ``code2vec_tpu/workloads/``).

The serving stack answers one request at a time; this package holds the
workloads: named scenarios (``scenario.py``), durable recorded traffic
(``profile.py``) and the paced open-loop replayer that drives a
``ServingMesh`` with a mixed stream and joins its completions back to
scenario labels (``replay.py``). ``blend.py`` is the retrieval-augmented
naming math behind the mesh's ``submit_blended``.

Import discipline: ``serving/mesh.py`` imports this package (for the
blend math), so nothing here imports the serving package at module
scope; ``profile.py`` and ``replay.py`` import it inside functions.
"""
from code2vec_tpu_torch.workloads.scenario import (  # noqa: F401
    Scenario, UnknownScenario, get_scenario, register_scenario,
    scenario_names)
