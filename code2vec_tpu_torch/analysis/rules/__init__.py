"""The port's graftlint rules: importing this package registers every
rule.

One module per rule (``capture.py`` holds the two capture rules); each
registers itself via ``@core.register`` at import time. Adding a rule =
adding a module here + importing it below + a seeded-violation test in
tests/test_torch_analysis.py + its row in README.md's rule table (the
test file asserts the row exists).
"""
from code2vec_tpu_torch.analysis.rules import (  # noqa: F401
    alloc_catalog,
    capture,
    config_knobs,
    fault_points,
    host_sync,
    locks,
    metrics_schema,
    pinned_reuse,
    span_catalog,
)
