"""graftlint for the port: AST-based static enforcement of the port's
invariants — the counterpart of ``code2vec_tpu/analysis/``.

The port's speed and robustness rest on invariants nothing else
enforces: host syncs only where cataloged, no host side effect or sync
inside a captured CUDA graph, graphs captured and kernels built only at
warm-up, pinned buffers rewritten only after their copy is done,
lock-guarded cross-thread state, and catalogs (metrics, spans, fault
points, allocations, knobs) that cannot drift from the code. The
mechanics (walker, suppressions, baseline, engine) are the reference's,
with the same comment syntax and baseline file format; the rules are
written for torch.

Entry points: ``python -m code2vec_tpu_torch.analysis`` (CLI, the flags
of the reference's ``scripts/graftlint.py``), ``analysis.engine.run``
(in-process), ``tests/test_torch_analysis.py``. The pass imports neither
torch nor the modules it scans, only the catalogs its rules read.
"""
from code2vec_tpu_torch.analysis.core import (Finding, Rule,  # noqa: F401
                                              all_rules, get_rules,
                                              register)
from code2vec_tpu_torch.analysis.engine import Report, run  # noqa: F401
