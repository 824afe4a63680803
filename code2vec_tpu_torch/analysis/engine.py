"""graftlint engine for the port: walk once, run rules, apply
suppressions and the baseline, report — the port's copy of
``code2vec_tpu/analysis/engine.py`` over the port's tree and rules.

The pipeline::

    SourceTree (one parse)  ->  rule.run(tree) per rule
        ->  inline suppressions (suppress.py; reasons mandatory)
        ->  baseline (baseline.py; reasons mandatory, stale = finding)
        ->  Report{findings, suppressed, baselined}

``Report.findings`` non-empty = exit 1 for ``python -m
code2vec_tpu_torch.analysis`` and a failed test
(tests/test_torch_analysis.py) — the port must be clean of unbaselined,
unsuppressed findings at all times.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

from code2vec_tpu_torch.analysis import baseline as baseline_lib
from code2vec_tpu_torch.analysis import suppress
from code2vec_tpu_torch.analysis.core import Finding, get_rules
from code2vec_tpu_torch.analysis.walker import SourceTree


class Report:
    def __init__(self, findings: List[Finding],
                 suppressed: List[Finding],
                 baselined: List[Finding],
                 rules_run: List[str],
                 files_scanned: int,
                 elapsed_s: float):
        self.findings = findings
        self.suppressed = suppressed
        self.baselined = baselined
        self.rules_run = rules_run
        self.files_scanned = files_scanned
        self.elapsed_s = elapsed_s

    @property
    def clean(self) -> bool:
        return not self.findings

    def summary(self) -> str:
        return ('graftlint: %d finding(s), %d suppressed, %d baselined '
                '(%d rules over %d files in %.1fs)'
                % (len(self.findings), len(self.suppressed),
                   len(self.baselined), len(self.rules_run),
                   self.files_scanned, self.elapsed_s))


def repo_root() -> str:
    """The repository root (two levels above this package)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def run(root: Optional[str] = None,
        rule_names: Optional[Sequence[str]] = None,
        baseline_path: Optional[str] = None,
        tree: Optional[SourceTree] = None) -> Report:
    """Run the named rules (None = all registered) over ``root``.

    ``baseline_path`` default: ``<root>/code2vec_tpu_torch/analysis/
    graftlint_baseline.json`` when it exists; pass '' to force no
    baseline (the per-rule unit tests).
    """
    from code2vec_tpu_torch.analysis import rules as _rules  # noqa: F401
    t0 = time.perf_counter()
    root = root if root is not None else repo_root()
    if tree is None:
        tree = SourceTree(root)
    rules = get_rules(rule_names)

    raw: List[Finding] = []
    for rule in rules:
        raw.extend(rule.run(tree))
    # parse failures surface through whichever rule set runs
    for source in tree.files('all'):
        if source.parse_error is not None:
            raw.append(Finding(
                suppress.META_RULE, source.rel,
                source.parse_error.lineno or 0,
                'file does not parse: %s' % source.parse_error.msg))

    # inline suppressions (and their own problems)
    sup_by_file: Dict[str, suppress.Suppressions] = {}
    for source in tree.files('all'):
        parsed = suppress.parse_file(source)
        sup_by_file[source.rel] = parsed
        raw.extend(parsed.problems)
    kept, suppressed = suppress.apply(raw, sup_by_file)
    # a suppression that silenced nothing is stale (restricted to the
    # rules that RAN — a --rules subset must not flag the others')
    ran_rules = {rule.name for rule in rules}
    for rel, sup in sorted(sup_by_file.items()):
        kept.extend(sup.stale(rel, ran_rules))

    # baseline
    if baseline_path is None:
        baseline_path = os.path.join(root, baseline_lib.BASELINE_PATH)
    baselined: List[Finding] = []
    if baseline_path:
        base = baseline_lib.Baseline.load(baseline_path)
        # a rule-subset run only sees that subset's entries: entries of
        # un-run rules are neither matchable nor stale
        base = base.restricted_to({rule.name for rule in rules}
                                  | {suppress.META_RULE})
        kept, baselined, stale = base.apply(kept)
        kept.extend(stale)
        kept.extend(base.problems())

    kept.sort(key=lambda f: (f.file, f.line, f.rule))
    return Report(kept, suppressed, baselined,
                  [rule.name for rule in rules],
                  len(tree.files('all')), time.perf_counter() - t0)
