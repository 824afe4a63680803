"""Rule ``fault-points``: fault-point names cannot drift from catalog —
the JAX counterpart is the rule of the same name
(``code2vec_tpu/analysis/rules/fault_points.py``), here against the
port's catalog: every ``maybe_fire('<point>')`` site must exist in
``code2vec_tpu_torch/resilience/faults.py::FAULT_POINTS``, every cataloged
point must be documented in ROBUSTNESS.md, and — stricter than the
metrics rule — every cataloged point must be WIRED somewhere: a fault
spec naming an unwired point would parse fine and silently inject
nothing, the exact trap this lint exists to close.
"""
from __future__ import annotations

import os
import re
from typing import List, Tuple

from code2vec_tpu_torch.analysis.core import Finding, Rule, register
from code2vec_tpu_torch.analysis.walker import SourceTree

# \s* spans newlines: calls wrap across lines under the 79-column style
FIRE_RE = re.compile(r"""maybe_fire\(\s*['"]([A-Za-z0-9_]+)['"]""")

DOC_NAME = 'ROBUSTNESS.md'

CATALOG_FILE = 'code2vec_tpu_torch/resilience/faults.py'

# never scan the lint's own files: their docstring examples would count
# as sites and mask a deleted real site
_SELF_FILES = (
    os.path.join('code2vec_tpu_torch', 'analysis', 'rules',
                 'fault_points.py'),
)


def find_sites(tree: SourceTree) -> List[Tuple[str, int, str]]:
    """[(relpath, lineno, point_name)] across the scanned tree."""
    out = []
    for source in tree.files('all'):
        if source.rel in _SELF_FILES:
            continue
        for match in FIRE_RE.finditer(source.text):
            lineno = source.text.count('\n', 0, match.start()) + 1
            out.append((source.rel, lineno, match.group(1)))
    return out


@register
class FaultPointsRule(Rule):
    name = 'fault-points'
    doc = ('every maybe_fire site is in resilience/faults.py, every '
           'cataloged point is wired and documented in ROBUSTNESS.md')
    scope = 'all'

    def run(self, tree: SourceTree) -> List[Finding]:
        try:
            from code2vec_tpu_torch.resilience.faults import \
                FAULT_POINTS
        except ImportError:
            return [self.finding(
                CATALOG_FILE, 0,
                'fault-point catalog is not importable')]
        sites = find_sites(tree)
        findings: List[Finding] = []
        for rel, lineno, name in sites:
            if name not in FAULT_POINTS:
                findings.append(self.finding(
                    rel, lineno,
                    'fault point %r is not in the catalog '
                    '(code2vec_tpu_torch/resilience/faults.py) — add it '
                    'there and to ROBUSTNESS.md, or fix the name' % name))
        doc = tree.doc_text(DOC_NAME)
        if doc:
            for name in sorted(FAULT_POINTS):
                if name not in doc:
                    findings.append(self.finding(
                        DOC_NAME, 0,
                        'cataloged fault point %r is undocumented'
                        % name))
        else:
            findings.append(self.finding(
                DOC_NAME, 0,
                'ROBUSTNESS.md is missing (the fault-point catalog '
                'must be documented)'))
        fired = {name for _rel, _lineno, name in sites}
        for name in sorted(set(FAULT_POINTS) - fired):
            findings.append(self.finding(
                CATALOG_FILE, 0,
                'fault point %r is cataloged but has no maybe_fire '
                'site — every point must be wired, or specs naming it '
                'silently inject nothing' % name))
        return findings
