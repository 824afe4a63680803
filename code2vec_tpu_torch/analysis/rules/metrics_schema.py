"""Rule ``metrics-schema``: metric names cannot drift from catalog/doc —
the JAX counterpart is the rule of the same name
(``code2vec_tpu/analysis/rules/metrics_schema.py``), here against the
port's catalog: every metric name the port emits must exist in
``code2vec_tpu_torch/telemetry/catalog.py``, and every cataloged name
must be documented in OBSERVABILITY.md.  Grep-shaped on purpose — emission
sites are method calls with a string literal, and only literals
containing '/' (the catalog's ``subsystem/metric`` shape) count.
"""
from __future__ import annotations

import re
from typing import List, Tuple

from code2vec_tpu_torch.analysis.core import Finding, Rule, register
from code2vec_tpu_torch.analysis.walker import SourceTree

# \s* spans newlines: emission calls wrap across lines under the
# 79-column style, so matching is against whole-file content
EMIT_RE = re.compile(
    r"""\.(?:counter|gauge|timer|scalar|get)\(\s*['"]([^'"]*/[^'"]*)['"]""")

DOC_NAME = 'OBSERVABILITY.md'


def find_emissions(tree: SourceTree) -> List[Tuple[str, int, str]]:
    """[(relpath, lineno, metric_name)] across the scanned tree."""
    out = []
    for source in tree.files('all'):
        for match in EMIT_RE.finditer(source.text):
            lineno = source.text.count('\n', 0, match.start()) + 1
            out.append((source.rel, lineno, match.group(1)))
    return out


@register
class MetricsSchemaRule(Rule):
    name = 'metrics-schema'
    doc = ('every metric name the port emits is in its '
           'telemetry/catalog.py and '
           'documented in OBSERVABILITY.md')
    scope = 'all'

    def run(self, tree: SourceTree) -> List[Finding]:
        try:
            from code2vec_tpu_torch.telemetry.catalog import CATALOG
        except ImportError:
            # synthetic test trees have no package on path — emissions
            # are then unverifiable, which must be loud, not silent
            return [self.finding(
                'code2vec_tpu_torch/telemetry/catalog.py', 0,
                'telemetry catalog is not importable')]
        from code2vec_tpu_torch.telemetry.catalog import base_name
        findings: List[Finding] = []
        for rel, lineno, name in find_emissions(tree):
            # an instance-labeled literal ('m{replica=r0}') validates
            # against its label-free catalog family, same resolution as
            # the Prometheus exporter (catalog.base_name)
            if base_name(name) not in CATALOG:
                findings.append(self.finding(
                    rel, lineno,
                    'metric %r is not in the catalog '
                    '(code2vec_tpu_torch/telemetry/catalog.py) — add it '
                    'there '
                    'and to OBSERVABILITY.md, or fix the name' % name))
        doc = tree.doc_text(DOC_NAME)
        if doc:
            for name in sorted(CATALOG):
                if name not in doc:
                    findings.append(self.finding(
                        DOC_NAME, 0,
                        'cataloged metric %r is undocumented' % name))
        else:
            findings.append(self.finding(
                DOC_NAME, 0,
                'OBSERVABILITY.md is missing (the metric catalog must '
                'be documented)'))
        return findings
