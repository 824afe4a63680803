"""Rule ``span-catalog``: span names cannot drift from the catalog — the
JAX counterpart is the rule of the same name
(``code2vec_tpu/analysis/rules/span_catalog.py``), here against the
port's ``code2vec_tpu_torch/telemetry/tracing.py``.

The tracing analogue of ``metrics-schema`` / ``fault-points``: every
span emission site (``.begin('x.y')`` / ``.span('x.y')`` /
``.span_at('x.y')`` / ``.event('x.y')`` / ``.single('x.y')``) must name
a span cataloged in ``telemetry/tracing.py::SPAN_CATALOG``, every
cataloged span must be documented in OBSERVABILITY.md, and — like the
fault-point rule — every cataloged span must be WIRED at some call
site: a stale catalog entry would document a phase the span log can
never contain, the drift this lint exists to close.

Remote-origin spans: a span recorded in a WORKER process
and grafted into the parent trace by ``Trace.adopt_spans`` has no
local emission site by construction.  ``tracing.REMOTE_ORIGIN_SPANS``
declares those names; the rule treats a declared name as wired through
the adoption path, while still requiring it to be cataloged and
documented — and a declared name that is NOT in the catalog is itself
a finding (an adopted span the log can contain but the catalog
denies).
"""
from __future__ import annotations

import os
import re
from typing import List, Tuple

from code2vec_tpu_torch.analysis.core import Finding, Rule, register
from code2vec_tpu_torch.analysis.walker import SourceTree

# literal dotted first argument only ('serving.pack'): internal generic
# forwarding calls (trace._add(name, ...)) are invisible by design, and
# the dot requirement keeps unrelated .begin()/.event() calls out
SPAN_RE = re.compile(
    r"""\.(?:begin|span|span_at|event|single)\(\s*"""
    r"""['"]([a-z0-9_]+\.[a-z0-9_.]+)['"]""")

DOC_NAME = 'OBSERVABILITY.md'

CATALOG_FILE = os.path.join('code2vec_tpu_torch', 'telemetry', 'tracing.py')

# never scan the catalog's own module or this rule: their docstring
# examples would count as sites and mask a deleted real site
_SELF_FILES = (
    CATALOG_FILE,
    os.path.join('code2vec_tpu_torch', 'analysis', 'rules',
                 'span_catalog.py'),
)


def find_sites(tree: SourceTree) -> List[Tuple[str, int, str]]:
    """[(relpath, lineno, span_name)] across the scanned tree."""
    out = []
    for source in tree.files('all'):
        if source.rel in _SELF_FILES:
            continue
        for match in SPAN_RE.finditer(source.text):
            lineno = source.text.count('\n', 0, match.start()) + 1
            out.append((source.rel, lineno, match.group(1)))
    return out


@register
class SpanCatalogRule(Rule):
    name = 'span-catalog'
    doc = ('every traced span site names a SPAN_CATALOG entry '
           '(telemetry/tracing.py); every cataloged span is wired and '
           'documented in OBSERVABILITY.md')
    scope = 'all'

    def run(self, tree: SourceTree) -> List[Finding]:
        try:
            from code2vec_tpu_torch.telemetry.tracing import (
                REMOTE_ORIGIN_SPANS, SPAN_CATALOG)
        except ImportError:
            return [self.finding(
                CATALOG_FILE, 0, 'span catalog is not importable')]
        sites = find_sites(tree)
        findings: List[Finding] = []
        for rel, lineno, name in sites:
            if name not in SPAN_CATALOG:
                findings.append(self.finding(
                    rel, lineno,
                    'span %r is not in the catalog '
                    '(code2vec_tpu_torch/telemetry/tracing.py SPAN_CATALOG) '
                    '— '
                    'add it there and to OBSERVABILITY.md, or fix the '
                    'name' % name))
        doc = tree.doc_text(DOC_NAME)
        if doc:
            for name in sorted(SPAN_CATALOG):
                if name not in doc:
                    findings.append(self.finding(
                        DOC_NAME, 0,
                        'cataloged span %r is undocumented' % name))
        else:
            findings.append(self.finding(
                DOC_NAME, 0,
                'OBSERVABILITY.md is missing (the span catalog must be '
                'documented)'))
        for name in sorted(REMOTE_ORIGIN_SPANS - set(SPAN_CATALOG)):
            findings.append(self.finding(
                CATALOG_FILE, 0,
                'remote-origin span %r (REMOTE_ORIGIN_SPANS) is not in '
                'SPAN_CATALOG — adopt_spans can graft it into the span '
                'log, so the catalog must admit it' % name))
        # remote-origin spans are wired through the adoption path: a
        # worker records them and the mesh receiver grafts them, so no
        # local literal site is required
        wired = {name for _rel, _lineno, name in sites}
        wired |= REMOTE_ORIGIN_SPANS
        for name in sorted(set(SPAN_CATALOG) - wired):
            findings.append(self.finding(
                CATALOG_FILE, 0,
                'span %r is cataloged but has no emission site — stale '
                'catalog entries document phases the span log can never '
                'contain' % name))
        return findings
