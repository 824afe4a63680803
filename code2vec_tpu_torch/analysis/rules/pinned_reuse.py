"""Rule ``pinned-reuse``: a pinned host buffer is rewritten only after the
copy that read it is done — the counterpart of the JAX
``donation-safety`` (``code2vec_tpu/analysis/rules/donation.py``).

The reference donates its staged batches to the step
(DONATE_STAGED_BATCHES), and its rule forbids reading a buffer after
donating it. The port donates nothing (a staged batch's memory goes back
to the caching allocator when the step that read it is done), so that
rule has no counterpart here; the hazard the port does have is its dual.
A ``non_blocking`` copy from a pinned host buffer returns before the
card has read it, so the host must not write the buffer again until the
copy's event has completed — else the card reads the next batch's bytes,
silently. The staging ring (``training/trainer.py::PinnedPool``) and the
serving ladder's rings (``serving/graphs.py::PinnedRing``) keep this; the
rule keeps it kept:

1. pinned memory (``pin_memory=True``, ``.pin_memory()``) is allocated
   only in cataloged pools (``catalog.PINNED_ALLOCATORS``; counts
   pinned, stale entries fail);
2. a pool function that hands a REUSED buffer out
   (``catalog.PINNED_REUSERS``) waits on an event (``.synchronize()``)
   before it returns;
3. every ``non_blocking=True`` copy is followed, in its function, by an
   event's ``.record(...)``: a copy no event marks cannot be waited on.
"""
from __future__ import annotations

import ast
import collections
from typing import Dict, List, Tuple

from code2vec_tpu_torch.analysis import catalog
from code2vec_tpu_torch.analysis.core import Finding, Rule, register
from code2vec_tpu_torch.analysis.walker import SourceTree, terminal_name


def _is_true(node: ast.expr) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _pins(node: ast.Call) -> bool:
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr == 'pin_memory' and not node.args:
        return True
    return any(kw.arg == 'pin_memory' and _is_true(kw.value)
               for kw in node.keywords)


def _non_blocking(node: ast.Call) -> bool:
    return any(kw.arg == 'non_blocking' and _is_true(kw.value)
               for kw in node.keywords)


@register
class PinnedReuseRule(Rule):
    name = 'pinned-reuse'
    doc = ('pinned buffers only from cataloged pools that wait on the '
           'last copy\'s event before reuse; every non_blocking copy '
           'records an event')
    scope = 'package'

    def run(self, tree: SourceTree) -> List[Finding]:
        findings: List[Finding] = []
        allocators = {(e['file'], e['func']): e
                      for e in catalog.PINNED_ALLOCATORS}
        observed: Dict[Tuple[str, str], int] = collections.Counter()
        for source in tree.files(self.scope):
            if source.tree is None:
                continue
            for info in source.functions:
                calls = [n for n in ast.walk(info.node)
                         if isinstance(n, ast.Call)
                         and source.enclosing_function(n.lineno)
                         == info.qualname]
                records = [n.lineno for n in calls
                           if terminal_name(n.func) == 'record']
                for node in calls:
                    if _pins(node):
                        key = (source.rel, info.qualname)
                        observed[key] += 1
                        if key not in allocators:
                            findings.append(self.finding(
                                source.rel, node.lineno,
                                'pinned allocation in `%s` outside a '
                                'cataloged pool — allocate pinned '
                                'buffers in a pool that waits on their '
                                'last copy (PINNED_ALLOCATORS, '
                                'analysis/catalog.py)' % info.qualname))
                    if _non_blocking(node) and \
                            not any(r > node.lineno for r in records):
                        findings.append(self.finding(
                            source.rel, node.lineno,
                            'non_blocking copy in `%s` with no event '
                            'recorded after it — its source buffer '
                            'cannot be waited on before it is '
                            'rewritten' % info.qualname))
        for key, entry in sorted(allocators.items()):
            if tree.get(entry['file']) is None:
                continue
            seen = observed.get(key, 0)
            if seen != entry['count']:
                findings.append(self.finding(
                    entry['file'], 0,
                    'PINNED_ALLOCATORS pins %d pinned allocation(s) in '
                    '`%s` but found %d' % (entry['count'], entry['func'],
                                           seen)))
        for entry in catalog.PINNED_REUSERS:
            source = tree.get(entry['file'])
            if source is None:
                continue
            info = next((f for f in source.functions
                         if f.qualname == entry['func']), None)
            if info is None:
                findings.append(self.finding(
                    entry['file'], 0,
                    'stale PINNED_REUSERS entry: no `%s`' % entry['func']))
                continue
            waits = any(isinstance(n, ast.Call)
                        and terminal_name(n.func) == 'synchronize'
                        for n in ast.walk(info.node))
            if not waits:
                findings.append(self.finding(
                    entry['file'], info.lineno,
                    '`%s` hands a reused pinned buffer out without '
                    'waiting on its last copy\'s event — the host would '
                    'rewrite it under a copy still reading it'
                    % entry['func']))
        return findings
