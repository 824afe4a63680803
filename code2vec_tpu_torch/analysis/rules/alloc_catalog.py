"""Rule ``alloc-catalog``: allocations on the card in the owner modules
are ledger-accounted — the JAX counterpart is the rule of the same name
(``code2vec_tpu/analysis/rules/alloc_catalog.py``), here over torch.

The device-memory ledger (``telemetry/memory.py``) stays honest only if
every allocation owner registers what it allocates, so every allocation
site in the cataloged owner modules (``ALLOC_OWNER_FILES``) must sit
inside a function cataloged in ``ALLOC_CATALOG`` (each entry records WHY
its accounting is right) or carry an inline ``# graftlint:
disable=alloc-catalog -- why`` suppression.  Counts are pinned per
function, so a NEW allocation slipped into a cataloged owner still
fails; an entry whose function no longer allocates is stale and fails.

Allocation sites (AST-matched, so comments and docstrings never count):

- ``torch.zeros`` / ``empty`` / ``full`` / ``ones`` / ``as_tensor`` /
  ``tensor`` with a ``device=`` other than ``'cpu'``;
- ``x.to(<device>)`` — a ``.to`` whose first argument or ``device=`` is
  neither a dtype (``torch.<dtype>``, ``y.dtype``) nor ``'cpu'``;
- ``x.cuda()``.
"""
from __future__ import annotations

import ast
import collections
from typing import Dict, List, Optional, Tuple

from code2vec_tpu_torch.analysis.core import Finding, Rule, register
from code2vec_tpu_torch.analysis.walker import (SourceTree, dotted_name,
                                                terminal_name)

CATALOG_FILE = 'code2vec_tpu_torch/telemetry/memory.py'

_CONSTRUCTORS = frozenset(('torch.zeros', 'torch.empty', 'torch.full',
                           'torch.ones', 'torch.as_tensor', 'torch.tensor'))
_DTYPES = frozenset((
    'float32', 'float', 'float16', 'half', 'bfloat16', 'float64', 'double',
    'int8', 'uint8', 'int16', 'int32', 'int', 'int64', 'long', 'bool'))


def _is_cpu(node: Optional[ast.expr]) -> bool:
    return isinstance(node, ast.Constant) and node.value == 'cpu'


def _is_dtype(node: ast.expr) -> bool:
    """``torch.<dtype>``, or another tensor's ``.dtype`` / a name
    ``dtype``."""
    name = dotted_name(node)
    if name is None:
        return False
    last = name.split('.')[-1]
    return (name.startswith('torch.') and last in _DTYPES) or \
        last == 'dtype'


def _device_kw(node: ast.Call) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == 'device':
            return kw.value
    return None


def site_name(node: ast.Call) -> Optional[str]:
    """The allocation a call makes on the card, or None."""
    dotted = dotted_name(node.func)
    term = terminal_name(node.func)
    if dotted in _CONSTRUCTORS:
        device = _device_kw(node)
        return dotted if device is not None and not _is_cpu(device) \
            else None
    if not isinstance(node.func, ast.Attribute):
        return None
    if term == 'cuda':
        return '.cuda'
    if term == 'to':
        target = node.args[0] if node.args else _device_kw(node)
        if target is None or _is_cpu(target) or _is_dtype(target):
            return None
        return '.to'
    return None


def find_sites(tree: SourceTree, owner_files) -> List[Tuple[str, str,
                                                            int, str]]:
    """[(relpath, enclosing_function, lineno, site_name)] across the
    cataloged owner modules present in the tree."""
    out = []
    for rel in owner_files:
        source = tree.get(rel)
        if source is None or source.tree is None:
            continue
        for node in ast.walk(source.tree):
            if not isinstance(node, ast.Call):
                continue
            site = site_name(node)
            if site is not None:
                func = source.enclosing_function(node.lineno) or ''
                out.append((rel, func, node.lineno, site))
    return out


@register
class AllocCatalogRule(Rule):
    name = 'alloc-catalog'
    doc = ('every allocation on the card in the cataloged owner modules '
           '(telemetry/memory.py ALLOC_CATALOG) is ledger-accounted; '
           'counts are pinned and stale entries fail')
    scope = 'package'

    def run(self, tree: SourceTree) -> List[Finding]:
        try:
            from code2vec_tpu_torch.telemetry.memory import (
                ALLOC_CATALOG, ALLOC_OWNER_FILES)
        except ImportError:
            return [self.finding(
                CATALOG_FILE, 0, 'alloc catalog is not importable')]
        findings: List[Finding] = []
        catalog: Dict[Tuple[str, str], dict] = {}
        for entry in ALLOC_CATALOG:
            key = (entry['file'], entry['func'])
            if key in catalog:
                findings.append(self.finding(
                    CATALOG_FILE, 0,
                    'duplicate alloc-catalog entry for %s::%s' % key))
            if not entry.get('reason'):
                findings.append(self.finding(
                    CATALOG_FILE, 0,
                    'alloc-catalog entry %s::%s has no reason — the '
                    'accounting treatment must be justified where '
                    'reviewers see it' % key))
            if entry['file'] not in ALLOC_OWNER_FILES:
                findings.append(self.finding(
                    CATALOG_FILE, 0,
                    'alloc-catalog entry %s::%s names a file outside '
                    'ALLOC_OWNER_FILES — the rule never scans it, so '
                    'the entry is unverifiable' % key))
            catalog[key] = entry

        by_func: Dict[Tuple[str, str], List[Tuple[int, str]]] = \
            collections.defaultdict(list)
        for rel, func, lineno, site in find_sites(tree, ALLOC_OWNER_FILES):
            by_func[(rel, func)].append((lineno, site))

        for key, found in sorted(by_func.items()):
            rel, func = key
            entry = catalog.get(key)
            if entry is None:
                for lineno, site in found:
                    findings.append(self.finding(
                        rel, lineno,
                        'allocation site %s in %s is not in the alloc '
                        'catalog (telemetry/memory.py ALLOC_CATALOG) — '
                        'register the allocation with the memory '
                        'ledger and catalog the owner, or suppress '
                        'with a reason' % (site, func or '<module>')))
            elif entry['count'] != len(found):
                findings.append(self.finding(
                    rel, found[0][0],
                    'alloc catalog pins %d allocation site(s) in %s '
                    'but found %d — a new (or removed) allocation must '
                    'update the catalog entry and its ledger '
                    'accounting' % (entry['count'], func, len(found))))

        scanned = {rel for rel in ALLOC_OWNER_FILES
                   if tree.get(rel) is not None}
        for key, entry in sorted(catalog.items()):
            if key[0] in scanned and key not in by_func:
                findings.append(self.finding(
                    CATALOG_FILE, 0,
                    'alloc-catalog entry %s::%s is stale — the '
                    'function no longer contains an allocation site'
                    % key))
        return findings
