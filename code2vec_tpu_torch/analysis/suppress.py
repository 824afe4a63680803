"""Inline suppressions: ``# graftlint: disable=<rule>[,<rule>] -- reason``
(the port's copy of ``code2vec_tpu/analysis/suppress.py``; the same
comment syntax in both packages).

A suppression silences findings of the named rule(s) on its own line or
on the line DIRECTLY below (the usual shape: comment above the flagged
statement).  The ``-- reason`` clause is mandatory — a reason-less
suppression is itself a finding (rule ``graftlint``), so every silenced
site carries its justification in the diff where reviewers see it.

File-level form, for generated or deliberately-exempt files::

    # graftlint: disable-file=<rule>[,<rule>] -- reason

Suppressions are per-rule by design: ``disable=all`` is rejected (a
blanket gag would silently swallow rules added later).
"""
from __future__ import annotations

import re
from typing import Dict, List, Set, Tuple

from code2vec_tpu_torch.analysis.core import Finding
from code2vec_tpu_torch.analysis.walker import SourceFile

SUPPRESS_RE = re.compile(
    r'#\s*graftlint:\s*(disable|disable-file)=([A-Za-z0-9_,-]+)'
    r'(?:\s*--\s*(.*))?')

META_RULE = 'graftlint'  # findings about the lint mechanics themselves


class Suppressions:
    """Parsed suppressions of one file.  ``used`` records which
    line-suppressions actually silenced something — a suppression left
    behind after the code under it was fixed pre-silences the NEXT
    regression at that site, so the engine flags unused ones (same
    philosophy as stale baseline entries)."""

    def __init__(self, line_rules: Dict[int, Set[str]],
                 file_rules: Set[str], problems: List[Finding]):
        self.line_rules = line_rules
        self.file_rules = file_rules
        self.problems = problems
        self.used: Set[Tuple[int, str]] = set()  # (comment line, rule)

    def covers(self, rule: str, line: int) -> bool:
        if rule in self.file_rules:
            return True
        # the comment's own line, or a comment on the line above the
        # flagged statement
        for at in (line, line - 1):
            if rule in self.line_rules.get(at, ()):
                self.used.add((at, rule))
                return True
        return False

    def stale(self, file: str, ran_rules: Set[str]) -> List[Finding]:
        """Line-suppressions for rules that RAN but silenced nothing."""
        out: List[Finding] = []
        for lineno in sorted(self.line_rules):
            for rule in sorted(self.line_rules[lineno]):
                if rule in ran_rules and (lineno, rule) not in self.used:
                    out.append(Finding(
                        META_RULE, file, lineno,
                        'stale suppression: `disable=%s` here silences '
                        'nothing — the code under it was fixed; remove '
                        'the comment so it cannot pre-silence a future '
                        'regression' % rule))
        return out


def parse_file(source: SourceFile) -> Suppressions:
    line_rules: Dict[int, Set[str]] = {}
    file_rules: Set[str] = set()
    problems: List[Finding] = []
    # real COMMENT tokens only: docstring examples (`# graftlint: ...`
    # inside a string) never parse as live suppressions
    for lineno, text in source.comments:
        match = SUPPRESS_RE.search(text)
        if match is None:
            if 'graftlint:' in text and 'disable' in text:
                problems.append(Finding(
                    META_RULE, source.rel, lineno,
                    'malformed graftlint suppression (expected '
                    '`# graftlint: disable=<rule> -- reason`)'))
            continue
        kind, rules_text, reason = match.groups()
        rules = {r.strip() for r in rules_text.split(',') if r.strip()}
        if 'all' in rules:
            problems.append(Finding(
                META_RULE, source.rel, lineno,
                'blanket `disable=all` is not allowed — name the '
                'rule(s) being suppressed'))
            rules.discard('all')
        if not (reason or '').strip():
            problems.append(Finding(
                META_RULE, source.rel, lineno,
                'suppression without a reason — append `-- <why this '
                'site is sanctioned>`'))
            continue  # an unjustified suppression does not suppress
        if kind == 'disable-file':
            file_rules.update(rules)
        else:
            line_rules.setdefault(lineno, set()).update(rules)
    return Suppressions(line_rules, file_rules, problems)


def apply(findings: List[Finding], by_file: Dict[str, Suppressions]
          ) -> Tuple[List[Finding], List[Finding]]:
    """Partition findings into (kept, suppressed)."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for finding in findings:
        sup = by_file.get(finding.file)
        if sup is not None and sup.covers(finding.rule, finding.line):
            suppressed.append(finding)
        else:
            kept.append(finding)
    return kept, suppressed
