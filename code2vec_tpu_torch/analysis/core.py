"""graftlint core: findings and the rule registry (the port's copy of
``code2vec_tpu/analysis/core.py``).

A rule is an object with:

- ``name``      — kebab-case id (``'host-sync'``), the key suppressions
                  and baselines reference;
- ``doc``       — one-line description (``--list-rules``);
- ``scope``     — 'package' or 'all' (which files it walks);
- ``run(tree)`` — ``SourceTree -> list[Finding]``.

Rules register at import time via ``@register`` (``rules/__init__.py``
imports every rule module); the engine resolves names through
``all_rules()``/``get_rules()``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from code2vec_tpu_torch.analysis.walker import SourceTree


class Finding:
    """One rule violation.

    ``message`` is deliberately line-number-free: the baseline matches
    on ``(rule, file, message)`` so entries survive unrelated edits that
    shift lines.  ``line`` localizes the finding for humans and for
    inline suppressions.
    """

    __slots__ = ('rule', 'file', 'line', 'message')

    def __init__(self, rule: str, file: str, line: int, message: str):
        self.rule = rule
        self.file = file
        self.line = int(line)
        self.message = message

    def key(self):
        """The baseline identity (line-insensitive)."""
        return (self.rule, self.file, self.message)

    def __repr__(self) -> str:
        return 'Finding(%r, %r:%d, %r)' % (self.rule, self.file,
                                           self.line, self.message)

    def format(self) -> str:
        return '%s:%d: [%s] %s' % (self.file, self.line, self.rule,
                                   self.message)


class Rule:
    """Base class for rules; subclasses set ``name``/``doc``/``scope``
    and implement ``run``."""

    name = ''
    doc = ''
    scope = 'package'

    def run(self, tree: SourceTree) -> List[Finding]:
        raise NotImplementedError

    def finding(self, file: str, line: int, message: str) -> Finding:
        return Finding(self.name, file, line, message)


_RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and register a rule by its name."""
    rule = cls()
    if not rule.name:
        raise ValueError('rule %r has no name' % cls)
    if rule.name in _RULES:
        raise ValueError('duplicate rule name %r' % rule.name)
    _RULES[rule.name] = rule
    return cls


def all_rules() -> List[Rule]:
    """Every registered rule, name order (rules/__init__.py must have
    been imported)."""
    return [_RULES[name] for name in sorted(_RULES)]


def get_rules(names: Optional[Sequence[str]]) -> List[Rule]:
    """Resolve rule names to instances; None = all."""
    if names is None:
        return all_rules()
    out = []
    for name in names:
        if name not in _RULES:
            raise KeyError('unknown rule %r (known: %s)'
                           % (name, ', '.join(sorted(_RULES))))
        out.append(_RULES[name])
    return out
