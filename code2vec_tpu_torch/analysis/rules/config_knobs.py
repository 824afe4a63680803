"""Rule ``config-knob-docs``: every knob the port reads is documented —
the JAX counterpart is the rule of the same name
(``code2vec_tpu/analysis/rules/config_knobs.py``), here over the port.

A knob nobody can find is a knob nobody can turn — and one that will be
"re-added" under a second name.  Two knob surfaces are collected from
``code2vec_tpu_torch/``:

- **environment variables** — ``os.environ.get('X')`` / ``os.environ['X']``
  string keys;
- **CLI flags** — the option strings of every ``add_argument`` call
  (the longest ``--flag`` spelling).

Each collected name must appear verbatim in at least one user-facing
repo-root doc (``USER_DOCS``: README.md or the owning subsystem doc —
SERVING.md, OBSERVABILITY.md, ROBUSTNESS.md, INDEX.md, PERF.md, ...).
The reference's rule searches every root ``*.md`` less a list of
process notes; here the documentation surface is listed instead, so a
new process note cannot count as documentation.  Names read
from a variable (dynamic keys) are invisible to this rule by
construction; keep knob names literal.
"""
from __future__ import annotations

import ast
from typing import List, Set, Tuple

from code2vec_tpu_torch.analysis.core import Finding, Rule, register
from code2vec_tpu_torch.analysis.walker import SourceTree, dotted_name

# the user-facing documentation at the repo root: the rest of its *.md
# files are process notes (the changelog, the roadmap, the papers and
# surveys), which name every flag a change adds and would make the rule
# vacuous
USER_DOCS = frozenset((
    'README.md', 'ANALYSIS.md', 'INDEX.md', 'MIGRATION.md',
    'OBSERVABILITY.md', 'PARITY.md', 'PERF.md', 'ROBUSTNESS.md',
    'SERVING.md', 'WORKLOADS.md',
))


@register
class ConfigKnobDocsRule(Rule):
    name = 'config-knob-docs'
    doc = ('every os.environ read and CLI flag in code2vec_tpu_torch/ '
           'appears in a repo-root *.md doc')
    scope = 'package'

    def run(self, tree: SourceTree) -> List[Finding]:
        knobs: List[Tuple[str, str, int, str]] = []  # (name, file, line, kind)
        for source in tree.files(self.scope):
            if source.tree is None:
                continue
            for node in ast.walk(source.tree):
                if isinstance(node, ast.Call):
                    name = dotted_name(node.func)
                    if name == 'os.environ.get' and node.args and \
                            isinstance(node.args[0], ast.Constant) and \
                            isinstance(node.args[0].value, str):
                        knobs.append((node.args[0].value, source.rel,
                                      node.lineno, 'env var'))
                    elif name is not None and \
                            name.endswith('add_argument'):
                        flag = self._longest_flag(node)
                        if flag is not None:
                            knobs.append((flag, source.rel, node.lineno,
                                          'CLI flag'))
                elif isinstance(node, ast.Subscript) and \
                        dotted_name(node.value) == 'os.environ' and \
                        isinstance(node.slice, ast.Constant) and \
                        isinstance(node.slice.value, str):
                    knobs.append((node.slice.value, source.rel,
                                  node.lineno, 'env var'))

        docs = [d for d in tree.root_docs() if d in USER_DOCS]
        doc_text = tree.doc_text(*docs)
        findings: List[Finding] = []
        reported: Set[str] = set()
        for name, rel, lineno, kind in knobs:
            if name in doc_text or name in reported:
                continue
            reported.add(name)
            findings.append(self.finding(
                rel, lineno,
                'undocumented %s `%s` — document it in README.md or '
                'the owning subsystem doc (searched: %s)'
                % (kind, name, ', '.join(docs) if docs else '<no '
                   'repo-root *.md docs found>')))
        return findings

    @staticmethod
    def _longest_flag(node: ast.Call):
        flags = [arg.value for arg in node.args
                 if isinstance(arg, ast.Constant)
                 and isinstance(arg.value, str)
                 and arg.value.startswith('-')]
        if not flags:
            return None
        return max(flags, key=len)
