"""Reviewed baseline: findings accepted as-is, with a reason each — the
port's copy of ``code2vec_tpu/analysis/baseline.py``, reading and writing
the same file format, so one baseline file reads the same in both
engines.

The port's baseline is ``code2vec_tpu_torch/analysis/graftlint_baseline.
json`` (the reference's stays at the repo root)::

    {"entries": [
      {"rule": "host-sync", "file": "code2vec_tpu_torch/x.py",
       "message": "...exact finding message...",
       "reason": "why this finding is accepted"}
    ]}

Matching is on ``(rule, file, message)`` — deliberately line-free, so
entries survive unrelated edits that shift line numbers.  Two
meta-findings keep the file honest:

- a **bare** entry (missing/empty ``reason``) is a finding — the
  baseline documents judgment calls, it is not a mute button;
- a **stale** entry (matching no current finding) is a finding — fixed
  code must shed its baseline line in the same PR, or the baseline rots
  into a list of ghosts that mask regressions at the same site.

``--write-baseline`` emits entries with ``reason: "TODO"`` which then
fail the bare-entry check: regenerating the file cannot silently launder
new findings past review.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from code2vec_tpu_torch.analysis.core import Finding
from code2vec_tpu_torch.analysis.suppress import META_RULE

BASELINE_NAME = 'graftlint_baseline.json'
# the port's baseline, relative to the repo root
BASELINE_PATH = os.path.join('code2vec_tpu_torch', 'analysis',
                             BASELINE_NAME)


class Baseline:
    def __init__(self, entries: List[dict], path: str = BASELINE_NAME):
        self.entries = entries
        self.path = path

    @classmethod
    def load(cls, path: str) -> 'Baseline':
        rel = os.path.basename(path)
        if not os.path.isfile(path):
            return cls([], rel)
        with open(path, 'r') as f:
            data = json.load(f)
        return cls(list(data.get('entries', [])), rel)

    def restricted_to(self, rule_names) -> 'Baseline':
        """The baseline as seen by a run of only ``rule_names``: entries
        for rules that did not run are neither matchable nor stale (a
        ``--rules host-sync`` run must not report another rule's
        entries as stale)."""
        names = set(rule_names)
        return Baseline([e for e in self.entries
                         if e.get('rule') in names], self.path)

    def problems(self) -> List[Finding]:
        """Structural issues: bare entries, duplicate keys."""
        out: List[Finding] = []
        seen: Dict[Tuple[str, str, str], int] = {}
        for i, entry in enumerate(self.entries):
            key = (entry.get('rule', ''), entry.get('file', ''),
                   entry.get('message', ''))
            if not all(key):
                out.append(Finding(
                    META_RULE, self.path, 0,
                    'baseline entry %d is missing rule/file/message' % i))
                continue
            if not str(entry.get('reason', '')).strip() \
                    or entry.get('reason') == 'TODO':
                out.append(Finding(
                    META_RULE, self.path, 0,
                    'bare baseline entry (no reason) for [%s] %s: %s'
                    % (key[0], key[1], key[2])))
            if key in seen:
                out.append(Finding(
                    META_RULE, self.path, 0,
                    'duplicate baseline entry for [%s] %s: %s'
                    % (key[0], key[1], key[2])))
            seen[key] = i
        return out

    def apply(self, findings: List[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[Finding]]:
        """(kept, baselined, stale-entry findings)."""
        keys = {}
        for entry in self.entries:
            key = (entry.get('rule', ''), entry.get('file', ''),
                   entry.get('message', ''))
            if all(key):
                keys[key] = False
        kept: List[Finding] = []
        baselined: List[Finding] = []
        for finding in findings:
            if finding.key() in keys:
                keys[finding.key()] = True
                baselined.append(finding)
            else:
                kept.append(finding)
        stale = [Finding(META_RULE, self.path, 0,
                         'stale baseline entry (no longer found) for '
                         '[%s] %s: %s' % key)
                 for key, matched in keys.items() if not matched]
        return kept, baselined, stale


def write(path: str, findings: List[Finding],
          existing: Optional[Baseline] = None,
          preserve: Sequence[dict] = ()) -> None:
    """Regenerate the baseline from current findings, keeping reasons of
    entries that still match; new entries get reason 'TODO' (which fails
    the bare-entry check until a human fills it in).  ``preserve``
    carries entries to keep verbatim — the entries of rules a
    ``--rules``-subset run did NOT run, whose reviewed reasons must
    survive the rewrite."""
    reasons = {}
    if existing is not None:
        for entry in existing.entries:
            key = (entry.get('rule', ''), entry.get('file', ''),
                   entry.get('message', ''))
            reasons[key] = entry.get('reason', 'TODO')
    entries = []
    seen = set()
    for entry in preserve:
        key = (entry.get('rule', ''), entry.get('file', ''),
               entry.get('message', ''))
        if all(key) and key not in seen:
            seen.add(key)
            entries.append(dict(entry))
    for finding in sorted(findings, key=lambda f: (f.rule, f.file,
                                                   f.line)):
        key = finding.key()
        if key in seen:
            continue
        seen.add(key)
        entries.append({'rule': finding.rule, 'file': finding.file,
                        'message': finding.message,
                        'reason': reasons.get(key, 'TODO')})
    with open(path, 'w') as f:
        json.dump({'entries': entries}, f, indent=2, sort_keys=False)
        f.write('\n')
