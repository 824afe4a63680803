"""Rule ``host-sync``: the host waits for the card only at cataloged
sites — the torch counterpart of the JAX rule of the same name
(``code2vec_tpu/analysis/rules/host_sync.py``, which checks
``jax.device_get``, ``block_until_ready``, ``.item()`` and fetches of
jitted outputs).

A host sync stalls the launch queue: the host blocks until the card
drains, and the card then idles while the host queues the next work.
The kinds (``analysis/taint.py``):

- ``item`` / ``tolist`` — ``x.item()``, ``x.tolist()``;
- ``cpu`` — ``x.cpu()`` / ``x.to('cpu')``, a copy that waits;
- ``synchronize`` — ``torch.cuda.synchronize()`` and
  ``Event.synchronize()`` / ``Stream.synchronize()``;
- ``fetch`` — ``float``/``int``/``bool``/``np.asarray``/``.numpy()``
  over a result on the card (a step's output, ``.cuda()``, a tensor made
  with ``device=``), traced in the same function.

A conversion after ``.cpu()`` is on the host already and is not a second
sync. Every sanctioned site is cataloged with its reason in
``analysis/catalog.py::SANCTIONED_SYNCS``; this rule fails on a sync at
an uncataloged site, on more (or fewer) syncs in a function than its
entry's pinned ``count``, and on a stale entry.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

from code2vec_tpu_torch.analysis import catalog, taint
from code2vec_tpu_torch.analysis.core import Finding, Rule, register
from code2vec_tpu_torch.analysis.walker import SourceTree

_KIND_HINTS = {
    'item': '.item() waits for the card per scalar',
    'tolist': '.tolist() copies to the host and waits for the card',
    'cpu': '.cpu() copies to the host and waits for the card',
    'synchronize': 'synchronize() drains the card (or a stream/event)',
    'fetch': 'float/int/bool/np.asarray/.numpy() over a result on the '
             'card waits for it',
}


@register
class HostSyncRule(Rule):
    name = 'host-sync'
    doc = ('host synchronization (.item()/.tolist()/.cpu()/synchronize()/'
           'a fetch of a result on the card) only at cataloged sites')
    scope = 'package'

    def run(self, tree: SourceTree) -> List[Finding]:
        findings: List[Finding] = []
        observed: Dict[Tuple[str, str, str], int] = collections.Counter()
        sanctioned = {(e['file'], e['func'], e['kind']): e
                      for e in catalog.SANCTIONED_SYNCS}
        for source in tree.files(self.scope):
            if source.tree is None:
                continue
            for info, analysis in taint.analyze_file(source):
                for sync in analysis.syncs:
                    key = (source.rel, info.qualname, sync.kind)
                    observed[key] += 1
                    if key not in sanctioned:
                        findings.append(self.finding(
                            source.rel, sync.node.lineno,
                            'uncataloged host sync (%s) in `%s` — %s; '
                            'move it off the hot path or add a '
                            'SANCTIONED_SYNCS entry with its '
                            'justification (analysis/catalog.py)'
                            % (sync.kind, info.qualname,
                               _KIND_HINTS[sync.kind])))
        for key, entry in sanctioned.items():
            if tree.get(entry['file']) is None:
                continue
            if not str(entry.get('reason', '')).strip():
                findings.append(self.finding(
                    entry['file'], 0,
                    'SANCTIONED_SYNCS entry `%s` (%s) has no reason'
                    % (entry['func'], entry['kind'])))
            seen = observed.get(key, 0)
            if seen == 0:
                findings.append(self.finding(
                    entry['file'], 0,
                    'stale SANCTIONED_SYNCS entry: no %s sync found in '
                    '`%s` — the sanctioned site moved or was removed; '
                    'update the catalog' % (entry['kind'], entry['func'])))
            elif seen != entry['count']:
                findings.append(self.finding(
                    entry['file'], 0,
                    '`%s` has %d %s sync(s) but the catalog sanctions '
                    '%d — a sync was added or removed; update the count '
                    'with its justification'
                    % (entry['func'], seen, entry['kind'],
                       entry['count'])))
        return findings
