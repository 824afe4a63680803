"""graftlint CLI for the port: run the rule engine over the checkout.

    python -m code2vec_tpu_torch.analysis                   # all rules
    python -m code2vec_tpu_torch.analysis --rules host-sync,capture-purity
    python -m code2vec_tpu_torch.analysis --list-rules
    python -m code2vec_tpu_torch.analysis --list       # suppressed and
                                                       # baselined too
    python -m code2vec_tpu_torch.analysis --write-baseline  # new entries
                                                       # get reason TODO

Exit status: 0 clean, 1 on any unbaselined, unsuppressed finding. The
baseline is ``code2vec_tpu_torch/analysis/graftlint_baseline.json``.
"""
from __future__ import annotations

import argparse
import os
import sys

from code2vec_tpu_torch.analysis import baseline as baseline_lib
from code2vec_tpu_torch.analysis import engine
from code2vec_tpu_torch.analysis import rules as _rules  # noqa: F401
from code2vec_tpu_torch.analysis.core import all_rules


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m code2vec_tpu_torch.analysis',
        description=__doc__.splitlines()[0])
    parser.add_argument('--rules', default=None, metavar='R1,R2',
                        help='comma-separated rule names (default: all)')
    parser.add_argument('--list-rules', action='store_true',
                        help='print the registered rules and exit')
    parser.add_argument('--list', action='store_true',
                        help='also print suppressed and baselined '
                             'findings')
    parser.add_argument('--root', default=engine.repo_root(), metavar='DIR',
                        help='repository root to lint (default: this '
                             'checkout)')
    parser.add_argument('--baseline', default=None, metavar='FILE',
                        help='baseline file (default: <root>/%s)'
                             % baseline_lib.BASELINE_PATH)
    parser.add_argument('--no-baseline', action='store_true',
                        help='ignore the baseline (show everything)')
    parser.add_argument('--write-baseline', action='store_true',
                        help='regenerate the baseline from current '
                             'findings; NEW entries get reason TODO '
                             'and still fail until a human fills them '
                             'in')
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print('%-18s %s' % (rule.name, rule.doc))
        return 0

    rule_names = (None if args.rules is None
                  else [r.strip() for r in args.rules.split(',')
                        if r.strip()])
    baseline_path = args.baseline
    if args.no_baseline or args.write_baseline:
        baseline_path = ''  # raw findings (no stale-entry meta noise)
    report = engine.run(root=args.root, rule_names=rule_names,
                        baseline_path=baseline_path)

    if args.write_baseline:
        path = (args.baseline if args.baseline else
                os.path.join(args.root, baseline_lib.BASELINE_PATH))
        existing = baseline_lib.Baseline.load(path)
        # entries of rules this run did NOT execute are kept verbatim
        ran = set(report.rules_run)
        keep = [e for e in existing.entries if e.get('rule') not in ran]
        baseline_lib.write(path, report.findings, existing=existing,
                           preserve=keep)
        print('baseline written to %s (%d finding(s), %d preserved '
              'from un-run rules) — fill in any TODO reasons before '
              'committing' % (path, len(report.findings), len(keep)))
        return 0

    if args.list:
        for finding in report.suppressed:
            print('suppressed: %s' % finding.format())
        for finding in report.baselined:
            print('baselined:  %s' % finding.format())
    for finding in report.findings:
        print(finding.format(), file=sys.stderr)
    print(report.summary(), file=sys.stderr if report.findings
          else sys.stdout)
    return 0 if report.clean else 1


if __name__ == '__main__':
    sys.exit(main())
