"""Offline dataset production: raw extractor output → ``.c2v`` + ``.dict.c2v``
(a copy of ``code2vec_tpu/data/preprocess.py``: the same CLI, and with the
same ``--seed`` the same bytes out).

Replaces both the reference's awk histogram pass (preprocess.sh:55-58) and its
``preprocess.py`` sampling/padding pass (:23-74) with one Python module (the
histogram pass is plain counting; the native extractor can also emit
histograms directly).

Semantics preserved exactly:

- per-split context truncation to ``max_contexts`` with vocab-aware sampling:
  prefer contexts whose three parts are all in-vocab ('full found'), then
  those with any part in-vocab ('partial found'), random-sampling within a
  tier (reference preprocess.py:41-56);
- rows with zero contexts are dropped (:58-60);
- rows are padded with trailing spaces to exactly ``max_contexts`` fields
  (:64-65) so files are byte-layout compatible with reference readers;
- ``.dict.c2v`` = sequential pickles of word/path/target→count dicts +
  train example count (:12-20).
"""
from __future__ import annotations

import pickle
import random
from argparse import ArgumentParser
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from code2vec_tpu_torch import common


def build_histograms(raw_path: str) -> Tuple[Counter, Counter, Counter]:
    """Count target names (field 1), origin tokens (ctx fields 1 and 3) and
    paths (ctx field 2) over a raw extractor output file — the reference did
    this with three awk one-liners (preprocess.sh:55-58)."""
    target_count: Counter = Counter()
    token_count: Counter = Counter()
    path_count: Counter = Counter()
    with open(raw_path, 'r') as file:
        for line in file:
            parts = line.rstrip('\n').split(' ')
            if not parts or not parts[0]:
                continue
            target_count[parts[0]] += 1
            for ctx in parts[1:]:
                if not ctx:
                    continue
                pieces = ctx.split(',')
                if len(pieces) != 3:
                    continue
                token_count[pieces[0]] += 1
                path_count[pieces[1]] += 1
                token_count[pieces[2]] += 1
    return token_count, path_count, target_count


def save_histogram(counter: Counter, path: str) -> None:
    """``word count`` lines, most-common first (awk output is unsorted, but
    readers don't depend on order — common.load_histogram re-sorts by count)."""
    with open(path, 'w') as f:
        for word, count in counter.most_common():
            f.write('{} {}\n'.format(word, count))


truncate_to_max_size = common.truncate_histogram_to_max_size


# Sampling tiers (reference preprocess.py:41-56 semantics): when a row has
# more contexts than fit, contexts whose three parts are all in-vocab win
# over those with any in-vocab part, which win over fully-OOV ones.
_TIER_ALL_IN_VOCAB = 2
_TIER_SOME_IN_VOCAB = 1
_TIER_NONE_IN_VOCAB = 0


def _vocab_tier(context: str, token_vocab: Dict[str, int],
                path_vocab: Dict[str, int]) -> int:
    pieces = context.split(',')
    hits = (pieces[0] in token_vocab, pieces[1] in path_vocab,
            pieces[2] in token_vocab)
    if all(hits):
        return _TIER_ALL_IN_VOCAB
    return _TIER_SOME_IN_VOCAB if any(hits) else _TIER_NONE_IN_VOCAB


def sample_contexts(contexts: list, limit: int,
                    token_vocab: Dict[str, int], path_vocab: Dict[str, int],
                    rng) -> list:
    """Tiered downsampling of one row's contexts to at most ``limit``.

    Rows already within the limit pass through untouched.  Oversized rows
    are partitioned by vocabulary tier; the fully-OOV tier is discarded,
    and random sampling breaks ties within the first tier that overflows
    the remaining budget.  The result can therefore be *shorter* than
    ``limit`` — or empty, which callers treat as a dropped row — exactly
    the reference's behavior (preprocess.py:41-60).
    """
    if len(contexts) <= limit:
        return contexts
    tiers: Dict[int, list] = {_TIER_ALL_IN_VOCAB: [], _TIER_SOME_IN_VOCAB: [],
                              _TIER_NONE_IN_VOCAB: []}
    for context in contexts:
        tiers[_vocab_tier(context, token_vocab, path_vocab)].append(context)
    keep = tiers[_TIER_ALL_IN_VOCAB]
    if len(keep) >= limit:
        return rng.sample(keep, limit)
    runners_up = tiers[_TIER_SOME_IN_VOCAB]
    budget = limit - len(keep)
    if len(runners_up) > budget:
        runners_up = rng.sample(runners_up, budget)
    return keep + runners_up


@dataclass
class SplitStats:
    """Per-split accounting, reported once the split is written."""
    rows_kept: int = 0
    rows_dropped_empty: int = 0
    contexts_seen: int = 0
    contexts_written: int = 0
    widest_raw_row: int = 0

    def observe_raw(self, n_contexts: int) -> None:
        self.contexts_seen += n_contexts
        self.widest_raw_row = max(self.widest_raw_row, n_contexts)

    def report(self, source_path: str) -> None:
        print(f'{source_path}: kept {self.rows_kept} rows, dropped '
              f'{self.rows_dropped_empty} empty', flush=True)
        if self.rows_kept:
            print(f'  contexts/row: {self.contexts_seen / self.rows_kept:.2f}'
                  f' raw -> {self.contexts_written / self.rows_kept:.2f}'
                  f' after sampling; widest raw row: {self.widest_raw_row}')


def process_file(file_path: str, data_file_role: str, dataset_name: str,
                 word_to_count: Dict[str, int], path_to_count: Dict[str, int],
                 max_contexts: int, rng: Optional[random.Random] = None) -> int:
    """Stream one raw split through tiered sampling into
    ``<dataset>.<role>.c2v``, space-padding every row to exactly
    ``max_contexts`` context fields (byte-layout compatible with reference
    readers, preprocess.py:64-65).  Returns the number of rows kept.
    """
    rng = rng or random
    stats = SplitStats()
    output_path = f'{dataset_name}.{data_file_role}.c2v'
    with open(file_path, 'r') as source, open(output_path, 'w') as sink:
        for line in source:
            label, *contexts = line.rstrip('\n').split(' ')
            stats.observe_raw(len(contexts))
            kept = sample_contexts(contexts, max_contexts,
                                   word_to_count, path_to_count, rng)
            if not kept:
                stats.rows_dropped_empty += 1
                continue
            stats.contexts_written += len(kept)
            stats.rows_kept += 1
            padding = ' ' * (max_contexts - len(kept))
            sink.write(f"{label} {' '.join(kept)}{padding}\n")
    stats.report(file_path)
    return stats.rows_kept


def save_dictionaries(dataset_name: str, word_to_count: Dict[str, int],
                      path_to_count: Dict[str, int],
                      target_to_count: Dict[str, int],
                      num_training_examples: int) -> None:
    """Sequential-pickle layout of ``.dict.c2v``
    (reference preprocess.py:12-20)."""
    save_path = '{}.dict.c2v'.format(dataset_name)
    with open(save_path, 'wb') as file:
        pickle.dump(word_to_count, file)
        pickle.dump(path_to_count, file)
        pickle.dump(target_to_count, file)
        pickle.dump(num_training_examples, file)
    print('Dictionaries saved to: {}'.format(save_path))


def preprocess_dataset(train_raw: str, val_raw: str, test_raw: str,
                       output_name: str, max_contexts: int = 200,
                       word_vocab_size: int = 1301136,
                       path_vocab_size: int = 911417,
                       target_vocab_size: int = 261245,
                       word_histogram: Optional[str] = None,
                       path_histogram: Optional[str] = None,
                       target_histogram: Optional[str] = None,
                       seed: Optional[int] = None) -> None:
    """End-to-end offline preprocessing. If histogram files aren't supplied,
    they are built from the raw train split directly (replacing the awk
    pass)."""
    rng = random.Random(seed) if seed is not None else None
    if word_histogram and path_histogram and target_histogram:
        word_to_count = common.load_histogram(word_histogram,
                                              max_size=word_vocab_size)
        path_to_count = common.load_histogram(path_histogram,
                                              max_size=path_vocab_size)
        target_to_count = common.load_histogram(target_histogram,
                                                max_size=target_vocab_size)
    else:
        token_count, path_count, target_count = build_histograms(train_raw)
        word_to_count = truncate_to_max_size(token_count, word_vocab_size)
        path_to_count = truncate_to_max_size(path_count, path_vocab_size)
        target_to_count = truncate_to_max_size(target_count, target_vocab_size)

    num_training_examples = 0
    for raw_path, role in zip([test_raw, val_raw, train_raw],
                              ['test', 'val', 'train']):
        num_examples = process_file(
            file_path=raw_path, data_file_role=role, dataset_name=output_name,
            word_to_count=word_to_count, path_to_count=path_to_count,
            max_contexts=max_contexts, rng=rng)
        if role == 'train':
            num_training_examples = num_examples
    save_dictionaries(output_name, word_to_count, path_to_count,
                      target_to_count, num_training_examples)


def main(argv=None) -> None:
    parser = ArgumentParser(prog='code2vec_tpu_torch.data.preprocess')
    parser.add_argument('-trd', '--train_data', dest='train_data_path',
                        required=True)
    parser.add_argument('-ted', '--test_data', dest='test_data_path',
                        required=True)
    parser.add_argument('-vd', '--val_data', dest='val_data_path',
                        required=True)
    parser.add_argument('-mc', '--max_contexts', dest='max_contexts',
                        type=int, default=200)
    parser.add_argument('-wvs', '--word_vocab_size', dest='word_vocab_size',
                        type=int, default=1301136)
    parser.add_argument('-pvs', '--path_vocab_size', dest='path_vocab_size',
                        type=int, default=911417)
    parser.add_argument('-tvs', '--target_vocab_size', dest='target_vocab_size',
                        type=int, default=261245)
    parser.add_argument('-wh', '--word_histogram', dest='word_histogram',
                        default=None)
    parser.add_argument('-ph', '--path_histogram', dest='path_histogram',
                        default=None)
    parser.add_argument('-th', '--target_histogram', dest='target_histogram',
                        default=None)
    parser.add_argument('-o', '--output_name', dest='output_name',
                        required=True)
    parser.add_argument('--seed', type=int, default=None)
    args = parser.parse_args(argv)
    preprocess_dataset(
        train_raw=args.train_data_path, val_raw=args.val_data_path,
        test_raw=args.test_data_path, output_name=args.output_name,
        max_contexts=args.max_contexts,
        word_vocab_size=args.word_vocab_size,
        path_vocab_size=args.path_vocab_size,
        target_vocab_size=args.target_vocab_size,
        word_histogram=args.word_histogram,
        path_histogram=args.path_histogram,
        target_histogram=args.target_histogram, seed=args.seed)


if __name__ == '__main__':
    main()
