"""Raw ``label src,path,tgt ...`` lines -> fixed-width plane batches: the
predict input, and the train and test splits streamed as batches on the
configured wire (a copy of the predict, train and evaluate subsets of
``code2vec_tpu/data/reader.py``, with the same row semantics).

Train and evaluate tokenize through the native C++ tokenizer
(``data/native.py``) under READER_USE_NATIVE, evaluate slicing the label
strings in Python; predict keeps the Python tokenizer, which keeps every
context's strings for the attention display. ``iter_epoch_prefetched``
runs an epoch on a background thread (``prefetch_iterator``,
READER_PREFETCH_BATCHES deep).

A context part that is missing maps to PAD and one that is out of
vocabulary maps to OOV; under the joined PAD==OOV policy a context whose
three parts all land on index 0 is masked out. Predict rows are never
filtered; training keeps rows with an in-vocabulary label and at least
one valid context; evaluation keeps every row with at least one valid
context, OOV labels included, and keeps the label strings.
"""
from __future__ import annotations

import queue
import random
import threading
import time
from typing import Iterable, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import native
from code2vec_tpu_torch.data.packed import StickyPacker
from code2vec_tpu_torch.resilience import faults
from code2vec_tpu_torch.vocab import Code2VecVocabs


def context_valid_mask(source: np.ndarray, path: np.ndarray,
                       target: np.ndarray, token_pad: int,
                       path_pad: int) -> np.ndarray:
    """A context is valid iff any of its three parts is non-PAD."""
    return ((source != token_pad) | (target != token_pad)
            | (path != path_pad)).astype(np.float32)


def fault_site_batches(batches: Iterable) -> Iterator:
    """Pass-through of a batch stream (the reader's and the token
    cache's) that hosts the ``hang_input`` fault point: firing blocks the
    stream, on whichever thread drives it, as a wedged filesystem would,
    so the hang watchdog's input wait is drilled end to end."""
    for batch in batches:
        if faults.maybe_fire('hang_input'):
            time.sleep(faults.HANG_SECONDS)
        yield batch


def prefetch_iterator(make_iterator, depth: int):
    """Run ``make_iterator()`` on a background thread through a queue of
    ``depth`` items. An error in the producer is raised in the consumer
    after the items before it; closing the generator (or abandoning it)
    cancels the producer and joins its thread."""
    out: 'queue.Queue' = queue.Queue(max(1, depth))
    sentinel = object()
    cancelled = threading.Event()
    error: List[BaseException] = []

    def put(item) -> bool:
        while not cancelled.is_set():
            try:
                out.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in make_iterator():
                if not put(item):
                    return
        except BaseException as exc:      # raised again in the consumer
            error.append(exc)
        finally:
            # the sentinel must not be dropped on a full queue, or the
            # consumer would block forever after draining it
            put(sentinel)

    thread = threading.Thread(target=produce, daemon=True,
                              name='c2v-prefetch')
    thread.start()
    try:
        while True:
            item = out.get()
            if item is sentinel:
                break
            yield item
    finally:
        cancelled.set()
        thread.join()
    if error:
        raise error[0]


class Batch(NamedTuple):
    """One plane batch: ``(B, C)`` index planes and mask, ``(B,)`` label
    and weight, and the host-only strings predict decodes with."""
    source: np.ndarray               # (B, C) int32
    path: np.ndarray                 # (B, C) int32
    target: np.ndarray               # (B, C) int32
    mask: np.ndarray                 # (B, C) float32
    label: np.ndarray                # (B,)  int32
    weight: np.ndarray               # (B,)  float32
    label_strings: Optional[np.ndarray] = None     # (B,) object
    source_strings: Optional[np.ndarray] = None    # (B, C) object
    path_strings: Optional[np.ndarray] = None      # (B, C) object
    target_strings: Optional[np.ndarray] = None    # (B, C) object

    def device_arrays(self):
        """The arrays a step takes: ``(source, path, target, mask, label,
        weight)``."""
        return (self.source, self.path, self.target, self.mask, self.label,
                self.weight)


class ParsedRow(NamedTuple):
    label_str: str
    source_strs: List[str]
    path_strs: List[str]
    target_strs: List[str]


def parse_c2v_line(line: str, max_contexts: int) -> ParsedRow:
    """Split one ``label ctx1 ctx2 ...`` line; a ctx is ``src,path,tgt``.
    Missing, short or empty contexts pad with empty strings (-> PAD)."""
    parts = line.rstrip('\r\n').split(' ')
    label = parts[0]
    source_strs = [''] * max_contexts
    path_strs = [''] * max_contexts
    target_strs = [''] * max_contexts
    n = min(len(parts) - 1, max_contexts)
    for i in range(n):
        ctx = parts[i + 1]
        if not ctx:
            continue
        pieces = ctx.split(',')
        if len(pieces) >= 1:
            source_strs[i] = pieces[0]
        if len(pieces) >= 2:
            path_strs[i] = pieces[1]
        if len(pieces) >= 3:
            target_strs[i] = pieces[2]
    return ParsedRow(label, source_strs, path_strs, target_strs)


def canonicalize_contexts(lines: Iterable[str],
                          max_contexts: Optional[int] = None) -> List[str]:
    """Canonical form of raw predict lines: split as ``parse_c2v_line``
    splits, truncate to ``max_contexts`` in extraction order (empty slots
    count), then drop the empty slots and sort the survivors. Duplicate
    triples are kept: each one weighs in the attention sum."""
    out = []
    for line in lines:
        parts = str(line).rstrip('\r\n').split(' ')
        contexts = parts[1:]
        if max_contexts is not None:
            contexts = contexts[:max_contexts]
        out.append(' '.join([parts[0]] + sorted(c for c in contexts if c)))
    return out


class PathContextReader:
    """Tokenizes predict lines against the vocabularies, and streams the
    train split (shuffled) or the test split (in file order) as filtered
    batches (``iter_epoch``)."""

    def __init__(self, vocabs: Code2VecVocabs, config: Config):
        self.vocabs = vocabs
        self.config = config
        # sticky packed capacity, created on the first packed batch and
        # kept across epochs
        self._packer = None
        # the native tokenizer, made at the first train or evaluate chunk
        self._native = None

    def native_tokenizer(self) -> Optional['native.NativeTokenizer']:
        """The native tokenizer under READER_USE_NATIVE (built and loaded
        at the first call; a failure raises), else None."""
        if self._native is None and self.config.READER_USE_NATIVE:
            self._native = native.get_tokenizer(self.vocabs, self.config)
        return self._native

    def tokenize_rows(self, rows: Sequence[ParsedRow],
                      keep_strings: bool = True) -> Batch:
        """Vocab-lookup parsed rows into one batch of ``len(rows)``;
        ``keep_strings`` adds the strings predict decodes with."""
        n = len(rows)
        max_contexts = self.config.MAX_CONTEXTS
        token_get = self.vocabs.token_vocab.word_to_index.get
        path_get = self.vocabs.path_vocab.word_to_index.get
        target_get = self.vocabs.target_vocab.word_to_index.get
        token_oov = self.vocabs.token_vocab.oov_index
        token_pad = self.vocabs.token_vocab.pad_index
        path_oov = self.vocabs.path_vocab.oov_index
        path_pad = self.vocabs.path_vocab.pad_index
        target_oov = self.vocabs.target_vocab.oov_index
        # empty strings map to PAD, not OOV
        source = np.empty((n, max_contexts), dtype=np.int32)
        path = np.empty((n, max_contexts), dtype=np.int32)
        target = np.empty((n, max_contexts), dtype=np.int32)
        label = np.empty((n,), dtype=np.int32)
        for r, row in enumerate(rows):
            label[r] = target_get(row.label_str, target_oov)
            src_row, path_row, tgt_row = source[r], path[r], target[r]
            for c in range(max_contexts):
                s = row.source_strs[c]
                src_row[c] = token_get(s, token_oov) if s else token_pad
                p = row.path_strs[c]
                path_row[c] = path_get(p, path_oov) if p else path_pad
                t = row.target_strs[c]
                tgt_row[c] = token_get(t, token_oov) if t else token_pad
        mask = context_valid_mask(source, path, target, token_pad, path_pad)
        batch = Batch(source=source, path=path, target=target, mask=mask,
                      label=label, weight=np.ones((n,), dtype=np.float32))
        if not keep_strings:
            return batch
        return batch._replace(
            label_strings=np.array([row.label_str for row in rows],
                                   dtype=object),
            source_strings=np.array([row.source_strs for row in rows],
                                    dtype=object),
            path_strings=np.array([row.path_strs for row in rows],
                                  dtype=object),
            target_strings=np.array([row.target_strs for row in rows],
                                    dtype=object))

    def process_input_rows(self, input_lines: Iterable[str]) -> Batch:
        """Tokenize raw predict lines, canonicalized first."""
        rows = [parse_c2v_line(line, self.config.MAX_CONTEXTS)
                for line in canonicalize_contexts(
                    input_lines, self.config.MAX_CONTEXTS)]
        return self.tokenize_rows(rows)

    # ------------------------------------------------- training, evaluation
    @staticmethod
    def _lines_from_file(path: str) -> Iterator[str]:
        with open(path, 'r') as f:
            for line in f:
                if line.strip():
                    yield line

    def _shuffled(self, lines: Iterable[str],
                  rng: random.Random) -> Iterator[str]:
        """Streaming shuffle buffer of SHUFFLE_BUFFER_SIZE lines."""
        buffer: List[str] = []
        size = self.config.SHUFFLE_BUFFER_SIZE
        for line in lines:
            if len(buffer) < size:
                buffer.append(line)
                continue
            idx = rng.randrange(size)
            yield buffer[idx]
            buffer[idx] = line
        rng.shuffle(buffer)
        yield from buffer

    def tokenize_lines(self, lines: Sequence[str],
                       keep_labels: bool = False) -> Batch:
        """Parse and tokenize a chunk of raw lines into one plane batch,
        without the context strings; ``keep_labels`` keeps the label
        strings (evaluation decodes with them). The native tokenizer
        under READER_USE_NATIVE, else the Python one."""
        tokenizer = self.native_tokenizer()
        if tokenizer is not None:
            batch = tokenizer.tokenize_lines(lines)
            if keep_labels:
                batch = batch._replace(label_strings=np.array(
                    [line.rstrip('\r\n').split(' ', 1)[0]
                     for line in lines], dtype=object))
            return batch
        rows = [parse_c2v_line(line, self.config.MAX_CONTEXTS)
                for line in lines]
        batch = self.tokenize_rows(rows, keep_strings=False)
        if keep_labels:
            batch = batch._replace(label_strings=np.array(
                [row.label_str for row in rows], dtype=object))
        return batch

    def _keep_mask(self, batch: Batch, evaluate: bool) -> np.ndarray:
        """Training keeps rows with an in-vocabulary label and at least one
        valid context; evaluation keeps rows with at least one valid
        context."""
        any_valid = batch.mask.any(axis=1)
        if evaluate:
            return any_valid
        return any_valid & (batch.label > self.vocabs.target_vocab.oov_index)

    @staticmethod
    def _take_rows(batch: Batch, keep) -> Batch:
        return Batch(*[None if field is None else field[keep]
                       for field in batch])

    @staticmethod
    def _concat(parts: List[Batch]) -> Batch:
        if len(parts) == 1:
            return parts[0]
        return Batch(*[None if parts[0][i] is None
                       else np.concatenate([p[i] for p in parts])
                       for i in range(len(parts[0]))])

    def _filtered_batches(self, lines: Iterable[str], batch_size: int,
                          evaluate: bool = False) -> Iterator[Batch]:
        """Parse, tokenize, filter, and emit batches of ``batch_size``
        rows; the last is padded with zero-weight rows."""
        pending: List[Batch] = []
        pending_rows = 0
        chunk: List[str] = []
        chunk_size = max(batch_size, 256)

        def flush_chunk():
            nonlocal pending, pending_rows
            batch = self.tokenize_lines(chunk, keep_labels=evaluate)
            kept = self._take_rows(batch, self._keep_mask(batch, evaluate))
            if kept.label.shape[0]:
                pending.append(kept)
                pending_rows += kept.label.shape[0]
            while pending_rows >= batch_size:
                merged = self._concat(pending)
                yield self._take_rows(merged, slice(None, batch_size))
                rest = self._take_rows(merged, slice(batch_size, None))
                pending = [rest] if rest.label.shape[0] else []
                pending_rows = merged.label.shape[0] - batch_size

        for line in lines:
            chunk.append(line)
            if len(chunk) >= chunk_size:
                yield from flush_chunk()
                chunk = []
        if chunk:
            yield from flush_chunk()
        if pending_rows:
            yield self.pad_batch_to(self._concat(pending), batch_size)

    def iter_epoch(self, seed: Optional[int] = None,
                   evaluate: bool = False,
                   data_path: Optional[str] = None,
                   shuffle: Optional[bool] = None,
                   wire_format: Optional[str] = None) -> Iterator:
        """One pass over the train split
        (``TRAIN_DATA_PATH_PREFIX.train.c2v``, or ``data_path``), shuffled
        with ``seed``, in batches of TRAIN_BATCH_SIZE rows; or, with
        ``evaluate``, over TEST_DATA_PATH (or ``data_path``) in file order,
        in batches of TEST_BATCH_SIZE rows with their label strings.
        ``shuffle`` overrides the order (the token cache builds from an
        unshuffled pass). Batches come on ``wire_format``'s wire
        (BATCH_WIRE_FORMAT by default): plane ``Batch``es or
        ``data/packed.py::PackedBatch``es (one shard, sticky capacity).
        The last batch is padded with zero-weight rows."""
        lines = self._lines_from_file(data_path
                                      or self.config.data_path(evaluate))
        if shuffle is None:
            shuffle = not evaluate
        if shuffle:
            lines = self._shuffled(lines, random.Random(seed))
        batches = self._filtered_batches(lines,
                                         self.config.batch_size(evaluate),
                                         evaluate)
        if (wire_format or self.config.BATCH_WIRE_FORMAT) == 'packed':
            if self._packer is None:
                self._packer = StickyPacker(
                    self.vocabs.token_vocab.pad_index,
                    self.vocabs.path_vocab.pad_index)
            batches = (self._packer.pack_batch(batch) for batch in batches)
        yield from fault_site_batches(batches)

    def iter_epoch_prefetched(self, seed: Optional[int] = None,
                              evaluate: bool = False,
                              data_path: Optional[str] = None) -> Iterator:
        """``iter_epoch`` on a background thread, READER_PREFETCH_BATCHES
        ahead of the consumer."""
        yield from prefetch_iterator(
            lambda: self.iter_epoch(seed=seed, evaluate=evaluate,
                                    data_path=data_path),
            self.config.READER_PREFETCH_BATCHES)

    # --------------------------------------------------------------- padding
    def pad_batch_to(self, batch: Batch, batch_size: int) -> Batch:
        """Pad with zero-weight all-PAD rows up to ``batch_size``."""
        n = batch.label.shape[0]
        if n == batch_size:
            return batch
        pad = batch_size - n

        def pad2(arr, fill):
            return np.concatenate(
                [arr, np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)])

        padded = Batch(
            source=pad2(batch.source, self.vocabs.token_vocab.pad_index),
            path=pad2(batch.path, self.vocabs.path_vocab.pad_index),
            target=pad2(batch.target, self.vocabs.token_vocab.pad_index),
            mask=pad2(batch.mask, 0.0),
            label=pad2(batch.label, 0),
            weight=np.concatenate([batch.weight,
                                   np.zeros((pad,), dtype=np.float32)]))
        if batch.label_strings is not None:
            padded = padded._replace(label_strings=np.concatenate(
                [batch.label_strings, np.full((pad,), '', dtype=object)]))
        if batch.source_strings is not None:
            empty_ctx = np.full((pad, self.config.MAX_CONTEXTS), '',
                                dtype=object)
            padded = padded._replace(
                source_strings=np.concatenate([batch.source_strings,
                                               empty_ctx]),
                path_strings=np.concatenate([batch.path_strings, empty_ctx]),
                target_strings=np.concatenate([batch.target_strings,
                                               empty_ctx]))
        return padded
