"""Vocabularies for tokens / paths / targets, built from the same
``<data>.dict.c2v`` frequency dictionaries as ``code2vec_tpu/vocab.py``
with the same PAD/OOV index policy, so both packages map every word to
the same index. A saved model keeps them in the ``dictionaries.bin``
sidecar beside it, in the reference's byte layout, so either package
loads the other's."""
from __future__ import annotations

import hashlib
import logging
import os
import pickle
from enum import Enum
from types import SimpleNamespace
from typing import Dict, Iterable, NamedTuple, Optional

import numpy as np

from code2vec_tpu_torch import common
from code2vec_tpu_torch.config import Config


class VocabType(Enum):
    Token = 1
    Target = 2
    Path = 3


SpecialWords = SimpleNamespace

# Special-word policies (reference vocabularies.py:22-35).
SPECIAL_WORDS_ONLY_OOV = SimpleNamespace(OOV='<OOV>')
SPECIAL_WORDS_SEPARATE_OOV_PAD = SimpleNamespace(PAD='<PAD>', OOV='<OOV>')
SPECIAL_WORDS_JOINED_OOV_PAD = SimpleNamespace(
    PAD_OR_OOV='<PAD_OR_OOV>', PAD='<PAD_OR_OOV>', OOV='<PAD_OR_OOV>')


class Vocab:
    def __init__(self, vocab_type: VocabType, words: Iterable[str],
                 special_words: Optional[SpecialWords] = None):
        if special_words is None:
            special_words = SimpleNamespace()
        self.vocab_type = vocab_type
        self.special_words = special_words
        self.word_to_index: Dict[str, int] = {}
        self.index_to_word: Dict[int, str] = {}
        for index, word in enumerate(
                common.get_unique_list(special_words.__dict__.values())):
            self.word_to_index[word] = index
            self.index_to_word[index] = word
        for word in words:
            if word in self.word_to_index:
                continue
            index = len(self.word_to_index)
            self.word_to_index[word] = index
            self.index_to_word[index] = word
        self.size = len(self.word_to_index)

    @property
    def oov_index(self) -> int:
        return self.word_to_index[self.special_words.OOV]

    @property
    def pad_index(self) -> int:
        return self.word_to_index[self.special_words.PAD]

    def index_to_word_array(self) -> np.ndarray:
        """Dense object-array of words, index-addressable, for decoding
        top-k indices on the host."""
        arr = np.empty(self.size, dtype=object)
        for idx, word in self.index_to_word.items():
            arr[idx] = word
        return arr

    def save_to_file(self, file) -> None:
        """The reference's layout: ``word_to_index``, ``index_to_word``
        and the size, special words stripped, as three sequential
        pickles."""
        specials = common.get_unique_list(self.special_words.__dict__.values())
        nr_special = len(specials)
        word_to_index = {w: i for w, i in self.word_to_index.items()
                         if i >= nr_special}
        index_to_word = {i: w for i, w in self.index_to_word.items()
                         if i >= nr_special}
        pickle.dump(word_to_index, file)
        pickle.dump(index_to_word, file)
        pickle.dump(self.size - nr_special, file)

    @classmethod
    def load_from_file(cls, vocab_type: VocabType, file,
                       special_words: SpecialWords) -> 'Vocab':
        """The reference's layout, special words re-added at the low
        indices."""
        specials = common.get_unique_list(special_words.__dict__.values())
        word_to_index = pickle.load(file)
        index_to_word = pickle.load(file)
        size_wo_specials = pickle.load(file)
        if not len(index_to_word) == len(word_to_index) == size_wo_specials:
            raise ValueError('Stored vocabulary %s is inconsistent: %d words, '
                             '%d indices, size %d'
                             % (vocab_type, len(word_to_index),
                                len(index_to_word), size_wo_specials))
        if not index_to_word:
            raise ValueError('Stored vocabulary %s is empty.' % vocab_type)
        min_idx = min(index_to_word.keys())
        if min_idx != len(specials):
            raise ValueError(
                'Stored vocabulary {} has minimum word index {}, expected {} '
                'special words {}. Check config.SEPARATE_OOV_AND_PAD.'.format(
                    vocab_type, min_idx, len(specials), specials))
        vocab = cls(vocab_type, [], special_words)
        vocab.word_to_index = {**word_to_index,
                               **{w: i for i, w in enumerate(specials)}}
        vocab.index_to_word = {**index_to_word,
                               **{i: w for i, w in enumerate(specials)}}
        vocab.size = size_wo_specials + len(specials)
        return vocab

    @classmethod
    def create_from_freq_dict(cls, vocab_type: VocabType,
                              word_to_count: Dict[str, int], max_size: int,
                              special_words: Optional[SpecialWords] = None
                              ) -> 'Vocab':
        """Top-``max_size`` words by count, ties in dict order."""
        words = sorted(word_to_count, key=word_to_count.get, reverse=True)
        return cls(vocab_type, words[:max_size], special_words)


class WordFreqDicts(NamedTuple):
    token_to_count: Dict[str, int]
    path_to_count: Dict[str, int]
    target_to_count: Dict[str, int]


def load_word_freq_dict(path: str) -> WordFreqDicts:
    """Load the ``.dict.c2v`` written by preprocessing: sequential
    pickles of the token, path and target frequency dicts."""
    with open(path, 'rb') as file:
        token_to_count = pickle.load(file)
        path_to_count = pickle.load(file)
        target_to_count = pickle.load(file)
    return WordFreqDicts(token_to_count=token_to_count,
                         path_to_count=path_to_count,
                         target_to_count=target_to_count)


class SizeOnlyVocab:
    """A vocabulary of which only the size is known. ``pad_index`` is 0,
    the index the reference's backend falls back to for its
    ``SizeOnlyVocab`` (``code2vec_tpu/models/backends.py``)."""

    pad_index = 0

    def __init__(self, size: int):
        self.size = size


class SizeOnlyVocabs:
    """Vocab stand-in carrying only sizes — for the benchmark harness
    (``benchlib.py``) and tests, where no dataset exists."""

    def __init__(self, token: int, path: int, target: int):
        self.token_vocab = SizeOnlyVocab(token)
        self.path_vocab = SizeOnlyVocab(path)
        self.target_vocab = SizeOnlyVocab(target)


class Code2VecVocabs:
    """The {token, path, target} vocabulary triple: from the
    ``dictionaries.bin`` beside MODEL_LOAD_PATH when loading a model,
    else from ``config.word_freq_dict_path``."""

    def __init__(self, config: Config):
        self.config = config
        self._already_saved_in_paths = set()
        if config.is_loading:
            self._load_from_path(config.get_vocabularies_path_from_model_path(
                config.MODEL_LOAD_PATH))
        else:
            self._create_from_word_freq_dict()

    def content_hash(self) -> str:
        """SHA-256 of the three index-ordered word lists (the reference's
        ``Code2VecVocabs.content_hash``, the same digest): what the token
        cache's fingerprint holds, so a cache built under other
        vocabularies of the same sizes is rebuilt."""
        digest = hashlib.sha256()
        for vocab in (self.token_vocab, self.path_vocab, self.target_vocab):
            lookup = vocab.index_to_word.get
            words = '\x00'.join(lookup(i, '') for i in range(vocab.size))
            digest.update(words.encode('utf-8', 'surrogatepass'))
            digest.update(b'\x01')
        return digest.hexdigest()

    def _load_from_path(self, load_path: str) -> None:
        if not os.path.isfile(load_path):
            raise ValueError(
                'Model dictionaries file not found: `{}`.'.format(load_path))
        with open(load_path, 'rb') as file:
            # stored order: token, target, path
            self.token_vocab = Vocab.load_from_file(
                VocabType.Token, file, self._special_words_for(VocabType.Token))
            self.target_vocab = Vocab.load_from_file(
                VocabType.Target, file,
                self._special_words_for(VocabType.Target))
            self.path_vocab = Vocab.load_from_file(
                VocabType.Path, file, self._special_words_for(VocabType.Path))
        self._already_saved_in_paths.add(load_path)
        logging.getLogger(__name__).info(
            'Loaded vocabularies from %s: token %d, path %d, target %d',
            load_path, self.token_vocab.size, self.path_vocab.size,
            self.target_vocab.size)

    def _create_from_word_freq_dict(self) -> None:
        config = self.config
        freq_dicts = load_word_freq_dict(config.word_freq_dict_path)
        self.token_vocab = Vocab.create_from_freq_dict(
            VocabType.Token, freq_dicts.token_to_count,
            config.MAX_TOKEN_VOCAB_SIZE,
            special_words=self._special_words_for(VocabType.Token))
        self.path_vocab = Vocab.create_from_freq_dict(
            VocabType.Path, freq_dicts.path_to_count,
            config.MAX_PATH_VOCAB_SIZE,
            special_words=self._special_words_for(VocabType.Path))
        self.target_vocab = Vocab.create_from_freq_dict(
            VocabType.Target, freq_dicts.target_to_count,
            config.MAX_TARGET_VOCAB_SIZE,
            special_words=self._special_words_for(VocabType.Target))
        logging.getLogger(__name__).info(
            'Created vocabularies: token %d, path %d, target %d',
            self.token_vocab.size, self.path_vocab.size,
            self.target_vocab.size)

    def _special_words_for(self, vocab_type: VocabType) -> SpecialWords:
        if not self.config.SEPARATE_OOV_AND_PAD:
            return SPECIAL_WORDS_JOINED_OOV_PAD
        if vocab_type == VocabType.Target:
            return SPECIAL_WORDS_ONLY_OOV
        return SPECIAL_WORDS_SEPARATE_OOV_PAD

    def save(self, save_path: str) -> None:
        """Write the ``dictionaries.bin`` sidecar (once per path)."""
        if save_path in self._already_saved_in_paths:
            return
        with open(save_path, 'wb') as file:
            self.token_vocab.save_to_file(file)
            self.target_vocab.save_to_file(file)
            self.path_vocab.save_to_file(file)
        self._already_saved_in_paths.add(save_path)

    def get(self, vocab_type: VocabType) -> Vocab:
        return {VocabType.Token: self.token_vocab,
                VocabType.Target: self.target_vocab,
                VocabType.Path: self.path_vocab}[vocab_type]
