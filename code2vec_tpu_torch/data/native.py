"""ctypes binding of the native C++ tokenizer (``native/tokenizer.cpp`` at
the root of the checkout): the port's own copy of
``code2vec_tpu/data/native.py``.

The shared library is built with g++ at first use into the gitignored
``build/native/`` (``hostbuild.py``: a temporary name renamed under a
lock, so a killed or concurrent build never leaves a torn library), and
rebuilt when the source is newer. Nothing falls back quietly: with READER_USE_NATIVE set,
a build or load that fails raises with g++'s output; READER_USE_NATIVE=
False is the one way to get the Python tokenizer. ctypes releases the GIL
while the tokenizer runs, so the prefetch thread tokenizes beside the
thread that launches the steps.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence

import numpy as np

from code2vec_tpu_torch import hostbuild

SOURCE = os.path.join(hostbuild.REPO_ROOT, 'native', 'tokenizer.cpp')
LIBRARY = os.path.join(hostbuild.BUILD_DIR, 'native', 'libc2vtok.so')
GXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC', '-pthread')

_TOKEN, _PATH, _TARGET = 0, 1, 2

_lib_lock = threading.Lock()
_libs = {}
_tokenizers_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The tokenizer's library (SOURCE built into LIBRARY when missing or
    older than the source). A failed build or load raises and names
    READER_USE_NATIVE."""
    source, library = SOURCE, LIBRARY
    with _lib_lock:
        lib = _libs.get(library)
        if lib is not None:
            return lib
        try:
            hostbuild.build(library, source, GXX_FLAGS)
            lib = ctypes.CDLL(library)
        except (hostbuild.BuildError, OSError) as exc:
            raise RuntimeError(
                'the native tokenizer (%s) did not build or load; '
                'READER_USE_NATIVE=False selects the Python tokenizer '
                'instead: %s' % (source, exc))
        lib.c2v_tok_create.restype = ctypes.c_void_p
        lib.c2v_tok_destroy.argtypes = [ctypes.c_void_p]
        lib.c2v_tok_add_words.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.c2v_tok_set_special.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.c2v_tok_tokenize.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
        _libs[library] = lib
        return lib


def get_tokenizer(vocabs, config) -> 'NativeTokenizer':
    """One tokenizer per vocabulary object and MAX_CONTEXTS: building one
    copies every word into the C++ hash maps (tens of MB at java14m
    size). The cache lives on the vocabulary object and dies with it."""
    with _tokenizers_lock:
        cache = getattr(vocabs, '_native_tokenizer_cache', None)
        if cache is None:
            cache = {}
            vocabs._native_tokenizer_cache = cache
        tokenizer = cache.get(config.MAX_CONTEXTS)
        if tokenizer is None:
            tokenizer = NativeTokenizer(vocabs, config)
            cache[config.MAX_CONTEXTS] = tokenizer
        return tokenizer


def _i32_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeTokenizer:
    """The vocabularies live in C++; ``tokenize_lines`` gives the arrays
    of the Python tokenizer (``reader.py::PathContextReader.
    tokenize_rows``), bit for bit, without strings."""

    def __init__(self, vocabs, config):
        from code2vec_tpu_torch.data.reader import Batch
        self._batch = Batch
        self.config = config
        self.lib = load()
        self.handle = ctypes.c_void_p(self.lib.c2v_tok_create())
        self.num_threads = max(1, config.READER_NUM_PARALLEL_BATCHES)
        for vocab_id, vocab in ((_TOKEN, vocabs.token_vocab),
                                (_PATH, vocabs.path_vocab),
                                (_TARGET, vocabs.target_vocab)):
            words = list(vocab.word_to_index.keys())
            # keys() and values() iterate in the same order
            indices = np.fromiter(vocab.word_to_index.values(),
                                  dtype=np.int32, count=len(words))
            blob = '\n'.join(words).encode('utf-8')
            self.lib.c2v_tok_add_words(self.handle, vocab_id, blob,
                                       len(blob), _i32_ptr(indices),
                                       len(words))
            # the target vocabulary of SEPARATE_OOV_AND_PAD has no PAD
            pad = getattr(vocab.special_words, 'PAD', None)
            pad_index = (vocab.word_to_index[pad] if pad is not None
                         else vocab.oov_index)
            self.lib.c2v_tok_set_special(self.handle, vocab_id,
                                         vocab.oov_index, pad_index)

    def __del__(self):
        handle = getattr(self, 'handle', None)
        if handle:
            self.lib.c2v_tok_destroy(handle)
            self.handle = None

    def tokenize_lines(self, lines: Sequence[str]):
        """Raw ``label src,path,tgt ...`` lines -> one plane ``Batch``
        (weights 1, no strings)."""
        n = len(lines)
        max_contexts = self.config.MAX_CONTEXTS
        encoded = [line.encode('utf-8') for line in lines]
        blob = b'\n'.join(encoded)
        # offsets[i] = byte start of line i; the slice [off[i], off[i+1])
        # includes the '\n' separator, which the C++ side strips
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(e) + 1 for e in encoded], out=offsets[1:])
        offsets[n] = len(blob)
        source = np.empty((n, max_contexts), dtype=np.int32)
        path = np.empty((n, max_contexts), dtype=np.int32)
        target = np.empty((n, max_contexts), dtype=np.int32)
        mask = np.empty((n, max_contexts), dtype=np.float32)
        label = np.empty((n,), dtype=np.int32)
        self.lib.c2v_tok_tokenize(
            self.handle, blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, max_contexts, self.num_threads,
            _i32_ptr(source), _i32_ptr(path), _i32_ptr(target),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _i32_ptr(label))
        return self._batch(source=source, path=path, target=target,
                           mask=mask, label=label,
                           weight=np.ones((n,), dtype=np.float32))
