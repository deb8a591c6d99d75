"""PTB language-model reader creators (reference
python/paddle/dataset/imikolov.py).

Sample contract: ``NGRAM`` mode yields n-gram id tuples; ``SEQ`` mode
yields (cur_ids, next_ids). '<s>', '<e>', '<unk>' special tokens match
the reference. Synthetic fallback: sentences from a tiny Markov
grammar, deterministic.
"""
from __future__ import annotations

import os
import tarfile

import numpy as np

from .common import DATA_HOME

__all__ = ["build_dict", "train", "test", "NGRAM", "SEQ"]


class DataType:
    NGRAM = 1
    SEQ = 2


NGRAM = DataType.NGRAM
SEQ = DataType.SEQ

_WORDS = ["cat", "dog", "runs", "sleeps", "fast", "slow", "big",
          "small", "house", "tree", "sees", "the"]


def _archive():
    p = os.path.join(DATA_HOME, "imikolov",
                     "simple-examples.tgz")
    return p if os.path.exists(p) else None


def _sentences_from_archive(path_suffix):
    with tarfile.open(_archive(), mode="r") as f:
        names = [n for n in f.getnames() if n.endswith(path_suffix)]
        for name in names:
            for line in f.extractfile(name):
                yield line.decode("utf-8").strip().split()


def _synthetic_sentences(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        length = int(rng.randint(3, 8))
        words = ["the"]
        for _ in range(length):
            # Markov-ish: noun -> verb -> adverb
            words.append(_WORDS[rng.randint(0, len(_WORDS))])
        yield words


def build_dict(min_word_freq=50):
    from collections import Counter

    counts = Counter()
    if _archive() is not None:
        for words in _sentences_from_archive("ptb.train.txt"):
            counts.update(words)
        counts = {w: c for w, c in counts.items()
                  if c > min_word_freq and w != "<unk>"}
    else:
        for words in _synthetic_sentences(500, seed=30):
            counts.update(words)
        counts = dict(counts)
    ordered = sorted(counts.items(), key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(ordered)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def _reader_creator(word_idx, n, data_type, is_train, synth_n, seed):
    def reader():
        unk = word_idx["<unk>"]
        if _archive() is not None:
            suffix = "ptb.train.txt" if is_train else "ptb.valid.txt"
            sents = _sentences_from_archive(suffix)
        else:
            sents = _synthetic_sentences(synth_n, seed)
        for words in sents:
            if DataType.NGRAM == data_type:
                assert n > -1, "Invalid gram length"
                words = ["<s>"] + words + ["<e>"]
                if len(words) >= n:
                    ids = [word_idx.get(w, unk) for w in words]
                    for i in range(n, len(ids) + 1):
                        yield tuple(ids[i - n:i])
            elif DataType.SEQ == data_type:
                ids = [word_idx.get(w, unk) for w in words]
                src = [word_idx.get("<s>", unk)] + ids
                trg = ids + [word_idx.get("<e>", unk)]
                yield src, trg
            else:
                raise ValueError("Unsupported DataType %s" % data_type)

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader_creator(word_idx, n, data_type, True, 500, seed=30)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader_creator(word_idx, n, data_type, False, 100, seed=31)
