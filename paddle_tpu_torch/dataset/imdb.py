"""IMDB sentiment reader creators (reference
python/paddle/dataset/imdb.py).

Sample contract: (list of word ids, label 0/1). ``word_idx`` maps word
-> id with '<unk>' as the last id, exactly like the reference
build_dict. Synthetic fallback: a small sentiment grammar over a fixed
vocabulary (positive/negative keyword mixtures), deterministic and
separable.
"""
from __future__ import annotations

import os
import re
import tarfile

import numpy as np

from .common import DATA_HOME

__all__ = ["build_dict", "train", "test", "word_dict"]

_POS = ["good", "great", "excellent", "wonderful", "best", "love",
        "superb", "amazing"]
_NEG = ["bad", "awful", "terrible", "worst", "boring", "hate", "poor",
        "dull"]
_FILL = ["movie", "film", "plot", "actor", "scene", "story", "the", "a",
         "it", "was", "very", "really"]


def _archive():
    p = os.path.join(DATA_HOME, "imdb", "aclImdb_v1.tar.gz")
    return p if os.path.exists(p) else None


def _tokenize(text):
    return re.sub(r"[^a-z0-9 ]", " ", text.lower()).split()


def _archive_docs(pattern):
    tar = _archive()
    assert tar is not None
    with tarfile.open(tar, mode="r") as f:
        for name in sorted(f.getnames()):
            if bool(pattern.match(name)):
                yield _tokenize(
                    f.extractfile(name).read().decode("utf-8",
                                                      errors="ignore"))


def _synthetic_docs(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        label = int(rng.randint(0, 2))
        keywords = _POS if label == 0 else _NEG
        words = []
        for _ in range(int(rng.randint(8, 20))):
            src = keywords if rng.rand() < 0.4 else _FILL
            words.append(src[rng.randint(0, len(src))])
        yield words, label


def build_dict(pattern=None, cutoff=0):
    """word -> id, '<unk>' last (reference imdb.py build_dict)."""
    from collections import Counter

    counts = Counter()
    if _archive() is not None and pattern is not None:
        for words in _archive_docs(pattern):
            counts.update(words)
    else:
        for words, _ in _synthetic_docs(2000, seed=20):
            counts.update(words)
    counts = {w: c for w, c in counts.items() if c > cutoff}
    ordered = sorted(counts.items(), key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(ordered)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def word_dict():
    return build_dict(re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"))


def _reader_creator(word_idx, is_train, n, seed):
    unk = word_idx["<unk>"]

    def reader():
        tar = _archive()
        if tar is not None:
            sub = "train" if is_train else "test"
            for senti, label in (("pos", 0), ("neg", 1)):
                pat = re.compile(
                    r"aclImdb/%s/%s/.*\.txt$" % (sub, senti))
                for words in _archive_docs(pat):
                    yield [word_idx.get(w, unk) for w in words], label
        else:
            for words, label in _synthetic_docs(n, seed):
                yield [word_idx.get(w, unk) for w in words], label

    return reader


def train(word_idx):
    return _reader_creator(word_idx, True, 2000, seed=21)


def test(word_idx):
    return _reader_creator(word_idx, False, 400, seed=22)
