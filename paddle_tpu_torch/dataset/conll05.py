"""CoNLL-2005 SRL reader creators (reference
python/paddle/dataset/conll05.py).

Sample contract (reference reader_creator): 9-slot tuple
(word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb_ids, mark, label
_ids) — the 5 context windows around the predicate, the predicate id
broadcast over the sentence, the predicate mark, and per-token BIO
label ids. Synthetic fallback: template sentences with one verb and
B-A0/B-A1 arguments, deterministic.
"""
from __future__ import annotations

import os

import numpy as np

from .common import DATA_HOME

__all__ = ["get_dict", "get_embedding", "test"]

_WORDS = ["the", "cat", "dog", "man", "woman", "ball", "saw", "hit",
          "gave", "took", "red", "big", "park", "home"]
_VERBS = ["saw", "hit", "gave", "took"]
_LABELS = ["O", "B-A0", "I-A0", "B-A1", "I-A1", "B-V"]


def get_dict():
    """(word_dict, verb_dict, label_dict)."""
    word_dict = {w: i for i, w in enumerate(_WORDS)}
    word_dict["<unk>"] = len(word_dict)
    verb_dict = {v: i for i, v in enumerate(_VERBS)}
    label_dict = {l: i for i, l in enumerate(_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Deterministic stand-in for the downloaded emb file."""
    word_dict, _, _ = get_dict()
    rng = np.random.RandomState(99)
    return rng.rand(len(word_dict), 32).astype("float32")


def _synthetic_sentences(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        subj = _WORDS[rng.randint(0, 6)]
        verb = _VERBS[rng.randint(0, len(_VERBS))]
        obj = _WORDS[rng.randint(0, 6)]
        words = ["the", subj, verb, "the", obj]
        labels = ["B-A0", "I-A0", "B-V", "B-A1", "I-A1"]
        yield words, verb, 2, labels


def reader_creator(n=200, seed=80):
    word_dict, verb_dict, label_dict = get_dict()
    unk = word_dict["<unk>"]

    def reader():
        for words, verb, vidx, labels in _synthetic_sentences(n, seed):
            ids = [word_dict.get(w, unk) for w in words]
            L = len(ids)

            def ctx(off):
                j = vidx + off
                return [ids[j] if 0 <= j < L else unk] * L

            verb_ids = [verb_dict[verb]] * L
            mark = [1 if i == vidx else 0 for i in range(L)]
            label_ids = [label_dict[l] for l in labels]
            yield (ids, ctx(-2), ctx(-1), ctx(0), ctx(1), ctx(2),
                   verb_ids, mark, label_ids)

    return reader


def test():
    d = os.path.join(DATA_HOME, "conll05st")
    if os.path.exists(os.path.join(d, "conll05st-tests.tar.gz")):
        raise NotImplementedError(
            "real conll05 archive parsing is not supported offline; "
            "remove %s to use the synthetic reader" % d)
    return reader_creator(200, seed=80)
