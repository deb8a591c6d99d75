"""WMT16 en-de reader creators (reference
python/paddle/dataset/wmt16.py).

Sample contract: (src_ids, trg_ids, trg_ids_next) with per-language
dict sizes and <s>/<e>/<unk> = 0/1/2. Synthetic fallback mirrors
wmt14's toy translation with distinct vocab sizes per side.
"""
from __future__ import annotations

import os
import tarfile

import numpy as np

from .common import DATA_HOME

__all__ = ["train", "test", "validation", "get_dict"]

UNK_IDX = 2


def _archive():
    p = os.path.join(DATA_HOME, "wmt16", "wmt16.tar.gz")
    return p if os.path.exists(p) else None


def _synthetic_pairs(n, seed, src_size, trg_size):
    rng = np.random.RandomState(seed)
    s_usable = max(4, min(src_size, 40) - 3)
    t_usable = max(4, min(trg_size, 40) - 3)
    for _ in range(n):
        length = int(rng.randint(3, 9))
        src = [int(rng.randint(3, 3 + s_usable)) for _ in range(length)]
        trg = [3 + ((t - 3 + 2) % t_usable) for t in src]
        yield src, [0] + trg, trg + [1]


def _reader(split, src_dict_size, trg_dict_size, src_lang, n, seed):
    def reader():
        if _archive() is None:
            yield from _synthetic_pairs(n, seed, src_dict_size,
                                        trg_dict_size)
            return
        src_dict = get_dict(src_lang, src_dict_size, reverse=False)
        trg_lang = "de" if src_lang == "en" else "en"
        trg_dict = get_dict(trg_lang, trg_dict_size, reverse=False)
        with tarfile.open(_archive(), mode="r") as f:
            name = next(n2 for n2 in f.getnames() if split in n2)
            for line in f.extractfile(name):
                cols = line.decode("utf-8").strip().split("\t")
                if len(cols) != 2:
                    continue
                src_col = 0 if src_lang == "en" else 1
                src = [src_dict.get(w, UNK_IDX)
                       for w in cols[src_col].split()]
                trg = [trg_dict.get(w, UNK_IDX)
                       for w in cols[1 - src_col].split()]
                yield src, [0] + trg, trg + [1]

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader("train", src_dict_size, trg_dict_size, src_lang,
                   2000, seed=70)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader("test", src_dict_size, trg_dict_size, src_lang,
                   200, seed=71)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _reader("val", src_dict_size, trg_dict_size, src_lang,
                   200, seed=72)


def get_dict(lang, dict_size, reverse=False):
    if _archive() is not None:
        with tarfile.open(_archive(), mode="r") as f:
            name = next(n for n in f.getnames()
                        if ("vocab_%s" % lang) in n)
            d = {"<s>": 0, "<e>": 1, "<unk>": 2}
            for line in f.extractfile(name):
                if len(d) >= dict_size:
                    break
                d[line.decode("utf-8").strip()] = len(d)
    else:
        usable = max(4, min(dict_size, 40))
        d = {"<s>": 0, "<e>": 1, "<unk>": 2}
        for i in range(3, usable):
            d["%s%d" % (lang, i)] = i
    if reverse:
        d = {v: k for k, v in d.items()}
    return d
