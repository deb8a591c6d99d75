"""WMT14 en-fr reader creators (reference
python/paddle/dataset/wmt14.py).

Sample contract: (src_ids, trg_ids, trg_ids_next) with <s>/<e>/<unk>
at ids 0/1/2 (reference constants). Synthetic fallback: a reversible
toy translation (target = per-token mapped source), deterministic and
learnable by seq2seq book tests.
"""
from __future__ import annotations

import os
import tarfile

import numpy as np

from .common import DATA_HOME

__all__ = ["train", "test", "get_dict"]

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2

_SRC_VOCAB = 30
_TRG_VOCAB = 30


def _archive():
    p = os.path.join(DATA_HOME, "wmt14", "wmt14.tgz")
    return p if os.path.exists(p) else None


def _synthetic_pairs(n, seed, dict_size):
    rng = np.random.RandomState(seed)
    usable = max(4, min(dict_size, _SRC_VOCAB) - 3)
    for _ in range(n):
        length = int(rng.randint(3, 9))
        src = [int(rng.randint(3, 3 + usable)) for _ in range(length)]
        # toy translation: shift each token by 1 inside the usable band
        trg = [3 + ((t - 3 + 1) % usable) for t in src]
        yield src, [0] + trg, trg + [1]  # (src, <s>+trg, trg+<e>)


def _reader_creator(tar_file, file_name, dict_size):
    def reader():
        src_dict, trg_dict = __read_dicts__(tar_file, dict_size)
        with tarfile.open(tar_file, mode="r") as f:
            names = [n for n in f.getnames() if file_name in n]
            for name in names:
                for line in f.extractfile(name):
                    cols = line.decode("utf-8").strip().split("\t")
                    if len(cols) != 2:
                        continue
                    src = [src_dict.get(w, UNK_IDX)
                           for w in cols[0].split()]
                    trg = [trg_dict.get(w, UNK_IDX)
                           for w in cols[1].split()]
                    yield src, [0] + trg, trg + [1]

    return reader


def __read_dicts__(tar_file, dict_size):
    with tarfile.open(tar_file, mode="r") as f:
        def load(name):
            d = {START: 0, END: 1, UNK: 2}
            for i, line in enumerate(f.extractfile(name)):
                if len(d) >= dict_size:
                    break
                d[line.decode("utf-8").strip()] = len(d)
            return d

        names = f.getnames()
        src = next(n for n in names if "src.dict" in n)
        trg = next(n for n in names if "trg.dict" in n)
        return load(src), load(trg)


def train(dict_size):
    if _archive() is not None:
        return _reader_creator(_archive(), "train/train", dict_size)
    return lambda: _synthetic_pairs(2000, seed=60, dict_size=dict_size)


def test(dict_size):
    if _archive() is not None:
        return _reader_creator(_archive(), "test/test", dict_size)
    return lambda: _synthetic_pairs(200, seed=61, dict_size=dict_size)


def get_dict(dict_size, reverse=True):
    """id<->word dicts; synthetic mode uses 'w<i>' tokens."""
    if _archive() is not None:
        src, trg = __read_dicts__(_archive(), dict_size)
    else:
        usable = max(4, min(dict_size, _SRC_VOCAB))
        src = {START: 0, END: 1, UNK: 2}
        for i in range(3, usable):
            src["w%d" % i] = i
        trg = dict(src)
    if reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg
