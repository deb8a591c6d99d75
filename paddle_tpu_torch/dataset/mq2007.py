"""MQ2007 learning-to-rank reader creators (reference
python/paddle/dataset/mq2007.py).

Sample contracts (reference Dataset.format): "pointwise" yields
(score float, feature float32[46]); "pairwise" yields (pos_features,
neg_features); "listwise" yields (query_list_of_labels, features).
Synthetic fallback: per-query documents whose relevance is a linear
function of a fixed hidden weight plus noise, deterministic.
"""
from __future__ import annotations

import os

import numpy as np

from .common import DATA_HOME

__all__ = ["train", "test"]

_N_FEATURES = 46


def _synthetic_queries(n_queries, seed):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(7).randn(_N_FEATURES)
    for _ in range(n_queries):
        n_docs = int(rng.randint(4, 10))
        feats = rng.rand(n_docs, _N_FEATURES).astype("float32")
        scores = feats @ w + rng.randn(n_docs) * 0.1
        rel = np.clip(np.digitize(scores, np.percentile(
            scores, [50, 80])), 0, 2)
        yield rel.astype("float32"), feats


def _reader_creator(format, n_queries, seed):
    def pointwise():
        for rel, feats in _synthetic_queries(n_queries, seed):
            for r, f in zip(rel, feats):
                yield float(r), f

    def pairwise():
        for rel, feats in _synthetic_queries(n_queries, seed):
            order = np.argsort(-rel)
            for i in order:
                for j in order:
                    if rel[i] > rel[j]:
                        yield feats[i], feats[j]

    def listwise():
        for rel, feats in _synthetic_queries(n_queries, seed):
            yield list(rel), feats

    return {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise}[format]


def train(format="pairwise"):
    d = os.path.join(DATA_HOME, "MQ2007")
    if os.path.exists(os.path.join(d, "MQ2007.rar")):
        raise NotImplementedError(
            "real MQ2007 .rar parsing is not supported offline; remove "
            "%s to use the synthetic reader" % d)
    return _reader_creator(format, 120, seed=100)


def test(format="pairwise"):
    return _reader_creator(format, 24, seed=101)
