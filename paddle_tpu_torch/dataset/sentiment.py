"""Movie-review sentiment reader creators (reference
python/paddle/dataset/sentiment.py — NLTK movie_reviews based).

Sample contract: (word_ids, label 0/1). Offline: reuses the imdb
synthetic grammar with the sentiment module's API (get_word_dict,
train, test).
"""
from __future__ import annotations

from . import imdb

__all__ = ["get_word_dict", "train", "test"]

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000

_word_dict = None


def get_word_dict():
    global _word_dict
    if _word_dict is None:
        _word_dict = imdb.build_dict()
    return _word_dict


def train():
    wd = get_word_dict()
    return imdb._reader_creator(wd, True, NUM_TRAINING_INSTANCES, seed=23)


def test():
    wd = get_word_dict()
    return imdb._reader_creator(
        wd, False, NUM_TOTAL_INSTANCES - NUM_TRAINING_INSTANCES, seed=24)
