"""MovieLens-1M reader creators (reference
python/paddle/dataset/movielens.py).

Sample contract (reference __reader_creator__): [user_id, gender_id,
age_id, job_id, movie_id, category_ids, title_ids, rating]. MovieInfo /
UserInfo metadata classes and the max_*_id helpers match the reference
API. Synthetic fallback: a deterministic preference model (users like
genres hashed near their id), so recommender-system tests converge.
"""
from __future__ import annotations

import os
import re
import zipfile

import numpy as np

from .common import DATA_HOME

__all__ = ["train", "test", "get_movie_title_dict", "max_movie_id",
           "max_user_id", "max_job_id", "age_table", "movie_categories",
           "MovieInfo", "UserInfo"]

age_table = [1, 18, 25, 35, 45, 50, 56]

_N_USERS = 200
_N_MOVIES = 180
_N_JOBS = 21
_CATEGORIES = ["Action", "Comedy", "Drama", "Horror", "Romance",
               "Sci-Fi", "Thriller", "Animation"]
_TITLE_WORDS = ["star", "night", "day", "man", "city", "love", "dark",
                "return", "story", "king", "last", "first"]


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [self.index,
                [movie_categories().get(c, 0) for c in self.categories],
                [get_movie_title_dict().get(w.lower(), 0)
                 for w in self.title.split()]]


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age,
                self.job_id]


def _archive():
    p = os.path.join(DATA_HOME, "movielens", "ml-1m.zip")
    return p if os.path.exists(p) else None


_meta_cache = None


def _meta():
    """Metadata derived from the real archive when present (the
    reference computes maxima/dicts from the loaded data), else the
    synthetic constants."""
    global _meta_cache
    if _meta_cache is not None:
        return _meta_cache
    if _archive() is None:
        _meta_cache = {
            "max_user": _N_USERS, "max_movie": _N_MOVIES,
            "max_job": _N_JOBS - 1,
            "categories": {c: i for i, c in enumerate(_CATEGORIES)},
            "titles": {w: i for i, w in enumerate(_TITLE_WORDS)},
        }
        return _meta_cache
    cats, titles = {}, {}
    max_user = max_movie = max_job = 0
    pat = re.compile(r"(.*)\s+\(\d{4}\)")
    with zipfile.ZipFile(_archive()) as z:
        for line in z.read("ml-1m/movies.dat").decode(
                "latin1").strip().split("\n"):
            mid, title, cs = line.split("::")
            max_movie = max(max_movie, int(mid))
            for c in cs.split("|"):
                cats.setdefault(c, len(cats))
            m = pat.match(title)
            for w in (m.group(1) if m else title).lower().split():
                titles.setdefault(w, len(titles))
        for line in z.read("ml-1m/users.dat").decode(
                "latin1").strip().split("\n"):
            uid, _g, _a, job, _zip = line.split("::")
            max_user = max(max_user, int(uid))
            max_job = max(max_job, int(job))
    _meta_cache = {"max_user": max_user, "max_movie": max_movie,
                   "max_job": max_job, "categories": cats,
                   "titles": titles}
    return _meta_cache


def movie_categories():
    return _meta()["categories"]


def get_movie_title_dict():
    return _meta()["titles"]


def max_movie_id():
    return _meta()["max_movie"]


def max_user_id():
    return _meta()["max_user"]


def max_job_id():
    return _meta()["max_job"]


def _synthetic_samples(n, seed):
    rng = np.random.RandomState(seed)
    cat_dict = movie_categories()
    title_dict = get_movie_title_dict()
    for _ in range(n):
        uid = int(rng.randint(1, _N_USERS + 1))
        mid = int(rng.randint(1, _N_MOVIES + 1))
        gender = int(rng.randint(0, 2))
        age = int(rng.randint(0, len(age_table)))
        job = int(rng.randint(0, _N_JOBS))
        cats = [int(mid % len(cat_dict))]
        title = [int(mid % len(title_dict)),
                 int((mid * 7) % len(title_dict))]
        # deterministic preference: users rate movies near uid mod higher
        affinity = 5.0 - (abs((uid % 7) - (mid % 7)) % 7)
        rating = float(np.clip(affinity + rng.randn() * 0.3, 1.0, 5.0))
        yield [uid, gender, age, job, mid, cats, title, rating]


def _zip_reader(is_train):
    def reader():
        rng = np.random.RandomState(42)
        with zipfile.ZipFile(_archive()) as z:
            ratings = z.read("ml-1m/ratings.dat").decode(
                "latin1").strip().split("\n")
            users, movies = {}, {}
            for line in z.read("ml-1m/users.dat").decode(
                    "latin1").strip().split("\n"):
                uid, gender, age, job, _zip = line.split("::")
                users[int(uid)] = UserInfo(uid, gender, age, job)
            pat = re.compile(r"(.*)\s+\(\d{4}\)")
            for line in z.read("ml-1m/movies.dat").decode(
                    "latin1").strip().split("\n"):
                mid, title, cats = line.split("::")
                m = pat.match(title)
                movies[int(mid)] = MovieInfo(
                    mid, cats.split("|"), m.group(1) if m else title)
            for line in ratings:
                uid, mid, rating, _ts = line.split("::")
                if (rng.rand() < 0.9) != is_train:
                    continue
                u, mv = users.get(int(uid)), movies.get(int(mid))
                if u is None or mv is None:
                    continue
                uv, mv_v = u.value(), mv.value()
                yield uv + [mv_v[0], mv_v[1], mv_v[2], float(rating)]

    return reader


def train():
    if _archive() is not None:
        return _zip_reader(True)
    return lambda: _synthetic_samples(4000, seed=40)


def test():
    if _archive() is not None:
        return _zip_reader(False)
    return lambda: _synthetic_samples(400, seed=41)
