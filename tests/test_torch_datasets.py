"""The port's ``dataset`` readers against the JAX package's, on the CPU:
each reader's first samples and each dictionary equal, value for value
and type for type; the cache plumbing (``PADDLE_TPU_DATA_HOME`` layout,
md5 checks, ``download`` serving from the cache only); the image
transforms on a seeded image."""
import itertools

import numpy as np
import pytest

from paddle_tpu import dataset as jds
from paddle_tpu_torch import dataset as pds

FIRST = 8

READERS = {
    "mnist.train": lambda d: d.mnist.train(),
    "mnist.test": lambda d: d.mnist.test(),
    "uci_housing.train": lambda d: d.uci_housing.train(),
    "uci_housing.test": lambda d: d.uci_housing.test(),
    "cifar.train10": lambda d: d.cifar.train10(),
    "cifar.test100": lambda d: d.cifar.test100(),
    "imdb.train": lambda d: d.imdb.train(d.imdb.word_dict()),
    "imdb.test": lambda d: d.imdb.test(d.imdb.word_dict()),
    "imikolov.ngram": lambda d: d.imikolov.train(d.imikolov.build_dict(), 5),
    "imikolov.seq": lambda d: d.imikolov.test(d.imikolov.build_dict(), 5,
                                              d.imikolov.SEQ),
    "movielens.train": lambda d: d.movielens.train(),
    "movielens.test": lambda d: d.movielens.test(),
    "flowers.train": lambda d: d.flowers.train(),
    "wmt14.train": lambda d: d.wmt14.train(30000),
    "wmt16.train": lambda d: d.wmt16.train(100, 120),
    "wmt16.validation": lambda d: d.wmt16.validation(100, 120, "de"),
    "conll05.test": lambda d: d.conll05.test(),
    "voc2012.train": lambda d: d.voc2012.train(),
    "sentiment.train": lambda d: d.sentiment.train(),
    "mq2007.pairwise": lambda d: d.mq2007.train(),
    "mq2007.listwise": lambda d: d.mq2007.test("listwise"),
}


def _same(a, b, where):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, "%s[%d]" % (where, i))
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("name", sorted(READERS))
def test_first_samples_are_the_jax_package_s(name):
    want = list(itertools.islice(READERS[name](jds)(), FIRST))
    got = list(itertools.islice(READERS[name](pds)(), FIRST))
    assert len(got) == len(want) > 0
    _same(got, want, name)


def test_dictionaries_and_tables_are_the_jax_package_s():
    for get in (lambda d: d.imdb.word_dict(),
                lambda d: d.imikolov.build_dict(),
                lambda d: d.conll05.get_dict(),
                lambda d: d.sentiment.get_word_dict(),
                lambda d: d.wmt14.get_dict(30000),
                lambda d: d.wmt16.get_dict("en", 100),
                lambda d: d.movielens.get_movie_title_dict(),
                lambda d: d.movielens.movie_categories(),
                lambda d: (d.movielens.max_user_id(),
                           d.movielens.max_movie_id(),
                           d.movielens.max_job_id(), d.movielens.age_table)):
        assert get(pds) == get(jds)
    np.testing.assert_array_equal(pds.conll05.get_embedding(),
                                  jds.conll05.get_embedding())


def test_download_serves_the_cache_only(tmp_path, monkeypatch):
    monkeypatch.setattr(pds.common, "DATA_HOME", str(tmp_path))
    url = "https://example.invalid/data/file.bin"
    with pytest.raises(RuntimeError, match="no network egress"):
        pds.common.download(url, "mod")
    assert (tmp_path / "mod").is_dir()  # the cache layout is made
    (tmp_path / "mod" / "file.bin").write_bytes(b"payload")
    md5 = pds.common.md5file(str(tmp_path / "mod" / "file.bin"))
    assert md5 == jds.common.md5file(str(tmp_path / "mod" / "file.bin"))
    assert pds.common.download(url, "mod", md5) == str(
        tmp_path / "mod" / "file.bin")
    with pytest.raises(RuntimeError, match="not cached"):
        pds.common.download(url, "mod", "0" * 32)
    assert pds.common.cached_path("mod", "file.bin") is not None
    assert pds.common.cached_path("mod", "other.bin") is None
    cyc = pds.common.cycled(lambda: iter([1, 2]))
    assert list(itertools.islice(cyc(), 5)) == [1, 2, 1, 2, 1]


def test_image_transforms_are_the_jax_package_s():
    im = np.random.RandomState(0).randint(0, 256, (40, 56, 3)).astype(
        np.uint8)
    for f in (lambda d: d.image.resize_short(im, 24),
              lambda d: d.image.center_crop(im, 20),
              lambda d: d.image.left_right_flip(im),
              lambda d: d.image.to_chw(im),
              lambda d: d.image.random_crop(im, 16,
                                            rng=np.random.RandomState(3)),
              lambda d: d.image.simple_transform(
                  im, 32, 24, is_train=True, rng=np.random.RandomState(4)),
              lambda d: d.image.simple_transform(im, 32, 24, is_train=False,
                                                 mean=[1.0, 2.0, 3.0])):
        np.testing.assert_array_equal(f(pds), f(jds))
