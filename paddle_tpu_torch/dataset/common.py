"""Dataset plumbing (reference python/paddle/dataset/common.py).

DATA_HOME cache layout and md5 checks match the reference;
``download`` only serves from the local cache — this environment has no
network egress, so a missing file raises with instructions instead of
fetching. Every dataset module therefore falls back to a deterministic
synthetic reader when its files are absent (the reference's sample
contracts are preserved so book-style tests behave the same).
"""
from __future__ import annotations

import hashlib
import os
import pickle

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA_HOME",
    os.path.expanduser(os.path.join("~", ".cache", "paddle_tpu",
                                    "dataset")))


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)
    return path


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum=None, save_name=None):
    """Serve from the local cache; no egress in this environment."""
    dirname = must_mkdirs(os.path.join(DATA_HOME, module_name))
    filename = os.path.join(
        dirname, save_name if save_name else url.split("/")[-1])
    if os.path.exists(filename):
        if md5sum is None or md5file(filename) == md5sum:
            return filename
    raise RuntimeError(
        "dataset file %s is not cached and this environment has no "
        "network egress; place the file at %s manually (source url: %s)"
        % (os.path.basename(filename), filename, url))


def cached_path(module_name, filename):
    """Path inside DATA_HOME if it exists, else None."""
    p = os.path.join(DATA_HOME, module_name, filename)
    return p if os.path.exists(p) else None


def cycled(reader):
    """Wrap a reader creator to repeat forever (the reference's
    cycle=True contract)."""
    def cyc():
        while True:
            yield from reader()

    return cyc


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=pickle.load):
    """(reference common.py cluster_files_reader) — round-robin split of
    matched files across trainers."""
    import glob

    def reader():
        flist = sorted(glob.glob(files_pattern))
        my = flist[trainer_id::trainer_count]
        for fn in my:
            with open(fn, "rb") as f:
                d = loader(f)
                for item in d:
                    yield item

    return reader
