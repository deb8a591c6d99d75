"""HDFS client for fleet jobs.

The port of ``paddle_tpu/incubate/fleet/utils/hdfs.py`` (the
reference's ``incubate/fleet/utils/hdfs.py``): the implementation lives
in ``core/fs.py``; this module keeps the reference's import path."""
from ....core.fs import HDFSClient, LocalFS, split_files  # noqa: F401

__all__ = ["HDFSClient", "LocalFS", "split_files"]
