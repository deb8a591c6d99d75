"""Filesystem layer: local + shell-driven HDFS.

The port of ``paddle_tpu/core/fs.py`` (the reference's
``framework/io/fs.cc`` and ``shell.cc`` LocalFS / HadoopFS command
wrappers, and ``incubate/fleet/utils/hdfs.py``'s HDFSClient: every
operation shells out to ``hadoop fs`` with bounded retries). The
industrial CTR path stores dataset file lists and model dumps on HDFS;
trainers split the file list by rank (``split_files``).
"""
from __future__ import annotations

import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["LocalFS", "HDFSClient", "split_files"]


def split_files(files: Sequence[str], trainer_id: int, trainers: int):
    """Round-robin file split per trainer (reference hdfs.py:396)."""
    remainder = len(files) % trainers
    blocksize = len(files) // trainers
    blocks = [blocksize] * trainers
    for i in range(remainder):
        blocks[i] += 1
    trainer_files = [[]] * trainers
    begin = 0
    for i in range(trainers):
        trainer_files[i] = files[begin:begin + blocks[i]]
        begin += blocks[i]
    return trainer_files[trainer_id]


class LocalFS:
    """Reference framework/io/fs.cc local backend — same interface as
    HDFSClient so dataset/fleet code is storage-agnostic."""

    def ls_dir(self, path) -> Tuple[List[str], List[str]]:
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for n in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, n))
             else files).append(n)
        return dirs, files

    def ls(self, path) -> List[str]:
        dirs, files = self.ls_dir(path)
        return [os.path.join(path, n) for n in dirs + files]

    def cat(self, path) -> str:
        with open(path) as f:
            return f.read().rstrip("\n")

    def is_exist(self, path) -> bool:
        return os.path.exists(path)

    def is_dir(self, path) -> bool:
        return os.path.isdir(path)

    def is_file(self, path) -> bool:
        return os.path.isfile(path)

    def delete(self, path) -> bool:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
        return True

    def rename(self, src, dst, overwrite=False) -> bool:
        if os.path.exists(dst):
            if not overwrite:
                raise FileExistsError(dst)
            self.delete(dst)
        os.replace(src, dst)
        # rename alone survives process death, not host crash: the new
        # dirent lives in the parent's page cache until it is synced
        from ..checkpoint import _fsync_dir

        _fsync_dir(os.path.dirname(os.path.abspath(dst)))
        return True

    def makedirs(self, path) -> bool:
        os.makedirs(path, exist_ok=True)
        return True

    mkdirs = makedirs

    def touch(self, path) -> bool:
        self.makedirs(os.path.dirname(path) or ".")
        with open(path, "a"):
            pass
        return True

    def download(self, hdfs_path, local_path, overwrite=False,
                 **kw) -> bool:
        # local backend: copy; overwrite REPLACES (merging into an
        # existing dir would keep stale files a reload then picks up)
        if overwrite and os.path.exists(local_path):
            self.delete(local_path)
        if os.path.isdir(hdfs_path):
            shutil.copytree(hdfs_path, local_path, dirs_exist_ok=True)
        else:
            self.makedirs(os.path.dirname(local_path) or ".")
            shutil.copy2(hdfs_path, local_path)
        return True

    def upload(self, hdfs_path, local_path, overwrite=False,
               **kw) -> bool:
        return self.download(local_path, hdfs_path,
                             overwrite=overwrite)


class HDFSClient:
    """``hadoop fs`` command wrapper (reference hdfs.py:68): every call
    shells out with retries; paths are plain HDFS paths. ``configs``
    become ``-D key=value`` pairs (fs.default.name, hadoop.job.ugi)."""

    def __init__(self, hadoop_home: str, configs: Optional[Dict] = None,
                 retry_times: int = 5, retry_sleep: float = 0.1):
        self.pre_commands: List[str] = []
        hadoop_bin = os.path.join(hadoop_home, "bin", "hadoop")
        self.pre_commands.append(hadoop_bin)
        dfs = "fs"
        self.pre_commands.append(dfs)
        for k, v in (configs or {}).items():
            self.pre_commands.append("-D%s=%s" % (k, v))
        self._retry_times = retry_times
        self._retry_sleep = retry_sleep

    def _run(self, commands: Sequence[str],
             retry_times: Optional[int] = None):
        """(returncode, stdout) with bounded retries (reference
        __run_hdfs_cmd, hdfs.py:79)."""
        cmd = list(self.pre_commands) + list(commands)
        retries = self._retry_times if retry_times is None else retry_times
        ret, out = 1, ""
        for attempt in range(max(retries, 1)):
            proc = subprocess.run(cmd, capture_output=True, text=True)
            ret, out = proc.returncode, proc.stdout
            if ret == 0:
                break
            time.sleep(self._retry_sleep)
        return ret, out

    # -- queries ----------------------------------------------------------
    def cat(self, hdfs_path) -> str:
        ret, out = self._run(["-cat", hdfs_path], retry_times=1)
        return out.rstrip("\n") if ret == 0 else ""

    def is_exist(self, hdfs_path) -> bool:
        # -test -e: a return code, not a full directory listing
        ret, _ = self._run(["-test", "-e", hdfs_path], retry_times=1)
        return ret == 0

    def is_dir(self, hdfs_path) -> bool:
        if not self.is_exist(hdfs_path):
            return False
        ret, _ = self._run(["-test", "-d", hdfs_path], retry_times=1)
        return ret == 0

    def is_file(self, hdfs_path) -> bool:
        if not self.is_exist(hdfs_path):
            return False
        ret, _ = self._run(["-test", "-f", hdfs_path], retry_times=1)
        return ret == 0

    def ls(self, hdfs_path) -> List[str]:
        ret, out = self._run(["-ls", hdfs_path], retry_times=1)
        if ret != 0:
            return []
        paths = []
        for line in out.splitlines():
            cols = line.split()
            if len(cols) >= 8:
                paths.append(cols[-1])
        return sorted(paths)

    def lsr(self, hdfs_path, excludes: Sequence[str] = ()) -> List[str]:
        ret, out = self._run(["-lsr", hdfs_path], retry_times=1)
        if ret != 0:
            return []
        paths = []
        for line in out.splitlines():
            cols = line.split()
            if len(cols) >= 8 and not cols[0].startswith("d"):
                p = cols[-1]
                if not any(e in p for e in excludes):
                    paths.append(p)
        return sorted(paths)

    # -- mutations --------------------------------------------------------
    def delete(self, hdfs_path) -> bool:
        # one JVM launch: recursive + force covers file/dir/missing
        ret, _ = self._run(["-rm", "-r", "-f", hdfs_path])
        return ret == 0

    def rename(self, src, dst, overwrite=False) -> bool:
        if overwrite and self.is_exist(dst):
            self.delete(dst)
        ret, _ = self._run(["-mv", src, dst])
        return ret == 0

    def makedirs(self, hdfs_path) -> bool:
        # -p: nested creation (hadoop 2+ refuses it otherwise; the
        # day/pass layout always creates multi-level paths)
        ret, _ = self._run(["-mkdir", "-p", hdfs_path])
        return ret == 0

    mkdirs = makedirs

    def touch(self, hdfs_path) -> bool:
        ret, _ = self._run(["-touchz", hdfs_path])
        return ret == 0

    def download(self, hdfs_path, local_path, multi_processes=1,
                 overwrite=False) -> bool:
        if overwrite and os.path.exists(local_path):
            LocalFS().delete(local_path)
        d = os.path.dirname(local_path)
        if d:
            os.makedirs(d, exist_ok=True)
        ret, _ = self._run(["-get", hdfs_path, local_path])
        return ret == 0

    def upload(self, hdfs_path, local_path, multi_processes=1,
               overwrite=False) -> bool:
        if overwrite and self.is_exist(hdfs_path):
            self.delete(hdfs_path)
        ret, _ = self._run(["-put", local_path, hdfs_path])
        return ret == 0

    def upload_dir(self, dest_dir, local_dir, overwrite=False) -> bool:
        return self.upload(dest_dir, local_dir, overwrite=overwrite)

    # static helper mirrored from the reference class
    split_files = staticmethod(split_files)
