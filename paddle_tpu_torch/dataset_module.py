"""fluid.dataset — Dataset factory for file-driven training.

The port of ``paddle_tpu/dataset_module.py`` (the reference's
``dataset.py``: DatasetFactory, InMemoryDataset, QueueDataset, over the
C++ DatasetImpl / DataFeed stack). Records are parsed by the Python
MultiSlot feed (``_python_multislot_feed``), the JAX package's own
parser when its native one is not built; a batch is a feed dict of host
arrays and LoD tensors, which the executor stages onto its device.
"""
from __future__ import annotations

import random
from typing import List, Optional

import numpy as np
import torch

__all__ = ["DatasetFactory", "InMemoryDataset", "QueueDataset"]


class DatasetFactory:
    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError("unknown dataset class %r" % datafeed_class)


class DatasetBase:
    def __init__(self):
        self._batch_size = 1
        self._use_vars = []
        self._filelist: List[str] = []
        self._pipe_command = "cat"
        self._thread_num = 1

    def set_batch_size(self, batch_size):
        self._batch_size = batch_size

    def set_thread(self, thread_num):
        self._thread_num = thread_num

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_use_var(self, var_list):
        self._use_vars = list(var_list)

    def set_pipe_command(self, pipe_command):
        self._pipe_command = pipe_command

    def set_hdfs_config(self, fs_name, fs_ugi):
        pass  # no HDFS in this environment

    # -- feeding -----------------------------------------------------------
    def _slot_types(self):
        types = []
        for v in self._use_vars:
            name = str(v.dtype)
            types.append("int64" if "int" in name else "float")
        return types

    def _slot_shapes(self):
        return [tuple(int(s) for s in (v.shape or ())[1:])
                for v in self._use_vars]

    def _record_batches(self, filelist):
        """Yield feed dicts batch by batch (the parse runs on the calling
        thread)."""
        types = self._slot_types()
        feed = _python_multislot_feed(filelist, types, self._batch_size)
        shapes = self._slot_shapes()
        for slots in feed:
            out = {}
            for v, (vals, offs), shp in zip(self._use_vars, slots, shapes):
                n = len(offs) - 1
                per = int(np.prod(shp)) if shp else 1
                # dense only when EVERY record has exactly `per` values
                # (a total that merely sums to n*per may still be ragged)
                uniform = per > 0 and bool(
                    np.all(np.diff(np.asarray(offs)) == per))
                if uniform:
                    out[v.name] = vals.reshape((n,) + (shp or (1,)))
                else:
                    from .core.tensor import LoDTensor

                    t = LoDTensor(torch.from_numpy(vals.reshape(-1, 1)))
                    t.set_lod([list(offs)])
                    out[v.name] = t
            yield out

    def _iter_batches(self):
        yield from self._record_batches(self._filelist)

    def _iter_batches_sharded(self, num_workers):
        """Per-worker batch iterators over disjoint FILE shards
        (reference MultiTrainer assigns dataset readers to device
        workers; data_set.cc distributes the filelist). Returns <=
        num_workers iterators — never an empty shard."""
        files = list(self._filelist)
        shards = [files[i::num_workers] for i in range(num_workers)]
        shards = [s for s in shards if s]
        if not shards:
            return [self._iter_batches()]
        return [self._record_batches(s) for s in shards]


def _python_multislot_feed(filelist, types, batch_size):
    """The MultiSlot text parser: per slot a count, then that many
    values; a malformed line is skipped."""
    def gen():
        batch_vals = [[] for _ in types]
        batch_offs = [[0] for _ in types]
        n = 0
        for path in filelist:
            with open(path) as f:
                for line in f:
                    toks = line.split()
                    if not toks:
                        continue
                    i = 0
                    row = []
                    try:
                        for t in types:
                            cnt = int(toks[i])
                            i += 1
                            vals = toks[i:i + cnt]
                            i += cnt
                            if len(vals) != cnt:
                                raise ValueError("short record")
                            row.append(vals)
                    except (ValueError, IndexError):
                        continue  # a malformed line: skip it
                    for s, vals in enumerate(row):
                        conv = (np.int64 if types[s] == "int64"
                                else np.float32)
                        batch_vals[s].extend(conv(v) for v in vals)
                        batch_offs[s].append(len(batch_vals[s]))
                    n += 1
                    if n == batch_size:
                        yield [(np.asarray(batch_vals[s],
                                           dtype=np.int64 if types[s] ==
                                           "int64" else np.float32),
                                np.asarray(batch_offs[s]))
                               for s in range(len(types))]
                        batch_vals = [[] for _ in types]
                        batch_offs = [[0] for _ in types]
                        n = 0
        if n:
            yield [(np.asarray(batch_vals[s],
                               dtype=np.int64 if types[s] == "int64"
                               else np.float32),
                    np.asarray(batch_offs[s]))
                   for s in range(len(types))]

    return gen()


class InMemoryDataset(DatasetBase):
    """(the reference's dataset.py InMemoryDataset) load files into
    memory once; shuffle locally, or across workers (``global_shuffle``
    over ``distributed/record_shuffle.py``)."""

    def __init__(self):
        super().__init__()
        self._records: Optional[List[dict]] = None

    def load_into_memory(self):
        self._records = []
        # keep per-RECORD granularity for shuffling: batch size 1 here,
        # re-batched at iteration
        saved_bs = self._batch_size
        self._batch_size = 1
        for rec in self._record_batches(self._filelist):
            self._records.append(rec)
        self._batch_size = saved_bs

    def local_shuffle(self):
        if self._records is None:
            raise RuntimeError("load_into_memory first")
        random.shuffle(self._records)

    def global_shuffle(self, fleet=None, thread_num=12):
        """Re-distribute records ACROSS workers (DatasetImpl::
        GlobalShuffle: fleet RPC in the reference,
        distributed/record_shuffle here), then shuffle locally.
        Worker topology from PADDLE_SHUFFLE_ENDPOINTS +
        PADDLE_TRAINER_ID (or the fleet role maker); single-worker
        setups degrade to a local shuffle."""
        import os

        if self._records is None:
            raise RuntimeError("load_into_memory first")
        eps = os.environ.get("PADDLE_SHUFFLE_ENDPOINTS", "")
        idx = None
        if not eps and fleet is not None:
            try:
                eps = ",".join(fleet.worker_endpoints())
                idx = int(fleet.worker_index())
            except Exception:
                eps = ""
        endpoints = [e for e in eps.split(",") if e]
        if len(endpoints) > 1:
            from .distributed.record_shuffle import global_record_shuffle

            if idx is None:
                idx = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
            self._records = global_record_shuffle(self._records,
                                                  endpoints, idx)
        self.local_shuffle()

    def release_memory(self):
        self._records = None

    def get_memory_data_size(self, fleet=None):
        return len(self._records or [])

    def _iter_batches(self):
        if self._records is None:
            yield from super()._iter_batches()
            return
        yield from self._batches_from_records(self._records)

    def _iter_batches_sharded(self, num_workers):
        """In-memory records shard round-robin across workers (the
        file-based path shards the filelist instead)."""
        if self._records is None:
            return super()._iter_batches_sharded(num_workers)
        shards = [self._records[i::num_workers]
                  for i in range(num_workers)]
        shards = [s for s in shards if len(s) >= self._batch_size]
        if not shards:
            return [self._iter_batches()]
        return [self._batches_from_records(s) for s in shards]

    def _batches_from_records(self, records):
        from .core.tensor import LoDTensor

        for i in range(0, len(records), self._batch_size):
            chunk = records[i:i + self._batch_size]
            if len(chunk) < self._batch_size:
                break  # drop remainder (static shapes)
            merged = {}
            for v in self._use_vars:
                parts = [c[v.name] for c in chunk]
                # a slot is LoD if ANY record parsed ragged — dense
                # records in the same slot get a trivial 1-row lod
                if any(isinstance(p, LoDTensor) for p in parts):
                    arrays = [np.asarray(p.numpy() if isinstance(
                        p, LoDTensor) else p).reshape(-1, 1)
                        for p in parts]
                    vals = np.concatenate(arrays, axis=0)
                    offs = [0]
                    for a in arrays:
                        offs.append(offs[-1] + a.shape[0])
                    t = LoDTensor(torch.from_numpy(vals))
                    t.set_lod([offs])
                    merged[v.name] = t
                else:
                    merged[v.name] = np.concatenate(parts, axis=0)
            yield merged


class QueueDataset(DatasetBase):
    """(the reference's dataset.py QueueDataset) streaming: records flow
    straight from the reader, never materialized."""
