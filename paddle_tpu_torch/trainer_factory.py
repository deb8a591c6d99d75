"""Trainer / DeviceWorker stack driving Dataset-based training.

The port of ``paddle_tpu/trainer_factory.py`` (the reference's
``trainer.h`` TrainerBase / MultiTrainer, ``device_worker.h``
HogwildWorker / DownpourWorker, ``trainer_desc.proto``'s TrainerDesc and
its dump fields, and ``executor.py``'s ``_prepare_trainer``).

The reference runs one C++ thread a device, each looping over the ops
on its DataFeed shard. Here a worker thread runs ``Executor.run`` steps
over its dataset shard: the threads overlap file parsing and feed
staging with the steps, and the steps themselves run one at a time under
a trainer mutex. Workers share the scope, a captured step shares its
static buffers, and the interpreter writes intermediates into the
scope: two steps in flight would clobber each other. Updates are
therefore sequentially consistent, not Hogwild's lock-free races.

DownpourWorker: the reference worker pulls and pushes sparse tables
around the op loop through pslib. Here that traffic is IN the program
(``distributed_lookup_table`` / ``distributed_push_sparse`` over
``ps_rpc``), so the Downpour worker is the same step loop.
"""
from __future__ import annotations

import os
import threading
from typing import List, Optional

import numpy as np

from .distributed.ps_rpc import host_array

__all__ = ["TrainerDesc", "TrainerFactory", "MultiTrainer",
           "HogwildWorker", "DownpourWorker"]


class TrainerDesc:
    """Mirror of trainer_desc.proto:21 (the fields this runtime uses)."""

    def __init__(self):
        self.class_name = "MultiTrainer"
        self.device_worker = "Hogwild"
        self.thread_num = 1
        self.fetch_vars: List = []
        self.fetch_info: List[str] = []
        self.print_period = 100
        self.debug = False
        # trainer_desc.proto:39-45 debug dumps
        self.dump_fields: List[str] = []
        self.dump_fields_path: str = ""
        self.dump_param: List[str] = []


class HogwildWorker:
    """device_worker.h:163 HogwildWorker::TrainFiles — one worker's
    step loop over its dataset shard."""

    def __init__(self, worker_id, desc: TrainerDesc, trainer):
        self.worker_id = worker_id
        self.desc = desc
        self.trainer = trainer
        self.steps = 0

    def _dump(self, fh, step, scope, names):
        for n in names:
            var = scope.find_var(n)
            if var is None or not var.is_initialized():
                continue
            arr = host_array(var.get_tensor().array).reshape(-1)
            head = " ".join("%.6g" % v for v in arr[:16])
            fh.write("%d\t%s\t%s%s\n"
                     % (step, n, head, " ..." if arr.size > 16 else ""))

    def train_files(self, program, batches, scope, executor):
        desc = self.desc
        fetch_names = [getattr(v, "name", v) for v in desc.fetch_vars]
        dump_fh = None
        if desc.dump_fields and desc.dump_fields_path:
            os.makedirs(desc.dump_fields_path, exist_ok=True)
            # a worker's file starts empty and then grows: the trainer
            # runs worker 0's first batch alone before the fan-out, and
            # reopening for "w" would drop that step's lines (the JAX
            # package's trainer_factory.py does)
            dump_fh = open(os.path.join(
                desc.dump_fields_path,
                "worker_%d.txt" % self.worker_id),
                "a" if self.steps else "w")
        try:
            for batch in batches:
                with self.trainer.step_guard(program):
                    vals = executor.run(program, feed=batch,
                                        fetch_list=fetch_names or None,
                                        scope=scope)
                self.steps += 1
                if fetch_names and \
                        self.steps % desc.print_period == 0:
                    infos = desc.fetch_info or fetch_names
                    msg = ", ".join(
                        "%s=%s" % (i, np.asarray(v).reshape(-1)[:4])
                        for i, v in zip(infos, vals or []))
                    print("[worker %d step %d] %s"
                          % (self.worker_id, self.steps, msg))
                if dump_fh is not None:
                    self._dump(dump_fh, self.steps, scope,
                               desc.dump_fields + desc.dump_param)
        finally:
            if dump_fh is not None:
                dump_fh.close()


class DownpourWorker(HogwildWorker):
    """device_worker.h:203 — sparse pull/push ride the program's
    distributed_lookup_table / push ops (see module docstring)."""


_WORKERS = {"Hogwild": HogwildWorker, "Downpour": DownpourWorker}


class MultiTrainer:
    """trainer.h:64 / multi_trainer.cc:157 — thread-per-worker over
    dataset shards sharing one scope."""

    def __init__(self, desc: TrainerDesc):
        self.desc = desc
        self.workers: List[HogwildWorker] = []
        self._step_lock = threading.Lock()

    def step_guard(self, program):
        """Step-dispatch mutex — see module docstring for why shared
        donated state forbids concurrent dispatch."""
        return self._step_lock

    # -- run ---------------------------------------------------------------

    def run(self, program, dataset, scope, executor):
        desc = self.desc
        n = max(1, int(desc.thread_num))
        worker_cls = _WORKERS.get(desc.device_worker, HogwildWorker)
        shards = dataset._iter_batches_sharded(n)
        n = len(shards)  # dataset may cap (fewer files than threads)
        self.workers = [worker_cls(i, desc, self) for i in range(n)]

        # first step on worker 0's shard before the fan-out: the step
        # function (and on the card its capture) is built once, warm for
        # every worker
        first_iters = [iter(s) for s in shards]
        try:
            first_batch = next(first_iters[0])
        except StopIteration:
            first_batch = None
        if first_batch is not None:
            self.workers[0].train_files(
                program, [first_batch], scope, executor)

        if n == 1:
            self.workers[0].train_files(program, first_iters[0], scope,
                                        executor)
            return self.stats()

        errors: List[BaseException] = []

        def body(w, batches):
            try:
                w.train_files(program, batches, scope, executor)
            except BaseException as e:  # propagate to the caller
                errors.append(e)

        threads = [threading.Thread(target=body, args=(w, it),
                                    daemon=True)
                   for w, it in zip(self.workers, first_iters)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return self.stats()

    def stats(self):
        return {"steps_per_worker": [w.steps for w in self.workers],
                "total_steps": sum(w.steps for w in self.workers)}


class TrainerFactory:
    """trainer_factory.cc — TrainerDesc -> trainer instance."""

    def create_trainer(self, desc: Optional[TrainerDesc] = None):
        desc = desc or TrainerDesc()
        if desc.class_name not in ("MultiTrainer", "DistMultiTrainer"):
            raise ValueError("unknown trainer class %r" % desc.class_name)
        return MultiTrainer(desc)
