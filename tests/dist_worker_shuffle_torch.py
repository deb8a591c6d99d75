"""Worker for the port's two-process global-shuffle test
(``tests/test_torch_dataset_trainer.py``): it loads its own file shard
(labels tag the origin worker), runs ``InMemoryDataset.global_shuffle``
(records move between the processes through
``distributed/record_shuffle.py``), then trains the records it owns
through ``Executor.train_from_dataset`` on the CPU, and writes the labels
it owned before and after and its step count as JSON to ``argv[1]``.
Topology from ``PADDLE_SHUFFLE_ENDPOINTS`` and ``PADDLE_TRAINER_ID``."""
import json
import sys

import numpy as np

import paddle_tpu_torch as fluid


def main():
    out_path, data_file = sys.argv[1], sys.argv[2]
    B = 2
    main_p, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_p, startup):
        x = fluid.data(name="x", shape=[B, 4], dtype="float32")
        y = fluid.data(name="y", shape=[B, 1], dtype="int64")
        pred = fluid.layers.fc(x, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            pred, fluid.layers.cast(y, "float32")))
        fluid.optimizer.SGD(1e-7).minimize(loss)
    ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_batch_size(B)
    ds.set_use_var([x, y])
    ds.set_filelist([data_file])
    ds.load_into_memory()
    before = sorted(int(np.asarray(r["y"]).ravel()[0])
                    for r in ds._records)
    ds.global_shuffle()
    after = sorted(int(np.asarray(r["y"]).ravel()[0])
                   for r in ds._records)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    stats = exe.train_from_dataset(main_p, ds, thread=1)
    with open(out_path, "w") as f:
        json.dump({"before": before, "after": after,
                   "steps": stats["total_steps"]}, f)


if __name__ == "__main__":
    main()
