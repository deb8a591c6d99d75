"""Worker of the port's multi-process data-parallel test: the twin of
tests/dist_worker_dp.py through ``paddle_tpu_torch``.

Started (one process a rank) by ``paddle_tpu_torch.distributed.launch``,
or alone for the single-process full-batch oracle. Two models train
STEPS steps on the same seeded batches, each rank on its shard of the
batch: a dygraph MLP under ``DataParallel`` (scale_loss,
apply_collective_grads) and the same MLP as a static program through
``CompiledProgram.with_data_parallel`` over the process world. Writes
``rank<r>.json`` (per-step losses, the route counters) and
``rank<r>.npz`` (every parameter after the steps) into the directory given
as the first argument, and prints the JSON; on the card the JSON also
holds the process's kernel launch counts.

``PADDLE_DP_DEVICE=cuda`` runs each rank on the card ``FLAGS_selected_gpus``
names (modulo the cards present); the default is the CPU.
"""
import json
import os
import sys

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import compiler_engine as ce
from paddle_tpu_torch.dygraph import Linear, to_variable
from paddle_tpu_torch.dygraph.parallel import DataParallel, prepare_context

STEPS = 3
FULL_BATCH = 8
DIM, HID, CLASSES = 12, 16, 10


class MLP(fluid.dygraph.Layer):
    def __init__(self):
        super().__init__()
        self.l1 = Linear(DIM, HID, act="relu")
        self.l2 = Linear(HID, CLASSES)

    def forward(self, x):
        return self.l2(self.l1(x))


def place(env):
    if os.environ.get("PADDLE_DP_DEVICE", "cpu") == "cuda":
        import torch

        return fluid.CUDAPlace(env.dev_id % torch.cuda.device_count())
    return fluid.CPUPlace()


def batches():
    rng = np.random.RandomState(7)
    return [(rng.randn(FULL_BATCH, DIM).astype("float32"),
             rng.randint(0, CLASSES, (FULL_BATCH, 1)).astype("int64"))
            for _ in range(STEPS)]


def shard(a, rank, nranks):
    n = FULL_BATCH // nranks
    return a[rank * n:(rank + 1) * n]


def dygraph_losses(env, where, params):
    rank, nranks = env.local_rank, env.nranks
    losses = []
    with fluid.dygraph.guard(where):
        model = MLP()
        wrng = np.random.RandomState(42)
        for p in model.parameters():
            p.set_value((wrng.randn(*p.shape) * 0.1).astype("float32"))
        model = DataParallel(model)
        opt = fluid.optimizer.SGD(learning_rate=0.1,
                                  parameter_list=model.parameters())
        for x, y in batches():
            logits = model(to_variable(shard(x, rank, nranks)))
            loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
                logits, to_variable(shard(y, rank, nranks))))
            losses.append(float(np.asarray(loss.numpy()).ravel()[0]))
            scaled = model.scale_loss(loss)
            scaled.backward()
            model.apply_collective_grads()
            opt.minimize(scaled, parameter_list=model.parameters())
            for p in model.parameters():
                p.clear_gradient()
        for i, p in enumerate(model.parameters()):
            params["dygraph_%d" % i] = np.array(p.numpy())
    return losses


# the collective ops of the static program after its first run (the
# schedule knobs of the environment shape them)
STATIC_C_OPS = []


def static_losses(env, where, params):
    rank, nranks = env.local_rank, env.nranks
    batch = FULL_BATCH // nranks
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[batch, DIM], dtype="float32")
        y = fluid.data(name="y", shape=[batch, 1], dtype="int64")
        h = fluid.layers.fc(x, HID, act="relu")
        logits = fluid.layers.fc(h, CLASSES)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = fluid.Executor(where)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    wrng = np.random.RandomState(43)
    arrays = {p.name: (wrng.randn(*p.shape) * 0.1).astype("float32")
              for p in main.all_parameters()}
    fluid.io.scope_from_numpy(scope, arrays, where)
    prog = (fluid.CompiledProgram(main).with_data_parallel(loss.name)
            if nranks > 1 else main)
    losses = []
    for xb, yb in batches():
        (out,) = exe.run(prog, feed={"x": shard(xb, rank, nranks),
                                     "y": shard(yb, rank, nranks)},
                         fetch_list=[loss], scope=scope)
        out = np.asarray(out).ravel()
        assert out.size == nranks, out.shape  # stacked over the ranks
        losses.append(float(out.mean()))
    for p in main.all_parameters():
        params["static_" + p.name] = np.array(
            scope.find_var(p.name).get_tensor())
    STATIC_C_OPS[:] = [op.type for op in main.global_block().ops
                       if op.type.startswith("c_")]
    return losses


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else None
    env = prepare_context()
    where = place(env)
    params = {}
    result = {"rank": env.local_rank, "nranks": env.nranks,
              "losses": dygraph_losses(env, where, params),
              "static_losses": static_losses(env, where, params),
              "static_c_ops": STATIC_C_OPS,
              "counters": ce.counters(), "declines": ce.declines()}
    if env.nranks > 1:
        import torch.distributed as dist

        result["backend"] = str(dist.get_backend())
    if os.environ.get("PADDLE_DP_DEVICE", "cpu") == "cuda":
        from paddle_tpu_torch.ops.cuda import support

        result["launches"] = support.launch_counts()
    text = json.dumps(result)
    if out_dir:
        with open(os.path.join(out_dir, "rank%d.json" % env.local_rank),
                  "w") as f:
            f.write(text)
        np.savez(os.path.join(out_dir, "rank%d.npz" % env.local_rank),
                 **params)
    print(text)
    if env.nranks > 1:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
