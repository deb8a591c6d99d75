"""Worker for the port's multi-process parameter-server tests, as a pserver
or a trainer (``tests/test_torch_multiprocess_ps.py``).

Role from ``PADDLE_TRAINING_ROLE`` (``PSERVER`` / ``TRAINER``, the
reference's contract), the pserver list from ``PS_TEST_PSERVERS``, a
server's own endpoint from ``PSERVER_ENDPOINT``. ``PS_TEST_NET`` picks
the net:

- ``dense``: fc regression under SGD with constant starts;
- ``sliced``: ``tests/test_sliced_ps.py``'s net, its w [16, 8] split into
  one row block a server, under Momentum.

A pserver runs the transpiled server program on the CPU and blocks in
``listen_and_serv`` (``PADDLE_PSERVER_RPC=1``) until the trainer shuts
it down. The one trainer trains ``PS_TEST_STEPS`` steps on the CPU,
writes its losses and final params as JSON to ``argv[1]`` and shuts the
servers down.

Run alone with no role set, it writes the one-process oracle: the
untranspiled net over the same batches.
"""
import json
import os
import sys

import numpy as np

import paddle_tpu_torch as fluid

NET = os.environ.get("PS_TEST_NET", "dense")
STEPS = int(os.environ.get("PS_TEST_STEPS", "5"))


def _fc(x, size, name, value, act=None):
    return fluid.layers.fc(
        x, size, act=act,
        param_attr=fluid.ParamAttr(
            name=name,
            initializer=fluid.initializer.ConstantInitializer(value)),
        bias_attr=fluid.ParamAttr(
            name=name + "_b",
            initializer=fluid.initializer.ConstantInitializer(0.0)))


def build():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        width = 16 if NET == "sliced" else 8
        x = fluid.data(name="x", shape=[16, width], dtype="float32")
        y = fluid.data(name="y", shape=[16, 1], dtype="float32")
        if NET == "sliced":
            h = _fc(x, 8, "w", 0.12, act="relu")
            pred = _fc(h, 1, "w2", 0.2)
        else:
            pred = _fc(x, 1, "w", 0.3)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        if NET == "sliced":
            fluid.optimizer.MomentumOptimizer(0.05, 0.9).minimize(loss)
        else:
            fluid.optimizer.SGD(0.05).minimize(loss)
    return main, startup, loss


def batches():
    rng = np.random.RandomState(5)
    out = []
    W = rng.randn(16 if NET == "sliced" else 8, 1).astype("float32")
    for _ in range(STEPS):
        xb = rng.randn(16, W.shape[0]).astype("float32")
        out.append({"x": xb, "y": xb @ W})
    return out


def transpiler(pservers):
    cfg = fluid.DistributeTranspilerConfig()
    if NET == "sliced":
        cfg.min_block_size = 64  # w [16, 8]: two blocks
    t = fluid.DistributeTranspiler(config=cfg)
    main, startup, loss = build()
    t.transpile(trainer_id=0, program=main, startup_program=startup,
                pservers=",".join(pservers), trainers=1, sync_mode=True)
    return t, main, startup, loss


def _losses(exe, main, loss, feeds):
    out = []
    for feed in feeds:
        (l,) = exe.run(main, feed=feed, fetch_list=[loss])
        out.append(float(np.asarray(l).ravel()[0]))
    return out


def oracle():
    """The untranspiled net over the same batches, in this process."""
    main_prog, startup, loss = build()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        losses = _losses(exe, main_prog, loss, batches())
    w = scope.find_var("w").get_tensor().numpy()
    return {"losses": losses, "w": w.tolist()}


def main():
    role = os.environ.get("PADDLE_TRAINING_ROLE", "").lower()
    out_path = sys.argv[1] if len(sys.argv) > 1 else ""
    if role not in ("pserver", "trainer"):
        with open(out_path, "w") as f:
            json.dump(oracle(), f)
        return
    pservers = os.environ["PS_TEST_PSERVERS"].split(",")
    if role == "pserver":
        ep = os.environ["PSERVER_ENDPOINT"]
        os.environ["PADDLE_PSERVER_RPC"] = "1"
        t = transpiler(pservers)[0]
        ps_prog = t.get_pserver_program(ep)
        exe = fluid.Executor(fluid.CPUPlace())
        exe._core.rng.seed = 123
        exe.run(t.get_startup_program(ep, ps_prog))
        exe.run(ps_prog)  # serves until a shutdown message
        return
    t, main_prog, startup, loss = transpiler(pservers)
    exe = fluid.Executor(fluid.CPUPlace())
    exe._core.rng.seed = 321
    exe.run(startup)
    losses = _losses(exe, t.get_trainer_program(), loss, batches())
    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    result = {"losses": losses}
    w = fluid.global_scope().find_var("w")
    if w is not None and w.is_initialized():
        result["w"] = w.get_tensor().numpy().tolist()
    if NET == "sliced":
        result["block_eps"] = [e["ep"] for e in t.dense_blocks["w"]]
    for ep in pservers:
        PSClient.for_endpoint(ep).shutdown_server()
    with open(out_path, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
