"""``CompiledProgram.with_data_parallel`` through the port against the JAX
package's mesh run.

Each case builds one script under both packages, runs the JAX startup,
carries its persistables into the port's scope (``carry``) and trains both
on the same seeded numpy batches: the JAX program over its mesh of virtual
CPU devices (``tests/conftest.py`` sets 8), the port's over
``[CPUPlace()] * n`` replicas in one process. Covered: an MLP (per-grad,
bucketed and sharded-update paths), a 2-layer narrow gpt, sync batch norm
on a small NHWC residual net, LocalSGD through the fleet API,
``GradientScaleStrategy.One``, the fused-optimizer refusal, the fleet
collective API and the stacking of fetches.

Tolerances (float32): losses within 1e-5 relative (XLA's all-reduce and
the port's rank-order sum add the replicas' grads in different orders);
parameters within 1e-5 absolute after the steps (a few rounding steps on
updates of about the learning rate); the gpt within test_torch_training's
1e-4 relative losses and 2 * lr a step on parameters (flash attention's
plain versions against XLA's dense math); sync batch norm's running
statistics within 1e-5 relative. Sync batch norm is held to the JAX
package's one device on the whole batch, the reference's semantics: the
port's grad reduces the grad statistics over the replicas, where the JAX
mesh's takes local ones.
"""
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.parallel.mesh_utils import make_mesh as jax_mesh
import paddle_tpu_torch as fluid
from paddle_tpu_torch.parallel import engine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

KNOBS = ("PADDLE_TPU_BUCKET_MB", "PADDLE_TPU_QUANT_ALLREDUCE",
         "PADDLE_TPU_SHARDED_UPDATE", "PADDLE_TPU_FUSED_OPTIMIZER",
         "PADDLE_TPU_FUSED_EPILOGUE")
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
BN_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    yield


def mlp(pkg, batch, opt="adam", feat=16, hidden=32, classes=10):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[batch, feat], dtype="float32")
        lbl = pkg.data(name="lbl", shape=[batch, 1], dtype="int64")
        h = pkg.layers.fc(x, size=hidden, act="relu")
        pred = pkg.layers.fc(h, size=classes, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, lbl))
        make = {"adam": lambda: pkg.optimizer.AdamOptimizer(1e-2),
                "sgd": lambda: pkg.optimizer.SGD(learning_rate=0.1),
                "momentum": lambda: pkg.optimizer.MomentumOptimizer(
                    0.1, 0.9)}[opt]
        make().minimize(loss)
    return main, startup, loss, pred


def mlp_feeds(steps, batch, feat=16, classes=10, seed=11):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(batch, feat).astype("float32"),
             "lbl": rng.randint(0, classes, (batch, 1)).astype("int64")}
            for _ in range(steps)]


def bn_net(pkg, batch):
    """A small NHWC residual net: conv-bn-relu, conv-bn plus the shortcut,
    relu, global pool, fc; Momentum."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 5
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data(name="img", shape=[batch, 8, 8, 4], dtype="float32")
        lbl = pkg.data(name="lbl", shape=[batch, 1], dtype="int64")
        h = L.conv2d(img, 8, 3, padding=1, bias_attr=False,
                     data_format="NHWC")
        h = L.batch_norm(h, act="relu", data_layout="NHWC")
        r = L.conv2d(h, 8, 3, padding=1, bias_attr=False,
                     data_format="NHWC")
        r = L.batch_norm(r, data_layout="NHWC")
        h = L.relu(L.elementwise_add(h, r))
        h = L.pool2d(h, pool_type="avg", global_pooling=True,
                     data_format="NHWC")
        pred = L.fc(h, size=10, act="softmax")
        loss = L.mean(L.cross_entropy(pred, lbl))
        pkg.optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
    return main, startup, loss, pred


def bn_feeds(steps, batch, seed=13):
    rng = np.random.RandomState(seed)
    return [{"img": (rng.randn(batch, 8, 8, 4) * 2 + 1).astype("float32"),
             "lbl": rng.randint(0, 10, (batch, 1)).astype("int64")}
            for _ in range(steps)]


def carry(arrays, pmain, pscope):
    """The JAX startup's persistables into the port's scope, in the types
    the port's program declares (int32 counters become int64)."""
    out = {}
    for name, a in arrays.items():
        pv = pmain.global_block()._find_var_recursive(name)
        if pv is not None and str(pv.dtype) in ("int32", "int64"):
            a = a.astype(str(pv.dtype))
        out[name] = a
    fluid.io.scope_from_numpy(pscope, out, fluid.CPUPlace())


def persistables(main, scope, pkg):
    out = {}
    for v in main.global_block().vars.values():
        var = scope.find_var(v.name) if v.persistable else None
        if var is not None and var.is_initialized():
            out[v.name] = np.array(var.get_tensor())
    return out


def run_jax(build, feeds, n, fetch_extra=(), build_strategy=None,
            prepare=None):
    main, startup, loss, pred = build(jfluid)
    if prepare is not None:
        prepare(jfluid, main, loss)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = persistables(main, scope, jfluid)
        cp = jfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=build_strategy,
            places=jax_mesh([n], ["dp"]))
        fetch = [loss] + [{"pred": pred}[f] for f in fetch_extra]
        outs = [[np.asarray(o) for o in exe.run(cp, feed=f,
                                                fetch_list=fetch)]
                for f in feeds]
    return outs, persistables(main, scope, jfluid), init, main


def run_port(build, feeds, n, jinit, fetch_extra=(), build_strategy=None,
             prepare=None):
    main, startup, loss, pred = build(fluid)
    if prepare is not None:
        prepare(fluid, main, loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    carry(jinit, main, scope)
    cp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=build_strategy,
        places=[fluid.CPUPlace()] * n)
    fetch = [loss] + [{"pred": pred}[f] for f in fetch_extra]
    outs = [[np.asarray(o) for o in exe.run(cp, feed=f, fetch_list=fetch,
                                            scope=scope)]
            for f in feeds]
    return outs, persistables(main, scope, fluid), main


def assert_close_runs(jax_run, port_run, loss_rtol=LOSS_RTOL,
                      param_atol=PARAM_ATOL, names=None):
    jouts, jstate = jax_run[0], jax_run[1]
    pouts, pstate = port_run[0], port_run[1]
    for j, p in zip(jouts, pouts):
        assert np.asarray(j[0]).shape == np.asarray(p[0]).shape
        np.testing.assert_allclose(p[0], j[0], rtol=loss_rtol, atol=0)
    for name in (names if names is not None else jstate):
        if name not in pstate or jstate[name].dtype.kind != "f":
            continue
        np.testing.assert_allclose(pstate[name], jstate[name], rtol=0,
                                   atol=param_atol, err_msg=name)


@pytest.mark.parametrize("env", [{"PADDLE_TPU_BUCKET_MB": "0"}, {},
                                 {"PADDLE_TPU_SHARDED_UPDATE": "1"}],
                         ids=["per_grad", "bucketed", "sharded_update"])
def test_mlp_with_data_parallel_matches_jax_mesh(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    n, batch = 8, 32
    feeds = mlp_feeds(3, batch)
    build = lambda pkg: mlp(pkg, batch // n)  # noqa: E731
    j = run_jax(build, feeds, n)
    p = run_port(build, feeds, n, j[2])
    assert_close_runs(j, p)
    types = [op.type for op in p[2].global_block().ops
             if op.type.startswith("c_")]
    want = {"per_grad": ["c_allreduce_sum"] * 4,
            "bucketed": ["c_bucket_allreduce"],
            "sharded_update": ["c_sharded_update"]}
    key = ("sharded_update" if env.get("PADDLE_TPU_SHARDED_UPDATE")
           else "per_grad" if env else "bucketed")
    assert types == want[key]
    if key == "sharded_update":
        flats = [k for k in j[1] if k.startswith("sharded_update_")]
        assert flats and all(k in p[1] for k in flats)


def test_replicas_hold_their_own_bitwise_equal_params():
    """Every replica's parameters stay bitwise equal after each step, and
    no two replicas share a buffer."""
    n, batch = 4, 16
    feeds = mlp_feeds(3, batch)
    main, startup, loss, _ = mlp(fluid, batch // n)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    cp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=[fluid.CPUPlace()] * n)
    for f in feeds:
        exe.run(cp, feed=f, fetch_list=[loss], scope=scope)
        (run,) = exe._core.dp_runs.values()
        for p in main.all_parameters():
            _, reps = run.copies[p.name]
            assert len({t.data_ptr() for t in reps}) == n
            for t in reps[1:]:
                assert torch.equal(t, reps[0])


def test_narrow_gpt_with_data_parallel_matches_jax_mesh():
    import test_torch_training as GT

    n, per = 2, 1
    rng = np.random.RandomState(0)
    from paddle_tpu_torch.models import gpt

    feeds = [gpt.random_batch(rng, n * per, GT.SEQ, GT.VOCAB)
             for _ in range(2)]

    def build(pkg):
        main, startup, loss, _ = GT.build_gpt(pkg, batch=per)
        return main, startup, loss, None

    j = run_jax(build, feeds, n)
    p = run_port(build, feeds, n, j[2])
    params = [v.name for v in p[2].all_parameters()]
    assert_close_runs(j, p, loss_rtol=GT.LOSS_RTOL,
                      param_atol=GT.PARAM_ATOL_PER_STEP * len(feeds),
                      names=params)


def run_jax_one(build, feeds):
    """The JAX package's one-device run of the full batch: the reference's
    sync batch norm semantics, forward and backward."""
    main, startup, loss, _ = build(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = persistables(main, scope, jfluid)
        outs = [[np.asarray(exe.run(main, feed=f, fetch_list=[loss])[0])]
                for f in feeds]
    return outs, persistables(main, scope, jfluid), init, main


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "local"])
def test_sync_batch_norm_matches_jax_mesh(sync):
    """Local batch norm over 4 replicas against the JAX package's 4-device
    mesh; sync batch norm against the JAX package's one device on the
    whole batch, the reference's semantics (the JAX mesh's sync grad takes
    local statistics: ROADMAP queue 3). The losses as the mean of the
    replicas'."""
    n, batch = 4, 16
    feeds = bn_feeds(2, batch)
    bs_j, bs_p = jfluid.BuildStrategy(), fluid.BuildStrategy()
    bs_j.sync_batch_norm = bs_p.sync_batch_norm = sync
    build = lambda pkg: bn_net(pkg, batch // n)  # noqa: E731
    if sync:
        j = run_jax_one(lambda pkg: bn_net(pkg, batch), feeds)
    else:
        j = run_jax(build, feeds, n, build_strategy=bs_j)
    p = run_port(build, feeds, n, j[2], build_strategy=bs_p)
    main = p[2]
    bn_ops = [op for op in main.global_block().ops
              if op.type in ("batch_norm", "batch_norm_grad")]
    assert len(bn_ops) == 4
    assert all(op.attrs.get("_sync_stats") is sync for op in bn_ops)
    stats = [n_ for op in bn_ops if op.type == "batch_norm"
             for n_ in op.output("MeanOut") + op.output("VarianceOut")]
    for name in stats:
        np.testing.assert_allclose(p[1][name], j[1][name], rtol=BN_RTOL,
                                   atol=1e-7, err_msg=name)
    if sync:
        p = ([[np.asarray(o[0]).mean(keepdims=True).reshape(
            np.asarray(jo[0]).shape)] for o, jo in zip(p[0], j[0])],
            p[1], p[2])
    assert_close_runs(j, p, names=[v.name for v in main.all_parameters()])


def test_sync_batch_norm_backward_takes_the_full_batch_statistics():
    """Two sync steps over 4 replicas of 4 give one replica's parameters on
    the batch of 16 (float32 sums in another order: 1e-6 absolute), where
    the JAX package's mesh, whose grad takes local statistics, is off by
    far more on the first conv (more than 1e-3)."""
    n, batch = 4, 16
    feeds = bn_feeds(2, batch)
    bs_j, bs_p = jfluid.BuildStrategy(), fluid.BuildStrategy()
    bs_j.sync_batch_norm = bs_p.sync_batch_norm = True
    build = lambda pkg: bn_net(pkg, batch // n)  # noqa: E731
    mesh = run_jax(build, feeds, n, build_strategy=bs_j)
    one = run_port(lambda pkg: bn_net(pkg, batch), feeds, 1, mesh[2])
    p = run_port(build, feeds, n, mesh[2], build_strategy=bs_p)
    names = [v.name for v in p[2].all_parameters()]
    for name in names:
        np.testing.assert_allclose(p[1][name], one[1][name], rtol=0,
                                   atol=1e-6, err_msg=name)
    conv0 = [nm for nm in names if nm.startswith("conv2d")][0]
    assert np.abs(mesh[1][conv0] - one[1][conv0]).max() > 1e-3


def test_sync_batch_norm_statistics_are_the_full_batch_ones():
    """One sync step over 4 replicas gives the running mean that one
    replica gets from the whole batch (the first batch norm reads the
    conv of the feed, which is the same on both)."""
    n, batch = 4, 16
    feed = bn_feeds(1, batch)[0]
    bs = fluid.BuildStrategy()
    bs.sync_batch_norm = True
    got = {}
    for reps in (1, n):
        main, startup, loss, _ = bn_net(fluid, batch // reps)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if reps == 1:
            init = persistables(main, scope, fluid)
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        else:
            for k, v in init.items():
                scope.var(k).set(fluid.LoDTensor(torch.from_numpy(v)))
            exe.run(fluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name, build_strategy=bs,
                places=[fluid.CPUPlace()] * reps), feed=feed,
                fetch_list=[loss], scope=scope)
        op = [o for o in main.global_block().ops
              if o.type == "batch_norm"][0]
        got[reps] = (np.array(scope.find_var(op.output("MeanOut")[0])
                              .get_tensor()),
                     np.array(scope.find_var(op.output("VarianceOut")[0])
                              .get_tensor()))
    np.testing.assert_allclose(got[n][0], got[1][0], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[n][1], got[1][1], rtol=1e-4, atol=1e-6)


def test_local_sgd_through_fleet_matches_jax_mesh():
    n, batch = 4, 16
    feeds = mlp_feeds(3, batch)

    def build(pkg):
        from importlib import import_module

        fl = import_module(pkg.__name__ + ".incubate.fleet.collective")
        base = import_module(pkg.__name__ + ".incubate.fleet.base")
        fl.fleet.init(base.UserDefinedRoleMaker(worker_num=n))
        main, startup = pkg.Program(), pkg.Program()
        startup.random_seed = 3
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data(name="x", shape=[batch // n, 16], dtype="float32")
            lbl = pkg.data(name="lbl", shape=[batch // n, 1], dtype="int64")
            pred = pkg.layers.fc(pkg.layers.fc(x, 32, act="relu"), 10,
                                 act="softmax")
            loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, lbl))
            strategy = fl.DistributedStrategy()
            strategy.use_local_sgd = True
            fl.fleet.distributed_optimizer(
                pkg.optimizer.SGD(learning_rate=0.1), strategy).minimize(loss)
        assert fl.fleet.worker_num() == n and fl.fleet.is_first_worker()
        assert fl.fleet.main_program._is_data_parallel
        return main, startup, loss, pred

    j = run_jax(build, feeds, n)
    p = run_port(build, feeds, n, j[2])
    jtypes = [op.type for op in j[3].global_block().ops]
    ptypes = [op.type for op in p[2].global_block().ops]
    assert ptypes == jtypes
    # the grads' and LocalSGD's parameter allreduces, bucketed; the 1/n
    # scale of each parameter after its optimizer op
    assert "c_bucket_allreduce" in ptypes and ptypes.count("scale") == 4
    assert ptypes.index("sgd") < ptypes.index("scale")
    assert_close_runs(j, p)


def test_gradient_scale_strategy_one_matches_jax_mesh():
    n, batch = 4, 16
    feeds = mlp_feeds(2, batch)
    bs_j, bs_p = jfluid.BuildStrategy(), fluid.BuildStrategy()
    bs_j.gradient_scale_strategy = \
        jfluid.BuildStrategy.GradientScaleStrategy.One
    bs_p.gradient_scale_strategy = \
        fluid.BuildStrategy.GradientScaleStrategy.One
    build = lambda pkg: mlp(pkg, batch // n, opt="sgd")  # noqa: E731
    j = run_jax(build, feeds, n, build_strategy=bs_j)
    p = run_port(build, feeds, n, j[2], build_strategy=bs_p)
    assert_close_runs(j, p)
    seeds = [op for op in p[2].global_block().ops
             if op.type == "fill_constant" and op.output("Out")[0]
             .endswith("@GRAD")]
    assert seeds and all(op.attrs["value"] == 1.0 for op in seeds)


def test_fused_optimizer_refusal_matches_jax(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "1")
    msgs = []
    for pkg, places in ((jfluid, jax_mesh([2], ["dp"])),
                        (fluid, [fluid.CPUPlace()] * 2)):
        main, startup, loss, _ = mlp(pkg, 4)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        feed = mlp_feeds(1, 8)[0]
        if pkg is jfluid:
            with jfluid.scope_guard(scope):
                exe.run(startup)
                exe.run(main, feed=mlp_feeds(1, 4)[0], fetch_list=[loss])
                cp = pkg.CompiledProgram(main).with_data_parallel(
                    loss_name=loss.name, places=places)
                with pytest.raises(ValueError) as e:
                    exe.run(cp, feed=feed, fetch_list=[loss])
        else:
            exe.run(startup, scope=scope)
            exe.run(main, feed=mlp_feeds(1, 4)[0], fetch_list=[loss],
                    scope=scope)
            assert main._fused_optimizer_groups == 1
            cp = pkg.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name, places=places)
            with pytest.raises(ValueError) as e:
                exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == engine.FUSED_OPTIMIZER_REFUSAL


def test_fleet_collective_api():
    from paddle_tpu_torch.incubate.fleet.base import (Role,
                                                      UserDefinedRoleMaker)
    from paddle_tpu_torch.incubate.fleet.collective import (
        DistributedStrategy, fleet)

    fleet.init(UserDefinedRoleMaker(current_id=1, role=Role.WORKER,
                                    worker_num=2))
    assert fleet.worker_num() == 2 and fleet.worker_index() == 1
    assert fleet.is_worker() and not fleet.is_first_worker()
    main, startup, loss, _ = mlp(fluid, 4, opt="sgd")
    assert "c_allreduce_sum" not in [op.type for op in
                                     main.global_block().ops]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[4, 16], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, 3))
        fleet.distributed_optimizer(
            fluid.optimizer.SGD(learning_rate=0.1),
            DistributedStrategy()).minimize(loss)
    ops = [op.type for op in main.global_block().ops]
    assert ops.count("c_allreduce_sum") == 2
    assert isinstance(fleet.main_program, fluid.CompiledProgram)
    # the hybrid knobs run (they raised before the hybrid axes were
    # ported): pipeline wraps the optimizer in PipelineOptimizer
    strategy = DistributedStrategy()
    strategy.pipeline = True
    strategy.pipeline_num_microbatches = 2
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[4, 16], dtype="float32")
        h = fluid.layers.fc(x, 8)
        loss = fluid.layers.mean(fluid.layers.fc(h, 3))
        strategy.pipeline_cut_list = [[h]]
        fleet.distributed_optimizer(fluid.optimizer.SGD(0.1),
                                    strategy).minimize(loss)
    assert main._pipeline_meta["num_microbatches"] == 2
    assert [op.type for op in main.global_block().ops].count(
        "conditional_block") == 1
    with pytest.raises(NotImplementedError):
        fleet.init_server()


def test_fetches_stack_over_replicas_as_the_jax_mesh():
    n, batch = 4, 16
    feeds = mlp_feeds(1, batch)
    build = lambda pkg: mlp(pkg, batch // n)  # noqa: E731
    j = run_jax(build, feeds, n, fetch_extra=("pred",))
    p = run_port(build, feeds, n, j[2], fetch_extra=("pred",))
    jl, jp = j[0][0]
    pl, pp = p[0][0]
    assert pl.shape == jl.shape and pl.shape[0] == n
    assert pp.shape == jp.shape == (n, batch // n, 10)
    np.testing.assert_allclose(pp, jp, rtol=1e-5, atol=1e-7)
    # a non-data-parallel CompiledProgram runs its plain program
    main, startup, loss, _ = mlp(fluid, batch)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    (out,) = exe.run(fluid.CompiledProgram(main), feed=feeds[0],
                     fetch_list=[loss], scope=scope)
    assert np.asarray(out).size == 1
    assert "c_allreduce_sum" not in [op.type for op in
                                     main.global_block().ops]


def sparse_embedding_mlp(pkg, batch):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data(name="ids", shape=[batch, 1], dtype="int64")
        lbl = pkg.data(name="lbl", shape=[batch, 1], dtype="int64")
        emb = pkg.layers.embedding(ids, size=[32, 8], is_sparse=True)
        h = pkg.layers.fc(emb, size=16, act="relu")
        pred = pkg.layers.fc(h, size=10, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, lbl))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def test_a_host_op_is_refused_before_any_replica_runs():
    """``lookup_table_sparse_grad`` (a host op, not const-foldable) under
    ``with_data_parallel``: both packages raise NotImplementedError naming
    it, and the port's scope is untouched (no replica ran)."""
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, 32, (16, 1)).astype("int64"),
            "lbl": rng.randint(0, 10, (16, 1)).astype("int64")}
    errors = []
    main, startup, loss = sparse_embedding_mlp(jfluid, 4)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        cp = jfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, places=jax_mesh([4], ["dp"]))
        with pytest.raises(NotImplementedError) as e:
            exe.run(cp, feed=feed, fetch_list=[loss])
        errors.append(str(e.value))

    main, startup, loss = sparse_embedding_mlp(fluid, 4)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    before = persistables(main, scope, fluid)
    cp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=[fluid.CPUPlace()] * 4)
    with pytest.raises(NotImplementedError) as e:
        exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
    errors.append(str(e.value))
    want = ("host op 'lookup_table_sparse_grad' cannot be traced (not "
            "const-foldable here)")
    assert want in errors[0] and errors[1] == want
    assert exe._core.dp_last is None
    after = persistables(main, scope, fluid)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v)
