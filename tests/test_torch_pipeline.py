"""GPipe pipeline parallelism over a ``pp`` axis, the port against the JAX
package on the CPU.

The cases of ``tests/test_pipeline_pp.py``: ``PipelineOptimizer`` builds
the same program in both packages and records the same stage split; the
port's ``run_pipeline_parallel`` over 3 stages of ``CPUPlace()`` replicas
matches its own single-device microbatch accumulation (the update on the
k-th run) and the JAX engine's pipeline over 3 virtual devices, from the
JAX startup; a skip connection crosses a stage boundary untouched; the cut
errors; and the ``CompiledProgram`` route over a ``pp`` mesh.

Tolerances: the port's pipeline runs the same ops on the same
microbatches as its accumulation route and adds the grads in the same
order, so it is held bitwise there. Against the JAX package: losses
within ``rtol 1e-5, atol 1e-6`` and parameters within ``rtol 1e-4, atol
1e-5``, the JAX tests' own (XLA differentiates the stages with
``jax.grad``; the port runs the program's grad ops).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.parallel.mesh_utils import make_mesh as jax_mesh
import paddle_tpu.parallel.pipeline as JP
import paddle_tpu_torch as fluid
from paddle_tpu_torch.parallel.mesh_utils import make_mesh
from paddle_tpu_torch.parallel.pipeline import (_boundary_live_sets,
                                                pipeline_stats,
                                                run_pipeline_parallel,
                                                split_forward_at_cuts)

from test_torch_hybrid_parallel import carry, persistables
from test_torch_rnn_search import block_ops


def _build(pkg, n_micro, skip=False, cut_count=2, opt="momentum"):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        width = 12 if not skip else 8
        x = pkg.data(name="x", shape=[4, width], dtype="float32")
        label = pkg.data(name="label", shape=[4, 1], dtype="int64")
        h1 = pkg.layers.fc(x, size=16, act="relu")
        h2 = pkg.layers.fc(h1, size=16, act="relu")
        top = pkg.layers.elementwise_add(h2, h1) if skip else h2
        pred = pkg.layers.fc(top, size=10, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        inner = (pkg.optimizer.MomentumOptimizer(0.1, 0.9)
                 if opt == "momentum" else pkg.optimizer.SGD(0.1))
        pkg.optimizer.PipelineOptimizer(
            inner, cut_list=[[h1], [h2]][:cut_count],
            num_microbatches=n_micro).minimize(loss)
    return main, startup, loss


def _feeds(seed, width, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(4 * n, width).astype("float32"),
            rng.randint(0, 10, (4 * n, 1)).astype("int64"))


def three_ways(n_micro, skip, seed, opt="momentum"):
    """(JAX pipeline, port accumulation, port pipeline): the loss and the
    persistables after one step, from the JAX startup."""
    width = 8 if skip else 12
    X, Y = _feeds(seed, width, n_micro)
    jmain, jstart, jloss = _build(jfluid, n_micro, skip, opt=opt)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        init = persistables(jmain, jscope)
        (jl,) = JP.run_pipeline_parallel(
            jexe._core, jmain, jscope, feed={"x": X, "label": Y},
            fetch_list=[jloss], mesh=jax_mesh([3], ["pp"]))
        js = persistables(jmain, jscope)

    amain, _, aloss = _build(fluid, n_micro, skip, opt=opt)
    assert block_ops(amain) == block_ops(jmain)
    aexe, ascope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    carry(init, amain, ascope)
    losses = [np.float32(aexe.run(
        amain, feed={"x": X[m * 4:(m + 1) * 4],
                     "label": Y[m * 4:(m + 1) * 4]},
        fetch_list=[aloss], scope=ascope)[0]) for m in range(n_micro)]
    acc = persistables(amain, ascope)
    # the pipeline's mean: a float32 sum in microbatch order over M
    mean32 = np.float32(0)
    for v in losses:
        mean32 = np.float32(mean32 + v)

    pexe, pscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    carry(init, amain, pscope)
    (pl,) = run_pipeline_parallel(
        pexe._core, amain, pscope, feed={"x": X, "label": Y},
        fetch_list=[aloss],
        mesh=make_mesh([3], ["pp"], [fluid.CPUPlace()] * 3))
    ps = persistables(amain, pscope)
    return (float(np.asarray(jl)), js), \
        (float(np.float32(mean32 / np.float32(n_micro))), acc), \
        (float(pl), ps), init


def _params(state):
    return [n for n in state
            if not n.endswith(".pipe_acc") and not n.startswith("pipe_step")]


def test_split_forward_at_cuts_matches_the_jax_package():
    main, _, _ = _build(fluid, 4)
    jmain, _, _ = _build(jfluid, 4)
    meta, jmeta = main._pipeline_meta, jmain._pipeline_meta
    assert meta["n_fwd_ops"] == jmeta["n_fwd_ops"]
    assert meta["num_microbatches"] == jmeta["num_microbatches"] == 4
    assert meta["params"] == jmeta["params"]
    assert meta["acc_map"] == jmeta["acc_map"]
    assert [op.type for op in meta["update_ops"]] == \
        [op.type for op in jmeta["update_ops"]]
    stages = split_forward_at_cuts(main, meta["cut_list"],
                                   meta["n_fwd_ops"])
    jstages = JP.split_forward_at_cuts(jmain, jmeta["cut_list"],
                                       jmeta["n_fwd_ops"])
    assert len(stages) == 3
    assert [[op.type for op in s] for s in stages] == \
        [[op.type for op in s] for s in jstages]
    flat = [op for s in stages for op in s]
    assert flat == list(main.global_block().ops[:meta["n_fwd_ops"]])


@pytest.mark.parametrize("skip", [False, True], ids=["chain", "skip"])
def test_pipeline_matches_accumulation_and_the_jax_pipeline(skip):
    (jl, js), (al, acc), (pl, ps), init = three_ways(
        4 if not skip else 2, skip, 3 if not skip else 5,
        opt="momentum" if not skip else "sgd")
    assert pl == al  # the same ops in the same order: bitwise
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-6)
    for n in _params(acc):
        np.testing.assert_array_equal(ps[n], acc[n], err_msg=n)
        np.testing.assert_allclose(ps[n], js[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    moved = [n for n in _params(ps) if "velocity" not in n
             and "learning_rate" not in n and n in init
             and not np.allclose(init[n], ps[n])]
    assert moved, "the pipeline step did not update the parameters"


def test_skip_connection_rides_every_boundary_it_crosses():
    main, _, _ = _build(fluid, 2, skip=True)
    meta = main._pipeline_meta
    stages = split_forward_at_cuts(main, meta["cut_list"],
                                   meta["n_fwd_ops"])
    live = _boundary_live_sets(stages, {"x", "label"} | {
        p.name for p in main.all_parameters()})
    h1 = stages[0][-1].output_arg_names[0]
    assert h1 in live[0] and h1 in live[1]
    jlive = JP._boundary_live_sets(stages, {"x", "label"} | {
        p.name for p in main.all_parameters()})
    assert live == jlive


def test_pipeline_cut_errors():
    main, _, _ = _build(fluid, 4)
    meta = main._pipeline_meta
    with pytest.raises(ValueError, match="not produced"):
        split_forward_at_cuts(main, ["nonexistent_var"], meta["n_fwd_ops"])
    exe = fluid.Executor(fluid.CPUPlace())
    with pytest.raises(ValueError, match="stages"):
        run_pipeline_parallel(
            exe._core, main, fluid.Scope(), feed={}, fetch_list=[],
            mesh=make_mesh([2], ["pp"], [fluid.CPUPlace()] * 2))


def test_compiled_program_routes_a_pp_mesh_to_the_pipeline():
    """``exe.run(CompiledProgram(main).with_data_parallel(places=mesh))``
    over a mesh with a pp axis runs the pipeline: the same loss as the
    direct call, and the stage layout recorded."""
    n_micro = 4
    X, Y = _feeds(3, 12, n_micro)
    main, startup, loss = _build(fluid, n_micro)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    init = persistables(main, scope)
    cp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name,
        places=make_mesh([3], ["pp"], [fluid.CPUPlace()] * 3))
    (l1,) = exe.run(cp, feed={"x": X, "label": Y}, fetch_list=[loss],
                    scope=scope)
    stats = pipeline_stats()
    assert stats["stages"] == 3 and stats["microbatches"] == n_micro
    assert stats["bubble_fraction"] == pytest.approx(2 / 6)
    scope2 = fluid.Scope()
    carry(init, main, scope2)
    (l2,) = run_pipeline_parallel(
        exe._core, main, scope2, feed={"x": X, "label": Y},
        fetch_list=[loss],
        mesh=make_mesh([3], ["pp"], [fluid.CPUPlace()] * 3))
    assert float(l1) == float(l2)


def test_refusals_match_the_jax_engine():
    """Per-feed shard specs under a pipeline and an undeclared axis are
    refused with the JAX engine's exception types."""
    main, startup, loss = _build(fluid, 2, cut_count=1)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    X, Y = _feeds(0, 12, 2)
    mesh = make_mesh([2, 2], ["xp", "pp"], [fluid.CPUPlace()] * 4)
    with pytest.raises(ValueError, match="refusing to guess"):
        run_pipeline_parallel(exe._core, main, scope,
                              {"x": X, "label": Y}, [loss], mesh=mesh)
    main._feed_shard_specs = {"x": ("sp",)}
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        run_pipeline_parallel(exe._core, main, scope,
                              {"x": X, "label": Y}, [loss],
                              mesh=make_mesh([2], ["pp"],
                                             [fluid.CPUPlace()] * 2))
