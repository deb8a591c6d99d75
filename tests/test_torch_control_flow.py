"""Control flow in the port against the JAX package, on the CPU.

- The control-flow ops (``while``, ``while_grad``, ``conditional_block``,
  the tensor arrays and their grads, ``print``, ``select_input`` /
  ``select_output``, ``split_lod_tensor`` / ``merge_lod_tensor``) are
  registered with the JAX package's slots, attrs and grad kind.
- The scope hierarchy: lookup through the parents, local lookup, child
  scopes.
- The cases of ``tests/test_control_flow_compile.py``: a ``while`` that
  doubles x five times and a ``conditional_block`` both ways. The
  program takes the port's whole-program route, as it takes the JAX
  package's (``untraceable_reasons`` finds nothing in either, no fallback
  is counted); its results equal the JAX package's compiled route
  (``lax.while_loop`` / ``lax.cond``) and its interpreter.
- ``tests/test_while_grad.py``'s cases (:59, both carry flavours, and the
  zero-trip loop at :98): training through ``while_grad`` gives the
  unrolled program's losses and weights, and the JAX package's.
- ``IfElse``, ``cond``, the tensor arrays (in the main block and inside a
  while body, with their grads) train as in the JAX package.

Tolerances: losses and weights within 1e-5 of each tensor's scale (the
largest magnitude, at least 1): the same float32 math in another order;
the while-trained weights against the unrolled program's within 1e-5 too.
Integers exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.core.compiler_engine import \
    run_compiled_program as jax_compiled
from paddle_tpu.core.executor_core import CoreExecutor as JaxCore
from paddle_tpu.core.registry import OpInfoMap as JaxOps
from paddle_tpu_torch.core import compiler_engine as pce
from paddle_tpu.core import compiler_engine as jce
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.core.scope import Scope

import test_torch_lr_schedule as LS  # noqa: E402
import test_torch_rnn as RN  # noqa: E402

TOL = 1e-5


def block_seqs(program):
    """Every block's ops as (type, inputs, outputs, attrs), a sub-block
    attr read as its index, cast's int32 and int64 in_dtype as one."""
    def attr(v):
        return ("block", v.idx) if hasattr(v, "ops") else v

    out = []
    for b in program.blocks:
        ops = []
        for op in b.ops:
            a = {k: attr(v) for k, v in op.attrs.items()}
            if op.type == "cast" and a.get("in_dtype") == 2:
                a["in_dtype"] = 3
            ops.append((op.type, op.inputs, op.outputs, a))
        out.append((b.idx, b.parent_idx, ops))
    return out

CF_OPS = ["while", "while_grad", "conditional_block",
          "create_lod_tensor_array", "write_to_array", "read_from_array",
          "lod_array_length", "fill_zero_array_like", "write_to_array_grad",
          "read_from_array_grad", "print", "select_input", "select_output",
          "split_lod_tensor", "merge_lod_tensor"]


@pytest.mark.parametrize("op_type", CF_OPS)
def test_op_is_registered_as_in_the_jax_package(op_type):
    j, p = JaxOps.instance().get(op_type), OpInfoMap.instance().get(op_type)
    assert RN._slots(p.inputs) == RN._slots(j.inputs)
    assert RN._slots(p.outputs) == RN._slots(j.outputs)
    assert p.attrs == j.attrs
    assert p.host_fn is not None and j.host_fn is not None
    assert RN._grad_kind(OpInfoMap.instance(), op_type) == \
        RN._grad_kind(JaxOps.instance(), op_type)


def test_scope_hierarchy():
    root = Scope()
    root.var("a").set(1)
    kid = root.new_scope()
    grandkid = kid.new_scope()
    assert kid.parent() is root and grandkid.parent() is kid
    assert root.parent() is None
    assert grandkid.find_var("a") is root.find_var("a")
    assert grandkid.find_local_var("a") is None
    grandkid.var("a").set(2)  # var() makes a local one, shadowing
    assert grandkid.find_var("a").raw() == 2 and root.find_var("a").raw() == 1
    assert kid.find_var("b") is None
    other = root.new_scope()
    assert root._kids == [kid, other]
    root.drop_kid(other)
    assert root._kids == [kid]
    root.drop_kids()
    assert root._kids == []
    assert grandkid.find_var("a").raw() == 2  # a dropped kid still reads


# -- tests/test_control_flow_compile.py ------------------------------------

def _while_program(pkg):
    """x doubles 5 times: while (i < 5) { x = 2x; i += 1 }."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x0 = pkg.data(name="x0", shape=[4], dtype="float32")
        x = pkg.layers.assign(x0)
        i = pkg.layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = pkg.layers.fill_constant(shape=[1], dtype="int64", value=5)
        cond = pkg.layers.less_than(i, n)
        w = pkg.layers.While(cond)
        with w.block():
            doubled = pkg.layers.elementwise_add(x, x)
            pkg.layers.assign(doubled, output=x)
            pkg.layers.increment(i, value=1, in_place=True)
            pkg.layers.less_than(i, n, cond=cond)
    return main, startup, x, i


def test_while_takes_the_interpreter_and_gives_the_jax_compiled_result():
    feed = {"x0": np.array([1.0, 2.0, 3.0, 4.0], dtype="float32")}
    jmain, jstartup, jx, ji = _while_program(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    assert jexe._can_whole_compile(jmain)
    with jfluid.scope_guard(jfluid.Scope()):
        jexe.run(jstartup)
        jc = jax_compiled(jexe._core, jmain, jfluid.global_scope(), feed,
                          [jx, ji])
    with jfluid.scope_guard(jfluid.Scope()):
        jexe.run(jstartup)
        jint = JaxCore(jfluid.CPUPlace()).run_program(
            jmain, jfluid.global_scope(), feed, [jx, ji], True)

    main, startup, x, i = _while_program(fluid)
    assert pce.untraceable_reasons(main.global_block()) == \
        jce.untraceable_reasons(jmain.global_block()) == []
    assert block_seqs(main) == block_seqs(jmain)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    pce.reset_counters()
    out, i_out = exe.run(main, feed=feed, fetch_list=[x, i], scope=scope)
    assert pce.counters()["executor.compile_fallbacks"] == 0
    assert pce.counters()["executor.steps"] == 1
    np.testing.assert_array_equal(out, feed["x0"] * 32.0)
    np.testing.assert_array_equal(out, np.asarray(jc[0]))
    np.testing.assert_array_equal(out, np.asarray(jint[0]))
    assert int(i_out.reshape(-1)[0]) == int(np.asarray(jc[1]).reshape(-1)[0]) \
        == 5
    # a second run is the same and counts no second fallback
    out2, _ = exe.run(main, feed=feed, fetch_list=[x, i], scope=scope)
    np.testing.assert_array_equal(out2, out)
    assert pce.counters()["executor.compile_fallbacks"] == 0


def test_a_while_program_saves_and_loads_with_its_sub_block(tmp_path):
    """A program holding a while op round-trips through the JSON form
    (its sub_block attr as the block's index) and runs as before."""
    from paddle_tpu_torch import io

    main, startup, x, i = _while_program(fluid)
    back = io._deserialize_program(io._serialize_program(main))
    assert block_seqs(back) == block_seqs(main)
    assert back.global_block().ops[-1].attrs["sub_block"] is back.blocks[1]
    feed = {"x0": np.arange(4, dtype="float32")}
    outs = []
    for prog in (main, back):
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        outs.append(exe.run(prog, feed=feed, fetch_list=[x.name],
                            scope=scope)[0])
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], feed["x0"] * 32)


def _cond_block_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[4], dtype="float32")
        flag = pkg.data(name="flag", shape=[1], dtype="bool")
        y = pkg.layers.assign(x)
        blk = main.current_block()
        sub = main._create_block()
        tripled = pkg.layers.scale(y, scale=3.0)
        pkg.layers.assign(tripled, output=y)
        main._rollback()
        blk.append_op("conditional_block", inputs={"Cond": [flag]},
                      outputs={}, attrs={"sub_block": sub,
                                         "is_scalar_condition": True})
    return main, startup, y


@pytest.mark.parametrize("flag,want", [(True, 3.0), (False, 1.0)])
def test_conditional_block_both_branches(flag, want):
    feed = {"x": np.ones(4, dtype="float32"), "flag": np.array([flag])}
    jmain, jstartup, jy = _cond_block_program(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        jexe.run(jstartup)
        (jout,) = jexe.run(jmain, feed=feed, fetch_list=[jy])
    main, startup, y = _cond_block_program(fluid)
    assert pce.untraceable_reasons(main.global_block()) == \
        jce.untraceable_reasons(jmain.global_block()) == []
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    (out,) = exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    np.testing.assert_array_equal(out, np.full(4, want, "float32"))
    np.testing.assert_array_equal(out, np.asarray(jout))


# -- tests/test_while_grad.py ------------------------------------------------

T, B, D = 4, 3, 5


def while_rnn(pkg, carry_stop_gradient=False, trips=T, wname="w_rnn"):
    """h_{t+1} = tanh(h_t @ W + x), trained with SGD on mean(h_T)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[B, D], dtype="float32")
        w = pkg.layers.create_parameter([D, D], "float32", name=wname)
        h = pkg.layers.fill_constant([B, D], "float32", 0.0)
        if not carry_stop_gradient:
            h.stop_gradient = False
        i = pkg.layers.fill_constant([1], "int64", 0)
        n = pkg.layers.fill_constant([1], "int64", trips)
        cond = pkg.layers.less_than(i, n)
        wh = pkg.layers.While(cond)
        with wh.block():
            nh = pkg.layers.tanh(pkg.layers.elementwise_add(
                pkg.layers.matmul(h, w), x))
            pkg.layers.assign(nh, h)
            pkg.layers.increment(i, value=1, in_place=True)
            pkg.layers.less_than(i, n, cond=cond)
        loss = pkg.layers.reduce_mean(h)
        pkg.optimizer.SGDOptimizer(0.5).minimize(loss)
    return main, startup, [loss, w]


def unrolled_rnn(pkg, trips=T):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[B, D], dtype="float32")
        w = pkg.layers.create_parameter([D, D], "float32", name="w_rnn")
        h = pkg.layers.fill_constant([B, D], "float32", 0.0)
        h.stop_gradient = False
        for _ in range(trips):
            h = pkg.layers.tanh(pkg.layers.elementwise_add(
                pkg.layers.matmul(h, w), x))
        loss = pkg.layers.reduce_mean(h)
        pkg.optimizer.SGDOptimizer(0.5).minimize(loss)
    return main, startup, [loss, w]


def _train_port(build, w0, feeds):
    main, startup, fetch = build(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.scope_from_numpy(scope, {fetch[1].name: w0}, fluid.CPUPlace())
    out = [[np.asarray(v) for v in exe.run(main, feed=f, fetch_list=fetch,
                                           scope=scope)] for f in feeds]
    return out, main


@pytest.mark.parametrize("carry_stop_gradient", [False, True])
def test_while_training_matches_unrolled_and_the_jax_package(
        carry_stop_gradient):
    rng = np.random.RandomState(0)
    xv = rng.randn(B, D).astype("float32")
    w0 = (rng.randn(D, D) * 0.4).astype("float32")
    feeds = [{"x": xv}] * 3
    got, main = _train_port(
        lambda pkg: while_rnn(pkg, carry_stop_gradient), w0, feeds)
    assert "while_grad" in [op.type for op in main.global_block().ops]
    want, _ = _train_port(unrolled_rnn, w0, feeds)
    losses = [float(s[0].reshape(-1)[0]) for s in got]
    assert abs(losses[1] - losses[0]) > 1e-6, losses  # w trains
    for g, u in zip(got, want):
        RN._close(g[0], u[0], "loss")
        RN._close(g[1], u[1], "w")
    # the JAX package's while (the same program) from the same w
    (j, jstate), (p, pstate), (jmain, pmain) = LS.train_both(
        lambda pkg: while_rnn(pkg, carry_stop_gradient), feeds)
    assert block_seqs(pmain) == block_seqs(jmain)
    for js, ps in zip(j, p):
        RN._close(ps[0], js[0], "loss")
        RN._close(ps[1], js[1], "w")


def test_while_grad_zero_trip():
    """A loop whose condition is false from the start: the carry's grad
    passes through and the op before the loop trains."""
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data(name="x", shape=[B, D], dtype="float32")
            w = pkg.layers.create_parameter([D, D], "float32", name="w_z")
            h = pkg.layers.matmul(x, w)
            i = pkg.layers.fill_constant([1], "int64", 5)
            n = pkg.layers.fill_constant([1], "int64", 3)
            cond = pkg.layers.less_than(i, n)  # false at once
            wh = pkg.layers.While(cond)
            with wh.block():
                nh = pkg.layers.scale(h, scale=2.0)
                pkg.layers.assign(nh, h)
                pkg.layers.increment(i, value=1, in_place=True)
                pkg.layers.less_than(i, n, cond=cond)
            loss = pkg.layers.reduce_mean(h)
            pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
        return main, startup, [loss, w]

    rng = np.random.RandomState(1)
    feeds = [{"x": rng.randn(B, D).astype("float32")} for _ in range(2)]
    (j, _), (p, pstate), _ = LS.train_both(build, feeds)
    for js, ps in zip(j, p):
        RN._close(ps[0], js[0], "loss")
        RN._close(ps[1], js[1], "w")
    assert np.abs(p[1][1] - p[0][1]).max() > 1e-8  # grads went round


# -- IfElse, cond, the arrays ------------------------------------------------

def _ifelse(pkg):
    N, Dx = 6, 4
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[N, Dx], dtype="float32")
        label = pkg.data(name="label", shape=[N, 1], dtype="float32")
        limit = pkg.layers.fill_constant([1], "float32", 0.0)
        cond = pkg.layers.less_than(label, limit)
        ie = pkg.layers.IfElse(cond)
        with ie.true_block():
            t = ie.input(x)
            ie.output(pkg.layers.fc(t, size=3, act="tanh"))
        with ie.false_block():
            f = ie.input(x)
            ie.output(pkg.layers.scale(pkg.layers.fc(f, size=3), 2.0))
        (out,) = ie()
        loss = pkg.layers.mean(out)
        pkg.optimizer.SGD(0.5).minimize(loss)
    return main, startup, [loss, out]


def test_ifelse_trains_as_the_jax_package():
    rng = np.random.RandomState(2)
    feeds = [{"x": rng.randn(6, 4).astype("float32"),
              "label": np.array([[1], [-1], [-2], [3], [-1], [0.5]],
                                "float32")} for _ in range(3)]
    p, _ = RN.both(_ifelse, feeds)
    assert p[0][1].shape == (6, 3)


def test_ifelse_with_one_branch_empty():
    """Every row false: the true branch runs on zero rows."""
    feeds = [{"x": np.ones((6, 4), "float32"),
              "label": np.ones((6, 1), "float32")}]
    RN.both(_ifelse, feeds)


def _cond(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[3, 4], dtype="float32")
        flag = pkg.data(name="flag", shape=[3, 4], dtype="bool")
        h = pkg.layers.fc(x, size=4)
        out = pkg.layers.cond(flag, lambda: pkg.layers.tanh(h),
                              lambda: pkg.layers.scale(h, 3.0))
        loss = pkg.layers.mean(out)
        pkg.optimizer.SGD(0.5).minimize(loss)
    return main, startup, [loss, out]


def test_cond_trains_as_the_jax_package():
    rng = np.random.RandomState(3)
    feeds = [{"x": rng.randn(3, 4).astype("float32"),
              "flag": rng.rand(3, 4) > 0.5} for _ in range(2)]
    RN.both(_cond, feeds)


def _arrays(pkg):
    """Three tensors written to an array at constant indices and read
    back; the reads' grads go to the writes."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[2, 3], dtype="float32")
        h = pkg.layers.fc(x, size=3)
        idx = [pkg.layers.fill_constant([1], "int64", k) for k in range(3)]
        arr = pkg.layers.array_write(h, idx[0])
        pkg.layers.array_write(pkg.layers.scale(h, 2.0), idx[1], array=arr)
        pkg.layers.array_write(pkg.layers.tanh(h), idx[2], array=arr)
        n = pkg.layers.array_length(arr)
        r0 = pkg.layers.array_read(arr, idx[0])
        r2 = pkg.layers.array_read(arr, idx[2])
        r0.shape = r2.shape = (2, 3)  # an array's entries carry no shape
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(r0, r2))
        pkg.optimizer.SGD(0.5).minimize(loss)
    return main, startup, [loss, n, r2]


def test_arrays_train_as_the_jax_package():
    rng = np.random.RandomState(4)
    feeds = [{"x": rng.randn(2, 3).astype("float32")} for _ in range(2)]
    p, _ = RN.both(_arrays, feeds)
    assert int(p[0][1].reshape(-1)[0]) == 3


def _array_loop(pkg):
    """A dense recurrence over steps kept in an array: the steps are
    written before the loop, the body reads step i, updates h and writes
    it to an output array; the loss reads the last output."""
    Tn = 3
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[Tn, 2, 4], dtype="float32")
        w = pkg.layers.create_parameter([4, 4], "float32", name="w_arr")
        steps = None
        for t in range(Tn):
            xt = pkg.layers.reshape(pkg.layers.slice(
                x, axes=[0], starts=[t], ends=[t + 1]), [2, 4])
            it = pkg.layers.fill_constant([1], "int64", t)
            steps = pkg.layers.array_write(xt, it, array=steps)
        outs = pkg.layers.create_array("float32")
        h = pkg.layers.fill_constant([2, 4], "float32", 0.0)
        i = pkg.layers.fill_constant([1], "int64", 0)
        n = pkg.layers.fill_constant([1], "int64", Tn)
        cond = pkg.layers.less_than(i, n)
        wh = pkg.layers.While(cond)
        with wh.block():
            xt = pkg.layers.array_read(steps, i)
            xt.shape = (2, 4)
            nh = pkg.layers.tanh(pkg.layers.elementwise_add(
                pkg.layers.matmul(h, w), xt))
            pkg.layers.assign(nh, h)
            pkg.layers.array_write(nh, i, array=outs)
            pkg.layers.increment(i, value=1, in_place=True)
            pkg.layers.less_than(i, n, cond=cond)
        last = pkg.layers.array_read(
            outs, pkg.layers.fill_constant([1], "int64", Tn - 1))
        last.shape = (2, 4)
        n_out = pkg.layers.array_length(outs)
        loss = pkg.layers.reduce_mean(last)
        pkg.optimizer.SGD(0.5).minimize(loss)
    return main, startup, [loss, w, n_out]


def test_array_loop_trains_as_the_jax_package():
    rng = np.random.RandomState(5)
    feeds = [{"x": rng.randn(3, 2, 4).astype("float32")} for _ in range(2)]
    (j, jstate), (p, pstate), (jmain, pmain) = LS.train_both(_array_loop,
                                                             feeds)
    assert block_seqs(pmain) == block_seqs(jmain)
    for js, ps in zip(j, p):
        for a, b in zip(ps, js):
            RN._close(a.astype(b.dtype) if np.issubdtype(b.dtype, np.integer)
                      else a, b, "fetch")
    assert int(p[0][2].reshape(-1)[0]) == 3
    RN._close_state(pstate, jstate)


def test_print_and_select_ops(capsys):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[2, 3], dtype="float32")
        y = fluid.layers.Print(x, message="seen:")
        block = main.global_block()
        mask = fluid.layers.fill_constant([1], "int32", 1)
        a = fluid.layers.scale(x, 2.0)
        sel = block.create_var(name="sel", shape=(2, 3), dtype="float32")
        block.append_op("select_input", inputs={"X": [x, a], "Mask": [mask]},
                        outputs={"Out": [sel]}, infer_shape=False)
        o0 = block.create_var(name="o0", shape=(2, 3), dtype="float32")
        o1 = block.create_var(name="o1", shape=(2, 3), dtype="float32")
        block.append_op("select_output", inputs={"X": [x], "Mask": [mask]},
                        outputs={"Out": [o0, o1]}, infer_shape=False)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    xv = np.arange(6, dtype="float32").reshape(2, 3)
    out_y, out_sel, out_o1 = exe.run(main, feed={"x": xv},
                                     fetch_list=[y, sel, o1], scope=scope)
    assert "seen:" in capsys.readouterr().out
    np.testing.assert_array_equal(out_y, xv)
    np.testing.assert_array_equal(out_sel, 2 * xv)
    np.testing.assert_array_equal(out_o1, xv)
    assert scope.find_var("o0") is None or \
        not scope.find_var("o0").is_initialized()
    assert isinstance(scope.find_var("x").get_tensor().array, torch.Tensor)
