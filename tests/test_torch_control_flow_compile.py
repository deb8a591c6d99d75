"""Control flow on the whole-program route: the port against the JAX
package, on the CPU.

Twins of ``tests/test_control_flow_compile.py``, widened to every case the
route meets. Each case is one program built by one script against either
package, from the same numpy-seeded feed. For each it checks:

- ``untraceable_reasons`` equal to the JAX package's;
- the route each package's ``Executor`` takes: the whole-program route
  (no fallback counted) where the JAX package compiles the program, the
  interpreter where it does not (a ``while_grad`` host op, ``IfElse``'s
  row split, the tensor arrays);
- the port's fetches through its ``Executor`` against the JAX package's
  compiled route (its interpreter where it declines) and against the
  port's own interpreter.

And the declines of the port's route that the JAX package meets as an
error at trace time: a carry whose shape changes across trips and a
non-scalar ``conditional_block``, each counted, named and interpreted from
untouched state.

Tolerances: float32 fetches within 1e-5 relative (the same float32 math;
XLA may fuse it in another order); integers and booleans exactly.
"""
import warnings

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.core import compiler_engine as jce
from paddle_tpu.core.executor_core import CoreExecutor as JaxCore
from paddle_tpu_torch.core import compiler_engine as pce

RTOL = 1e-5


def _while_doubling(pkg, rng):
    """x doubles 5 times: while (i < 5) { x = 2x; i += 1 }"""
    L = pkg.layers
    x0 = pkg.data(name="x0", shape=[4], dtype="float32")
    x = L.assign(x0)
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    n = L.fill_constant(shape=[1], dtype="int64", value=5)
    cond = L.less_than(i, n)
    with L.While(cond).block():
        L.assign(L.elementwise_add(x, x), output=x)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, n, cond=cond)
    return {"x0": rng.randn(4).astype("float32")}, [x, i]


def _cond_block(flag):
    def build(pkg, rng):
        L = pkg.layers
        main = pkg.default_main_program()
        x = pkg.data(name="x", shape=[4], dtype="float32")
        f = pkg.data(name="flag", shape=[1], dtype="bool")
        y = L.assign(x)
        blk = main.current_block()
        sub = main._create_block()
        L.assign(L.scale(y, scale=3.0), output=y)
        main._rollback()
        blk.append_op("conditional_block", inputs={"Cond": [f]}, outputs={},
                      attrs={"sub_block": sub, "is_scalar_condition": True})
        return {"x": rng.randn(4).astype("float32"),
                "flag": np.array([flag])}, [y]
    return build


def _nested_while(pkg, rng):
    """while (i < 3) { j = 0; while (j < 2) { x = 2x; j += 1 }; x += 1 }"""
    L = pkg.layers
    x0 = pkg.data(name="x0", shape=[2, 3], dtype="float32")
    x = L.assign(x0)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    m = L.fill_constant([1], "int64", 2)
    j = L.fill_constant([1], "int64", 0)
    c = L.less_than(i, n)
    with L.While(c).block():
        L.assign(L.fill_constant([1], "int64", 0), output=j)
        c2 = L.less_than(j, m)
        with L.While(c2).block():
            L.assign(L.scale(x, scale=2.0), output=x)
            L.increment(j, value=1, in_place=True)
            L.less_than(j, m, cond=c2)
        L.assign(L.scale(x, scale=1.0, bias=1.0), output=x)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, n, cond=c)
    return {"x0": rng.randn(2, 3).astype("float32")}, [x, i, j]


def _zero_trip(pkg, rng):
    L = pkg.layers
    x0 = pkg.data(name="x0", shape=[3], dtype="float32")
    x = L.assign(x0)
    i = L.fill_constant([1], "int64", 5)
    n = L.fill_constant([1], "int64", 3)
    c = L.less_than(i, n)
    with L.While(c).block():
        L.assign(L.scale(x, scale=2.0), output=x)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, n, cond=c)
    return {"x0": rng.randn(3).astype("float32")}, [x, i]


def _while_loop(pkg, rng):
    L = pkg.layers
    x0 = pkg.data(name="x0", shape=[4], dtype="float32")
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 4)
    x = L.assign(x0)
    i, x = L.while_loop(lambda i, x: L.less_than(i, n),
                        lambda i, x: [L.increment(i, value=1),
                                      L.tanh(L.scale(x, scale=1.5))],
                        [i, x])
    return {"x0": rng.randn(4).astype("float32")}, [i, x]


def _cond(pkg, rng):
    L = pkg.layers
    x = pkg.data(name="x", shape=[4, 3], dtype="float32")
    p = pkg.data(name="p", shape=[4, 3], dtype="bool")
    out = L.cond(p, lambda: L.tanh(x), lambda: L.scale(x, scale=3.0))
    return {"x": rng.randn(4, 3).astype("float32"),
            "p": rng.rand(4, 3) > 0.5}, [out]


def _swapped(pkg, rng):
    """a, b = b, a three times, with a new b that views a's buffer: its
    copy must be read before a's buffer is written."""
    L = pkg.layers
    a0 = pkg.data(name="a0", shape=[2, 3], dtype="float32")
    b0 = pkg.data(name="b0", shape=[2, 3], dtype="float32")
    a, b = L.assign(a0), L.assign(b0)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    c = L.less_than(i, n)
    with L.While(c).block():
        blk = pkg.default_main_program().current_block()
        tmp = L.scale(b, scale=1.0)
        xs = blk.create_var(name="swap_xshape", dtype="float32")
        blk.append_op("reshape2", inputs={"X": [a]},
                      outputs={"Out": [b], "XShape": [xs]},
                      attrs={"shape": [2, 3]})
        L.assign(tmp, output=a)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, n, cond=c)
    return {"a0": rng.randn(2, 3).astype("float32"),
            "b0": rng.randn(2, 3).astype("float32")}, [a, b]


def _while_train(pkg, rng):
    """chip_smoke.py phase 41's recurrence at narrow width: a while_grad
    host op keeps it off the route in both packages."""
    L = pkg.layers
    B, D, T = 4, 8, 3
    x = pkg.data(name="x", shape=[B, D], dtype="float32")
    w = L.create_parameter([D, D], "float32", name="w_while",
                           default_initializer=pkg.initializer.Constant(0.1))
    h = L.fill_constant([B, D], "float32", 0.0)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", T)
    cond = L.less_than(i, n)
    with L.While(cond).block():
        L.assign(L.tanh(L.elementwise_add(L.matmul(h, w), x)), h)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, n, cond=cond)
    loss = L.reduce_mean(h)
    pkg.optimizer.SGDOptimizer(0.5).minimize(loss)
    return {"x": rng.randn(B, D).astype("float32")}, [loss, w]


def _ifelse(pkg, rng):
    L = pkg.layers
    x = pkg.data(name="x", shape=[6, 3], dtype="float32")
    label = pkg.data(name="label", shape=[6, 1], dtype="float32")
    cond = L.less_than(label, L.fill_constant([1], "float32", 0.0))
    ie = L.IfElse(cond)
    with ie.true_block():
        ie.output(L.tanh(ie.input(x)))
    with ie.false_block():
        ie.output(L.scale(ie.input(x), 2.0))
    (out,) = ie()
    return {"x": rng.randn(6, 3).astype("float32"),
            "label": rng.randn(6, 1).astype("float32")}, [out]


def _array_loop(pkg, rng):
    L = pkg.layers
    T, N, D = 3, 2, 4
    x = pkg.data(name="x", shape=[T, N, D], dtype="float32")
    steps = None
    for t in range(T):
        xt = L.reshape(L.slice(x, axes=[0], starts=[t], ends=[t + 1]),
                       [N, D])
        steps = L.array_write(xt, L.fill_constant([1], "int64", t),
                              array=steps)
    h = L.fill_constant([N, D], "float32", 0.0)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", T)
    c = L.less_than(i, n)
    with L.While(c).block():
        xt = L.array_read(steps, i)
        xt.shape = (N, D)
        L.assign(L.tanh(L.elementwise_add(h, xt)), h)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, n, cond=c)
    return {"x": rng.randn(T, N, D).astype("float32")}, [h]


# name -> (builder, takes the whole-program route in both packages)
CASES = {
    "while": (_while_doubling, True),
    "conditional_block_true": (_cond_block(True), True),
    "conditional_block_false": (_cond_block(False), True),
    "nested_while": (_nested_while, True),
    "zero_trip_while": (_zero_trip, True),
    "while_loop": (_while_loop, True),
    "cond": (_cond, True),
    "swapped_carry": (_swapped, True),
    "while_train": (_while_train, False),
    "ifelse": (_ifelse, False),
    "array_loop": (_array_loop, False),
}


def _build(pkg, name, seed=0):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        feed, fetch = CASES[name][0](pkg, np.random.RandomState(seed))
    return main, startup, feed, [v.name for v in fetch]


def _jax_runs(name):
    """(JAX Executor fetches, whether it fell back, its compiled route's
    or, where it declines, its interpreter's fetches)."""
    main, startup, feed, fetch = _build(jfluid, name)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            outs = exe.run(main, feed=feed, fetch_list=fetch)
    fell_back = bool(exe._compile_fallbacks)
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        if exe._can_whole_compile(main):
            ref = jce.run_compiled_program(exe._core, main,
                                           jfluid.global_scope(), feed,
                                           fetch)
        else:
            ref = JaxCore(jfluid.CPUPlace()).run_program(
                main, jfluid.global_scope(), feed, fetch, True)
    return [np.asarray(o) for o in outs], fell_back, \
        [np.asarray(o) for o in ref], main


def _port_runs(name):
    """(Executor fetches, the counters after its run, interpreter
    fetches, program)."""
    main, startup, feed, fetch = _build(fluid, name)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    pce.reset_counters()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    counters = pce.counters()
    scope2 = fluid.Scope()
    exe.run(startup, scope=scope2)
    interp = exe._core.run_program(main, scope2, feed, fetch, True)
    return [np.asarray(o) for o in outs], counters, \
        [np.asarray(o) for o in interp], main


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape or g.size == w.size, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g.reshape(w.shape), w, rtol=RTOL,
                                       atol=RTOL)
        else:
            np.testing.assert_array_equal(g.reshape(w.shape).astype(np.int64),
                                          w.astype(np.int64))


@pytest.mark.parametrize("name", sorted(CASES))
def test_reasons_route_and_fetches_match_the_jax_package(name):
    jouts, jfell, jref, jmain = _jax_runs(name)
    outs, counters, interp, main = _port_runs(name)
    reasons = pce.untraceable_reasons(main.global_block())
    assert reasons == jce.untraceable_reasons(jmain.global_block())
    compiled = CASES[name][1]
    assert (not reasons) == compiled
    assert jfell is False  # declined by its reasons, never by a failure
    assert counters["executor.compile_fallbacks"] == (0 if compiled else 1)
    assert counters["executor.steps"] == (1 if compiled else 0)
    _same(outs, jref)
    _same(outs, jouts)
    _same(outs, interp)


def test_nested_and_zero_trip_values():
    """The nested loop doubles x twice a trip and adds one, three trips;
    the zero-trip loop leaves its carries as they were."""
    outs, _, _, _ = _port_runs("nested_while")
    x0 = np.random.RandomState(0).randn(2, 3).astype("float32")
    want = x0
    for _ in range(3):
        want = want * 4.0 + 1.0
    np.testing.assert_allclose(outs[0], want, rtol=RTOL)
    assert int(outs[1].reshape(-1)[0]) == 3 and \
        int(outs[2].reshape(-1)[0]) == 2
    outs, _, _, _ = _port_runs("zero_trip_while")
    x0 = np.random.RandomState(0).randn(3).astype("float32")
    np.testing.assert_array_equal(outs[0], x0)
    assert int(outs[1].reshape(-1)[0]) == 5


def test_swapped_carries_swap():
    outs, _, _, _ = _port_runs("swapped_carry")
    rng = np.random.RandomState(0)
    a0, b0 = rng.randn(2, 3).astype("float32"), \
        rng.randn(2, 3).astype("float32")
    np.testing.assert_array_equal(outs[0], b0)  # three swaps
    np.testing.assert_array_equal(outs[1], a0)


def _growing(pkg):
    """A carry that grows a row a trip: valid for the interpreter, not a
    loop of fixed shapes."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        x0 = pkg.data(name="x0", shape=[1, 2], dtype="float32")
        x = L.assign(x0)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        c = L.less_than(i, n)
        with L.While(c).block():
            L.assign(L.concat([x, x0], axis=0), output=x)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=c)
    return main, startup, x


def _non_scalar(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        x = pkg.data(name="x", shape=[4], dtype="float32")
        f = pkg.data(name="flag", shape=[1], dtype="bool")
        y = L.assign(x)
        blk = main.current_block()
        sub = main._create_block()
        L.assign(L.scale(y, scale=3.0), output=y)
        main._rollback()
        blk.append_op("conditional_block", inputs={"Cond": [f]}, outputs={},
                      attrs={"sub_block": sub, "is_scalar_condition": False})
    return main, startup, y


@pytest.mark.parametrize("case,feed,declined", [
    ("growing", {"x0": np.ones((1, 2), "float32")},
     "while>carry %r changes from (1, 2) torch.float32 to (2, 2) "
     "torch.float32"),
    ("non_scalar", {"x": np.ones(4, "float32"), "flag": np.array([True])},
     "conditional_block (non-scalar condition)"),
])
def test_what_the_jax_trace_refuses_is_declined_and_interpreted(
        case, feed, declined):
    build = {"growing": _growing, "non_scalar": _non_scalar}[case]
    jmain, jstartup, jout = build(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        jexe.run(jstartup)
        with pytest.warns(UserWarning, match="falls back"):
            (jres,) = jexe.run(jmain, feed=feed, fetch_list=[jout])
    assert jexe._compile_fallbacks
    main, startup, out = build(fluid)
    assert pce.untraceable_reasons(main.global_block()) == \
        jce.untraceable_reasons(jmain.global_block()) == []
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    pce.reset_counters()
    with pytest.warns(UserWarning, match="falls back"):
        (res,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    want = declined % out.name if "%r" in declined else declined
    assert pce.declines() == {want: 1}
    c = pce.counters()
    assert c["executor.compile_fallbacks"] == 1 and c["executor.steps"] == 0
    np.testing.assert_array_equal(res, np.asarray(jres))
    # once a program version: the second run neither warns nor counts
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        (res2,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    np.testing.assert_array_equal(res2, res)
    assert pce.counters()["executor.compile_fallbacks"] == 1


def test_rng_in_a_loop_draws_per_trip_on_the_cpu():
    """On the CPU the route runs a loop's body eagerly, each trip with
    its own stream: a dropout in a while draws a new mask each trip."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        arr_x = fluid.data(name="x", shape=[256], dtype="float32")
        acc = L.fill_constant([3, 256], "float32", 0.0)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        c = L.less_than(i, n)
        with L.While(c).block():
            d = L.dropout(arr_x, dropout_prob=0.5,
                          dropout_implementation="upscale_in_train")
            row = L.one_hot(L.reshape(i, [1, 1]), depth=3)  # [1, 3]
            L.assign(L.elementwise_add(
                acc, L.matmul(L.transpose(row, [1, 0]),
                              L.reshape(d, [1, 256]))), output=acc)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=c)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    pce.reset_counters()
    (rows,) = exe.run(main, feed={"x": np.ones(256, "float32")},
                      fetch_list=[acc], scope=scope)
    assert pce.counters()["executor.compile_fallbacks"] == 0
    masks = rows > 0
    assert 0.3 < masks.mean() < 0.7
    assert not (masks[0] == masks[1]).all()
    assert not (masks[1] == masks[2]).all()
