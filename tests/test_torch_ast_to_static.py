"""dygraph-to-static (``@declarative``, the AST conversion) in the port
against the JAX package, on the CPU.

One parametrised twin for each of the 28 cases of
``tests/test_ast_to_static.py``. Each case is one script written against
either package (``pkg``, its ``declarative``), run by the JAX package as
its own tests run it and by the port under ``dygraph.guard(CPUPlace())``
(a converted function runs on the guard's place). For each it compares:

- every result the case produces (arrays within 1e-6 relative: the same
  float32 math; integers and booleans exactly), and the number of
  programs each function's cache holds;
- the op types of each built Program, block by block (less the extra
  cast the JAX package's int32 trip count takes);
- the error a case expects: its type and its message.

The cases keep the JAX file's class and test names.
"""
import warnings

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.dygraph import dygraph_to_static as jd2s
from paddle_tpu_torch.dygraph import dygraph_to_static as pd2s

RTOL = 1e-6


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _types(program):
    """Op types block by block, less a cast of a cast's output: the JAX
    package keeps an int64 var as int32 (x64 off), so its tensor range
    casts the trip count to int64 once more."""
    out = []
    for b in program.blocks:
        cast_outs, types = set(), []
        for op in b.ops:
            if op.type == "cast":
                if op.input("X")[0] in cast_outs:
                    continue
                cast_outs.update(op.output("Out"))
            types.append(op.type)
        out.append(types)
    return out


class _Run:
    """What a case saw: results, program op types, cache sizes."""

    def __init__(self, pkg, declarative):
        self.pkg, self.declarative = pkg, declarative
        self.seen = []

    def value(self, label, v):
        if hasattr(v, "numpy"):
            v = v.numpy()
        self.seen.append((label, np.asarray(v)))

    def program(self, label, fn, *args):
        self.seen.append((label, _types(fn.get_program(*args))))

    def cache(self, label, fn):
        self.seen.append((label, len(fn._cache)))

    def error(self, label, call, match=None):
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                call()
        except Exception as e:  # the type and message are compared
            self.seen.append((label, (type(e).__name__, match is None or
                                      match(str(e)))))
        else:
            self.seen.append((label, None))


# -- TestTensorIf -------------------------------------------------------------

def case_both_branches_one_program(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def f(x):
        if fl.layers.reduce_sum(x) > 0:
            y = x + 1.0
        else:
            y = x - 1.0
        return y

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r.value("pos", f(_f32(np.ones((2, 3)))))
        r.value("neg", f(_f32(-np.ones((2, 3)))))
    r.cache("programs", f)
    r.program("ops", f, _f32(np.ones((2, 3))))


def case_name_assigned_in_one_branch_keeps_outer_value(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def f(x):
        y = x * 2.0
        if fl.layers.reduce_sum(x) > 0:
            y = x * 3.0
        return y

    r.value("pos", f(_f32([1.0, 1.0])))
    r.value("neg", f(_f32([-1.0, -1.0])))
    r.program("ops", f, _f32([1.0, 1.0]))


def case_bool_ops_in_condition(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def f(x, y):
        if fl.layers.reduce_sum(x) > 0 and \
                fl.layers.reduce_sum(y) > 0:
            out = x + y
        else:
            out = x - y
        return out

    r.value("a", f(_f32([1.0]), _f32([2.0])))
    r.value("b", f(_f32([1.0]), _f32([-2.0])))
    r.program("ops", f, _f32([1.0]), _f32([2.0]))


def case_logical_not(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def f(x):
        if not (fl.layers.reduce_sum(x) > 0):
            out = x * 0.0
        else:
            out = x * 1.0
        return out

    r.value("pos", f(_f32([5.0])))
    r.value("neg", f(_f32([-5.0])))
    r.program("ops", f, _f32([5.0]))


def case_python_condition_stays_python(r):
    declarative = r.declarative

    @declarative
    def f(x, flag):
        if flag:
            return x + 10.0
        return x - 10.0

    r.value("true", f(_f32([1.0]), True))
    r.value("false", f(_f32([1.0]), False))
    r.cache("programs", f)
    r.program("ops", f, _f32([1.0]), True)


# -- TestTensorWhile ----------------------------------------------------------

def case_while_compiles_to_while_op(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def g(x):
        s = x
        while fl.layers.reduce_sum(s) < 100.0:
            s = s * 2.0
        return s

    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*falls back to op-by-op.*")
        r.value("r1", g(_f32(np.full((4,), 1.0))))
    r.value("r2", g(_f32(np.full((4,), 30.0))))
    r.program("ops", g, _f32(np.full((4,), 1.0)))
    r.cache("programs", g)


def case_scalar_counter_promoted(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def g(n):
        i = 0
        acc = n * 0.0
        while i < fl.layers.reduce_sum(n):
            acc = acc + 2.0
            i = i + 1
        return acc

    r.value("out", g(_f32([3.0])))
    r.program("ops", g, _f32([3.0]))


def case_if_inside_while(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def g(x):
        s = x
        while fl.layers.reduce_sum(s) < 10.0:
            if fl.layers.reduce_sum(s) < 5.0:
                s = s + 2.0
            else:
                s = s + 1.0
        return s

    r.value("out", g(_f32([1.0])))
    r.program("ops", g, _f32([1.0]))


def case_break_in_tensor_while(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def f(x):
        s = x
        while fl.layers.reduce_sum(s) < 100.0:
            s = s * 2.0
            if fl.layers.reduce_sum(s) > 50.0:
                break
            s = s + 1.0
        return s

    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*falls back to op-by-op.*")
        r.value("out", f(_f32(np.full((4,), 1.0))))
    r.program("ops", f, _f32(np.full((4,), 1.0)))


def case_continue_in_tensor_while(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def g(x):
        acc = x * 0.0
        while fl.layers.reduce_sum(acc) < 10.0:
            acc = acc + 1.0
            if fl.layers.reduce_sum(acc) > 5.0:
                continue
            acc = acc + 1.0
        return acc

    r.value("out", g(_f32([0.0])))
    r.program("ops", g, _f32([0.0]))


def case_break_python_mode_exact(r):
    declarative = r.declarative

    @declarative
    def f(x, n):
        i = 0
        while i < n:
            if i == 3:
                break
            x = x + 1.0
            i += 1
        return x

    r.value("out", f(_f32([0.0]), 10))
    r.program("ops", f, _f32([0.0]), 10)


def case_break_in_nested_for_else_binds_to_outer(r):
    declarative = r.declarative

    @declarative
    def f(x, n):
        i = 0
        while i < n:
            for j in range(3):
                x = x + 1.0
            else:
                break
        return x

    r.value("out", f(_f32([0.0, 0.0]), 5))
    r.program("ops", f, _f32([0.0, 0.0]), 5)


def case_python_while_unchanged(r):
    declarative = r.declarative

    @declarative
    def g(x, n):
        i = 0
        while i < n:
            x = x + 1.0
            i += 1
        return x

    r.value("out", g(_f32([0.0]), 4))
    r.program("ops", g, _f32([0.0]), 4)


# -- TestForRange -------------------------------------------------------------

def case_python_range_unrolls(r):
    declarative = r.declarative

    @declarative
    def h(x):
        for i in range(3):
            x = x + 1.0
        return x

    r.value("out", h(_f32([0.0])))
    r.program("ops", h, _f32([0.0]))


def case_tensor_range_lowers_to_while(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def h(x):
        n = fl.layers.cast(fl.layers.reduce_sum(x), "int64")
        acc = x * 0.0
        for i in range(n):
            acc = acc + 3.0
        return acc

    r.value("out", h(_f32([2.0, 2.0])))
    r.program("ops", h, _f32([2.0, 2.0]))


def case_negative_step_tensor_range(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def h(x):
        n = fl.layers.cast(fl.layers.reduce_sum(x), "int64")
        acc = fl.layers.fill_constant([1], "int64", 0)
        for i in range(n, 0, -1):
            acc = acc + i
        return acc

    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*falls back to op-by-op.*")
        r.value("out", h(_f32([2.0, 2.0])))
    r.program("ops", h, _f32([2.0, 2.0]))


def case_for_target_bound_after_loop(r):
    declarative = r.declarative

    @declarative
    def h(x):
        for i in range(3):
            x = x + 1.0
        return x * i

    r.value("out", h(_f32([0.0])))
    r.program("ops", h, _f32([0.0]))


def case_iteration_var_used_in_body(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def h(x):
        n = fl.layers.cast(fl.layers.reduce_sum(x), "int64")
        acc = fl.layers.fill_constant([1], "int64", 0)
        for i in range(n):
            acc = acc + i
        return acc

    r.value("out", h(_f32([2.0, 3.0])))
    r.program("ops", h, _f32([2.0, 3.0]))


# -- TestErrorsAndGuards ------------------------------------------------------

def case_static_variable_bool_raises(r):
    fl = r.pkg
    prog = fl.Program()
    with fl.program_guard(prog, fl.Program()):
        v = fl.layers.fill_constant([1], "bool", 1.0)
        r.error("bool", lambda: bool(v), lambda m: "boolean value" in m)


def case_varbase_bool_is_concrete(r):
    fl = r.pkg
    v = fl.dygraph.to_variable(_f32([3.0]))
    r.value("gt1", bool(v > 1.0))
    r.value("gt5", bool(v > 5.0))
    iv = fl.dygraph.to_variable(np.array([0], dtype=np.int32))
    r.value("int", bool(iv > -0.5))
    r.error("ambiguous", lambda: bool(fl.dygraph.to_variable(
        _f32([1.0, 2.0]))), lambda m: "ambiguous" in m)


def case_undefined_loop_var_raises(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def g(x):
        while fl.layers.reduce_sum(x) < 0.0:
            y = x + 1.0
            x = y
        return x

    import re

    r.error("undefined", lambda: g(_f32([1.0])),
            lambda m: bool(re.search("initialize|NameError|no value", m)))


# -- TestTraceFallback --------------------------------------------------------

def case_dygraph_layer_falls_back_to_trace(r):
    fl, declarative = r.pkg, r.declarative
    fc = fl.dygraph.Linear(4, 2)
    rng = np.random.RandomState(3)
    fc.weight.set_value(rng.randn(4, 2).astype("float32"))
    fc.bias.set_value(rng.randn(2).astype("float32"))

    @declarative
    def model(x):
        return fl.layers.reduce_sum(fc(x))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = model(fl.dygraph.to_variable(_f32(np.ones((1, 4)))))
    r.value("out", np.asarray(out.numpy()).reshape(-1))
    r.seen.append(("kind", [e["kind"] for e in model._cache.values()]))
    r.seen.append(("ops", [[op.type for op in e["program"].global_block().ops]
                           for e in model._cache.values()]))


# -- TestNestedIf -------------------------------------------------------------

def case_tensor_if_nested_in_tensor_if(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def f(x):
        if fl.layers.reduce_sum(x) > 0:
            if fl.layers.reduce_sum(x) > 10.0:
                y = x * 3.0
            else:
                y = x * 2.0
        else:
            y = x - 1.0
        return y

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r.value("hi", f(_f32([6.0, 6.0])))
        r.value("mid", f(_f32([1.0, 1.0])))
        r.value("neg", f(_f32([-1.0, -1.0])))
    r.cache("programs", f)
    r.program("ops", f, _f32([6.0, 6.0]))


def case_python_if_nested_in_tensor_if(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def f(x):
        k = 2.0
        if fl.layers.reduce_sum(x) > 0:
            if k > 1.0:
                y = x * k
            else:
                y = x
        else:
            y = x - 1.0
        return y

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r.value("pos", f(_f32([3.0])))
        r.value("neg", f(_f32([-3.0])))
    r.program("ops", f, _f32([3.0]))


def case_equal_numpy_arrays_in_branches_merge(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def f(x):
        if fl.layers.reduce_sum(x) > 0:
            c = np.ones(2, dtype=np.float32)  # noqa: F841
            y = x + 1.0
        else:
            c = np.ones(2, dtype=np.float32)  # noqa: F841
            y = x - 1.0
        return y

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r.value("pos", f(_f32([2.0])))
        r.value("neg", f(_f32([-2.0])))
    r.program("ops", f, _f32([2.0]))


def case_differing_nontensor_branch_values_diagnose(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def f(x):
        if fl.layers.reduce_sum(x) > 0:
            c = np.ones(2, dtype=np.float32)  # noqa: F841
        else:
            c = np.zeros(2, dtype=np.float32)  # noqa: F841
        return x

    r.error("diagnose", lambda: f(_f32([2.0])),
            lambda m: "differ between" in m)


# -- TestProgramCacheBound ----------------------------------------------------

def case_cache_is_lru_bounded(r):
    declarative = r.declarative

    @declarative
    def f(x, cfg):
        return x * 2.0

    f._cache_cap = 3
    objs = [object() for _ in range(6)]
    for o in objs:
        r.value("out", f(_f32([1.0]), o))
    r.cache("programs", f)
    r.seen.append(("pins", len([p for e in f._cache.values()
                                for p in e.get("pins", [])])))


def case_equal_lists_and_np_scalars_merge(r):
    fl, declarative = r.pkg, r.declarative

    @declarative
    def f(x):
        if fl.layers.reduce_sum(x) > 0:
            c = [1, 2]  # noqa: F841
            d = np.float32(0.5)  # noqa: F841
            y = x + 1.0
        else:
            c = [1, 2]  # noqa: F841
            d = np.float32(0.5)  # noqa: F841
            y = x - 1.0
        return y

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r.value("pos", f(_f32([2.0])))
        r.value("neg", f(_f32([-2.0])))
    r.program("ops", f, _f32([2.0]))


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


def _run_jax(case):
    r = _Run(jfluid, jd2s.declarative)
    if case in (case_varbase_bool_is_concrete,
                case_dygraph_layer_falls_back_to_trace):
        with jfluid.dygraph.guard():
            case(r)
    else:
        case(r)
    return r.seen


def _run_port(case):
    r = _Run(fluid, pd2s.declarative)
    if case is case_static_variable_bool_raises:  # builds, runs nothing
        case(r)
        return r.seen
    with fluid.dygraph.guard(fluid.CPUPlace()):
        case(r)
    return r.seen


def test_the_file_has_its_28_cases():
    assert len(CASES) == 28


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_case(case):
    want, got = _run_jax(case), _run_port(case)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (label, g), (_, w) in zip(got, want):
        if isinstance(w, np.ndarray):
            g = np.asarray(g)
            assert g.size == w.size, (label, g, w)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g.reshape(w.shape), w, rtol=RTOL,
                                           err_msg=label)
            else:
                np.testing.assert_array_equal(
                    g.reshape(w.shape).astype(np.int64), w.astype(np.int64),
                    err_msg=label)
        else:
            assert g == w, (label, g, w)
