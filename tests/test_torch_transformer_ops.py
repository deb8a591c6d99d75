"""The transformer slice's op functions against the JAX op functions of the
same name (both packages' registries, on the CPU), on the same seeded
numpy inputs, forward and grad: the whole elementwise ``_binary`` table,
``scale``, ``cast``, ``matmul``, every ``_reduce`` op, ``sequence_mask``,
``expand``, ``gather``, ``range`` and ``assign_value``. One parametrised
test per op family.

Tolerances: float32 within 1e-5 of the output's scale (its largest
magnitude, at least 1): the same math, summed in another order. Integer
and boolean outputs are compared by value, not dtype: JAX runs with x64
off, so its int64 comes out int32. Grads: the port's auto-VJP
(``torch.autograd.grad``) against JAX's (``jax.vjp``) with the same
random output grads, within the same limit.
"""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.core.registry import OpInfoMap as JaxOps
from paddle_tpu_torch.core.registry import DEVICE_ATTR, OpInfoMap

CPU = torch.device("cpu")
TOL = 1e-5


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _f(rng, *shape):
    return np.asarray(rng.randn(*shape), dtype="float32")


def _run(op_type, ins, attrs):
    """(JAX outputs, port outputs) of ``op_type`` as numpy arrays."""
    jinfo = JaxOps.instance().get(op_type)
    jattrs = dict(jinfo.attrs)
    jattrs.update(attrs)
    j = jinfo.fn({k: None if v is None else jnp.asarray(v)
                  for k, v in ins.items()}, jattrs)
    pinfo = OpInfoMap.instance().get(op_type)
    pattrs = dict(pinfo.attrs)
    pattrs.update(attrs)
    pattrs[DEVICE_ATTR] = CPU
    p = pinfo.fn({k: None if v is None else torch.from_numpy(np.array(v))
                  for k, v in ins.items()}, pattrs)
    return ({k: np.asarray(v) for k, v in j.items() if v is not None},
            {k: v.detach().numpy() for k, v in p.items() if v is not None})


def _close(got, want, name):
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=name)


def _check(op_type, ins, attrs, out="Out", grad=True, seed=0):
    """Forward outputs, then (``grad``) the ``<op_type>_grad`` op of both
    packages with the same random grad of ``out``."""
    j, p = _run(op_type, ins, attrs)
    assert set(p) == set(j), (sorted(p), sorted(j))
    for slot in j:
        _close(p[slot], j[slot], slot)
    if not grad:
        return p
    gins = dict(ins)
    gins[out + "@GRAD"] = _f(_rng(op_type, seed, "g"), *j[out].shape)
    jg, pg = _run(op_type + "_grad", gins, attrs)
    assert set(pg) == set(jg) and pg, (sorted(pg), sorted(jg))
    for slot in jg:
        _close(pg[slot], jg[slot], slot)
    return p


def test_the_transformer_slice_ops_are_registered():
    types = set(OpInfoMap.instance().all_op_types())
    binary = {"elementwise_" + n for n in (
        "add", "sub", "mul", "div", "min", "max", "pow", "mod", "floordiv")}
    reduce = {"reduce_" + n for n in (
        "sum", "mean", "max", "min", "prod", "all", "any")}
    forward = binary | reduce | {"scale", "cast", "matmul", "sequence_mask",
                                 "expand", "gather", "range", "assign",
                                 "assign_value"}
    assert forward <= types
    with_grad = binary | reduce - {"reduce_all", "reduce_any"} | {
        "scale", "cast", "matmul", "expand", "gather", "assign"}
    assert {t + "_grad" for t in with_grad} <= types
    # never differentiated, as in the JAX package
    no_grad = {"reduce_all", "reduce_any", "sequence_mask", "range",
               "assign_value"}
    assert not {t + "_grad" for t in no_grad} & types
    jtypes = set(JaxOps.instance().all_op_types())
    assert forward <= jtypes
    assert not {t + "_grad" for t in no_grad} & jtypes


BINARY = ["add", "sub", "mul", "div", "min", "max", "pow", "mod",
          "floordiv"]
# (X shape, Y shape, axis): same shape, numpy right alignment, Y aligned
# at axis 1 (a trailing size-1 dim of Y trimmed) and at axis 0, X broadcast
# against a larger Y
SHAPES = [((2, 3, 4), (2, 3, 4), -1), ((2, 3, 4), (4,), -1),
          ((2, 3, 4), (3, 1), 1), ((2, 3, 4), (2,), 0),
          ((2, 1, 4), (2, 3, 4), -1)]


@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: "x%s_y%s_axis%d"
                         % (s[0], s[1], s[2]))
@pytest.mark.parametrize("name", BINARY)
def test_elementwise_binary(name, shapes):
    xs, ys, axis = shapes
    rng = _rng(name, xs, ys)
    x, y = _f(rng, *xs), _f(rng, *ys)
    if name == "pow":  # a positive base keeps x ** y and its grads real
        x = np.abs(x) + 0.5
    if name in ("div", "mod", "floordiv"):  # divisors away from 0
        y = np.sign(y) * (np.abs(y) + 0.5)
        x = x * 3
    _check("elementwise_" + name, {"X": x, "Y": y}, {"axis": axis},
           seed=xs + ys)


@pytest.mark.parametrize("name", ["add", "sub", "mul", "min", "max", "mod",
                                  "floordiv", "pow"])
def test_elementwise_binary_on_integers(name):
    """int32 operands with negatives: ``mod`` truncates (C++ ``fmod``, the
    dividend's sign), ``floordiv`` floors."""
    rng = _rng("int", name)
    x = rng.randint(-20, 21, (3, 5)).astype("int32")
    y = rng.randint(1, 6, (5,)).astype("int32") * np.array(
        [1, -1, 1, -1, 1], dtype="int32")
    if name == "pow":
        x, y = np.abs(x) % 5, np.abs(y) % 4
    p = _check("elementwise_" + name, {"X": x, "Y": y}, {"axis": -1},
               grad=False)
    if name == "mod":
        np.testing.assert_array_equal(p["Out"], np.fmod(x, y))
    if name == "floordiv":
        np.testing.assert_array_equal(p["Out"], np.floor_divide(x, y))


@pytest.mark.parametrize("case", ["after", "before", "tensor", "int"])
def test_scale(case):
    rng = _rng("scale", case)
    x = _f(rng, 3, 4)
    attrs = {"scale": 1e9, "bias": -1.0,
             "bias_after_scale": case != "before"}
    ins = {"X": x}
    if case == "before":
        # the padding mask: (vis - 1) * 1e9 is exactly 0 or -1e9
        x = (rng.rand(3, 4) > 0.5).astype("float32")
        ins = {"X": x}
        p = _check("scale", ins, attrs)
        np.testing.assert_array_equal(p["Out"], (x - 1) * np.float32(1e9))
        return
    if case == "tensor":
        ins["ScaleTensor"] = np.array([0.25], dtype="float32")
        attrs = {"scale": 3.0, "bias": 0.5}
    if case == "int":
        ins = {"X": rng.randint(-9, 10, (3, 4)).astype("int32")}
        attrs = {"scale": 2.5, "bias": 1.7}
    _check("scale", ins, attrs, grad=case != "int")


@pytest.mark.parametrize("src,dst", [
    ("float32", 2), ("float32", 3), ("int32", 5), ("int64", 5),
    ("bool", 5), ("float32", 0), ("float32", 4), ("int64", 2)])
def test_cast(src, dst):
    rng = _rng("cast", src, dst)
    x = (_f(rng, 4, 5) * 7).astype(src) if src != "bool" else \
        rng.rand(4, 5) > 0.5
    # the port reads out_dtype only; in_dtype is what the var was built as
    _check("cast", {"X": x}, {"in_dtype": 5, "out_dtype": dst},
           grad=src == "float32" and dst in (4, 5))


@pytest.mark.parametrize("case", [
    ("2d", (5, 4), (4, 3), False, False, 1.0),
    ("2d_tt", (4, 5), (3, 4), True, True, 1.0),
    ("4d_ty", (2, 3, 6, 8), (2, 3, 7, 8), False, True, 0.125),
    ("4d_tx", (2, 3, 8, 6), (2, 3, 8, 7), True, False, 2.0),
    ("4d_bcast", (2, 3, 6, 8), (1, 3, 8, 5), False, False, 1.0),
    ("3d_2d", (2, 6, 8), (8, 5), False, False, 0.5),
    ("3d_2d_ty", (2, 6, 8), (5, 8), False, True, 1.0),
], ids=lambda c: c[0])
def test_matmul(case):
    _, xs, ys, tx, ty, alpha = case
    rng = _rng("matmul", case[0])
    _check("matmul", {"X": _f(rng, *xs), "Y": _f(rng, *ys)},
           {"transpose_X": tx, "transpose_Y": ty, "alpha": alpha},
           seed=case[0])


REDUCE = ["sum", "mean", "max", "min", "prod", "all", "any"]
REDUCE_ATTRS = [({"dim": [1]}, "d1"), ({"dim": [1], "keep_dim": True}, "d1k"),
                ({"dim": [0, 2]}, "d02"), ({"dim": [-1]}, "dneg"),
                ({"dim": [0], "reduce_all": True}, "all"),
                ({"dim": [0], "reduce_all": True, "keep_dim": True}, "allk")]


@pytest.mark.parametrize("attrs", REDUCE_ATTRS, ids=lambda a: a[1])
@pytest.mark.parametrize("name", REDUCE)
def test_reduce(name, attrs):
    rng = _rng("reduce", name, attrs[1])
    x = _f(rng, 2, 3, 4)
    if name == "prod":
        x = np.sign(x) * (np.abs(x) * 0.5 + 0.75)
    if name in ("all", "any"):
        x = rng.rand(2, 3, 4) > (0.2 if name == "all" else 0.8)
    _check("reduce_" + name, {"X": x}, attrs[0],
           grad=name not in ("all", "any"), seed=attrs[1])


@pytest.mark.parametrize("dtype", [3, 5, 0])
@pytest.mark.parametrize("shape", [(5,), (2, 3)])
def test_sequence_mask(shape, dtype):
    """A length-0 row is all False; lengths past maxlen fill the row."""
    rng = _rng("seqmask", shape, dtype)
    x = rng.randint(0, 9, shape).astype("int32")
    x.reshape(-1)[0] = 0
    x.reshape(-1)[-1] = 12
    p = _check("sequence_mask", {"X": x}, {"maxlen": 8, "out_dtype": dtype},
               out="Y", grad=False)
    assert p["Y"].shape == shape + (8,)
    assert not p["Y"].reshape(-1, 8)[0].any()
    assert p["Y"].reshape(-1, 8)[-1].all()


@pytest.mark.parametrize("case", [((2, 1, 3), [1, 4, 2]), ((2, 1), [1, 3]),
                                  ((3,), [2]), ((2, 3), [2])],
                         ids=lambda c: "%s_%s" % c)
def test_expand(case):
    xs, times = case
    _check("expand", {"X": _f(_rng("expand", xs), *xs)},
           {"expand_times": times}, seed=xs)


@pytest.mark.parametrize("case", ["repeated", "negative", "column", "3d"])
def test_gather(case):
    """The grad sums the output grads of repeated indices into one row."""
    rng = _rng("gather", case)
    x = _f(rng, 6, 4)
    idx = np.array([1, 3, 1, 1, 5, 0], dtype="int64")
    if case == "negative":
        idx = np.array([-1, 2, -6, 2], dtype="int64")
    if case == "column":
        idx = idx.reshape(-1, 1)
    if case == "3d":
        x = _f(rng, 5, 2, 3)
        idx = np.array([4, 4, 0], dtype="int32")
    p = _check("gather", {"X": x, "Index": idx}, {}, seed=case)
    np.testing.assert_array_equal(p["Out"], np.take(x, idx.reshape(-1), 0))
    if case == "repeated":
        og = _f(_rng("gather", case, "og"), 6, 4)
        _, pg = _run("gather_grad", {"X": x, "Index": idx, "Out@GRAD": og},
                     {})
        np.testing.assert_allclose(pg["X@GRAD"][1], og[0] + og[2] + og[3],
                                   rtol=0, atol=TOL)
        assert not pg["X@GRAD"][2].any()


def _range_program(pkg, start, end, step, dtype):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        out = pkg.layers.range(start, end, step, dtype)
    return main, out


@pytest.mark.parametrize("args", [(0, 40, 8, "int64"), (0, 7, 1, "int32"),
                                  (1.5, 4.0, 0.5, "float32"),
                                  (10, 2, -3, "int64")],
                         ids=lambda a: "%s_%s_%s_%s" % a)
def test_range(args):
    """``range`` is a host op in both packages (constant inputs fold on
    the whole-program route): one program each, run through each
    package's executor."""
    jmain, jout = _range_program(jfluid, *args)
    pmain, pout = _range_program(fluid, *args)
    assert jout.shape == pout.shape
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        (want,) = jfluid.Executor(jfluid.CPUPlace()).run(
            jmain, fetch_list=[jout])
    (got,) = fluid.Executor(fluid.CPUPlace()).run(
        pmain, fetch_list=[pout], scope=fluid.Scope())
    _close(np.asarray(got), np.asarray(want), "range")
    np.testing.assert_array_equal(got, np.arange(*args[:3]))
    assert got.shape == tuple(pout.shape)


@pytest.mark.parametrize("case", [
    ("fp32_values", 5, [2, 3], [0.5, -1e9, 0.0, 3.25, 1e-3, 7.0]),
    ("int32_values", 2, [4], [3, -1, 0, 7]),
    ("int64_values", 3, [1, 2, 2], [9, -4, 2, 11]),
    ("bool_values", 0, [3], [True, False, True])], ids=lambda c: c[0])
def test_assign_value(case):
    key, dtype, shape, vals = case
    p = _check("assign_value", {}, {"shape": shape, "dtype": dtype,
                                    key: vals}, grad=False)
    np.testing.assert_array_equal(p["Out"].reshape(-1),
                                  np.array(vals, dtype=p["Out"].dtype))


def test_causal_bias_layer_is_assign_value():
    """``layers.assign`` of a numpy array builds the same op in both
    packages, and the port's value is the array."""
    m = np.triu(np.full((4, 4), -1e9, dtype="float32"), k=1)
    progs = []
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            out = pkg.layers.assign(m)
        progs.append((main, out))
    (jop,), (pop,) = (p.global_block().ops for p, _ in progs)
    assert (pop.type, pop.outputs, pop.attrs) == \
        (jop.type, jop.outputs, jop.attrs)
    (got,) = fluid.Executor(fluid.CPUPlace()).run(
        progs[1][0], fetch_list=[progs[1][1]], scope=fluid.Scope())
    np.testing.assert_array_equal(got, m)
