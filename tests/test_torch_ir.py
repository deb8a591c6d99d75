"""The port's IR passes (``paddle_tpu_torch/ir.py``) and ``fc`` op, held to
the JAX package's on the CPU.

- Both packages' ``FcFusePass`` and ``ConvBnFusePass`` run on the same
  programs (built by each package's layers, so every name agrees) and
  yield the same op list: types, slots and attrs. The folded filters and
  ``<filter>.bn_fold_bias`` tensors agree within ``FOLD_RTOL`` = 1e-6 of
  their scale (both fold in float32 with correctly rounded operations;
  the readings are 0). The cases: NCHW and NHWC conv+BN, a conv whose
  bias add stands before the batch norm (left alone), a filter shared by
  two convs (left alone), a conv output read twice (left alone), a residual add of two activations (no ``fc``), a
  ``mul`` whose output is read twice, and a ``[1, N]`` bias.
- The cases of ``tests/test_ir_passes.py``'s 8 tests through the port:
  detection, a broken edge, a predicate, the fold's answers against the
  unfolded program's, a shared filter left alone, ``GraphCheckPass`` on a
  good graph and on a dangling read, the ``MemoryEstimationPass`` report
  (equal to the JAX package's report on the same program).
- ``fc`` against the JAX op, forward and grad, within 1e-5 of scale, and
  bitwise against the ``mul -> elementwise_add -> relu`` chain it
  replaces.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import ir as jir
from paddle_tpu.core.registry import OpInfoMap as JaxOps
from paddle_tpu_torch import ir
from paddle_tpu_torch.core.registry import DEVICE_ATTR, OpInfoMap
from paddle_tpu_torch.ir import (GraphPatternDetector, IrGraph, PassRegistry,
                                 apply_pass)

CPU = torch.device("cpu")
FOLD_RTOL = 1e-6
TOL = 1e-5


# -- programs, built by either package ---------------------------------------

def _conv_bn(pkg, fmt="NCHW", conv_bias=False):
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup):
        shape = [3, 8, 8] if fmt == "NCHW" else [8, 8, 3]
        x = pkg.layers.data("x", shape=shape, dtype="float32")
        conv = pkg.layers.conv2d(x, num_filters=4, filter_size=3, padding=1,
                                 bias_attr=None if conv_bias else False,
                                 data_format=fmt)
        out = pkg.layers.batch_norm(conv, is_test=True, data_layout=fmt)
        h = pkg.layers.fc(pkg.layers.reshape(out, [-1, 256]), 16,
                          act="relu")
        pkg.layers.fc(h, 4)
    return prog, startup


def _shared_filter(pkg):
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup):
        x = pkg.layers.data("x", shape=[3, 8, 8], dtype="float32")
        w = pkg.ParamAttr(name="shared_w")
        c1 = pkg.layers.conv2d(x, 4, 3, padding=1, param_attr=w,
                               bias_attr=False)
        c2 = pkg.layers.conv2d(x, 4, 3, padding=1, param_attr=w,
                               bias_attr=False)
        b1 = pkg.layers.batch_norm(c1, is_test=True)
        b2 = pkg.layers.batch_norm(c2, is_test=True)
        pkg.layers.reduce_mean(b1 + b2)
    return prog, startup


def _conv_read_twice(pkg):
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup):
        x = pkg.layers.data("x", shape=[3, 8, 8], dtype="float32")
        conv = pkg.layers.conv2d(x, 4, 3, padding=1, bias_attr=False)
        bn = pkg.layers.batch_norm(conv, is_test=True)
        pkg.layers.reduce_mean(bn + conv)
    return prog, startup


def _residual_and_shared_mul(pkg):
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup):
        x = pkg.layers.data("x", shape=[8], dtype="float32")
        h = pkg.layers.fc(x, 8, bias_attr=False)      # mul alone
        r = pkg.layers.elementwise_add(h, x)          # residual: no fc
        m = pkg.layers.fc(r, 8, bias_attr=False)
        b = pkg.layers.create_parameter([8], "float32", name="mb")
        # the mul's output read twice: its bias add must not fuse
        pkg.layers.reduce_mean(pkg.layers.elementwise_add(m, b))
        pkg.layers.reduce_mean(m)
        pkg.layers.fc(r, 3, act="relu")
    return prog, startup


def _row_bias(pkg):
    prog, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(prog, startup):
        x = pkg.layers.data("x", shape=[6], dtype="float32")
        m = pkg.layers.fc(x, 5, bias_attr=False)
        b = pkg.layers.create_parameter([1, 5], "float32", name="rb")
        pkg.layers.relu(pkg.layers.elementwise_add(m, b))
    return prog, startup


def _named(build):
    """``build(pkg)`` under a fresh name counter, so both packages name
    every var alike."""
    def run(pkg):
        with pkg.unique_name.guard():
            return build(pkg)
    return run


CASES = {
    "conv_bn_nchw": _named(lambda pkg: _conv_bn(pkg)),
    "conv_bn_nhwc": _named(lambda pkg: _conv_bn(pkg, "NHWC")),
    "conv_bias_bn": _named(lambda pkg: _conv_bn(pkg, conv_bias=True)),
    "shared_filter": _named(_shared_filter),
    "conv_read_twice": _named(_conv_read_twice),
    "residual_and_shared_mul": _named(_residual_and_shared_mul),
    "row_bias": _named(_row_bias),
}


def _seeded_values(prog, seed):
    """A value for every persistable of ``prog``: batch norms' variances
    in [0.5, 1.5] so the fold divides by a real deviation, the rest
    N(0, 1)."""
    rng = np.random.RandomState(seed)
    variances = {n for op in prog.global_block().ops
                 if op.type == "batch_norm" for n in op.input("Variance")}
    vals = {}
    for name in sorted(prog.global_block().vars):
        v = prog.global_block().vars[name]
        if not v.persistable:
            continue
        shape = tuple(int(s) for s in v.shape)
        if name in variances:
            vals[name] = rng.uniform(0.5, 1.5, shape).astype("float32")
        else:
            vals[name] = rng.randn(*shape).astype("float32")
    return vals


def _jax_scope(vals):
    scope = jfluid.Scope()
    for n, a in vals.items():
        scope.var(n).get_tensor()._array = jnp.asarray(a)
    return scope


def _port_scope(vals):
    scope = fluid.Scope()
    for n, a in vals.items():
        scope.var(n).get_tensor().set(torch.from_numpy(a.copy()))
    return scope


def _op_list(graph):
    return [(o.op_type(), o.input_slots(), o.output_slots(), o._attrs)
            for o in graph.all_op_nodes()]


def _ops_equal(got, want):
    assert len(got) == len(want), ([g[0] for g in got],
                                   [w[0] for w in want])
    for (t, i, o, a), (jt, ji, jo, ja) in zip(got, want):
        assert (t, i, o) == (jt, ji, jo)
        # attrs: both packages' own defaults may name extra keys
        for k in set(a) & set(ja):
            if k.startswith("_") or k.startswith("op_"):
                continue
            av, jv = a[k], ja[k]
            if isinstance(av, float) or isinstance(jv, float):
                assert float(av) == pytest.approx(float(jv), rel=1e-6), k
            else:
                assert av == jv or list(np.ravel(av)) == list(
                    np.ravel(jv)), (t, k, av, jv)


@pytest.mark.parametrize("case", sorted(CASES))
def test_passes_give_the_jax_packages_op_list_and_folds(case):
    jprog, _ = CASES[case](jfluid)
    prog, _ = CASES[case](fluid)
    assert sorted(prog.global_block().vars) == sorted(
        jprog.global_block().vars)
    vals = _seeded_values(prog, seed=len(case))
    jscope, scope = _jax_scope(vals), _port_scope(vals)
    jg = jir.IrGraph(jprog.clone(for_test=True))
    jg = jir.ConvBnFusePass(scope=jscope).apply(jg)
    jg = jir.FcFusePass().apply(jg)
    g = IrGraph(prog.clone(for_test=True))
    g = ir.ConvBnFusePass(scope=scope).apply(g)
    g = ir.FcFusePass().apply(g)
    _ops_equal(_op_list(g), _op_list(jg))
    assert [n for n, _ in g.startup_inits] == [n for n, _ in jg.startup_inits]
    # a conv with a bias_attr adds its bias by an elementwise_add, which
    # stands between it and the batch norm: neither package folds it
    folds = {"conv_bn_nchw": 1, "conv_bn_nhwc": 1}
    assert len(g.startup_inits) == folds.get(case, 0)
    # every tensor the JAX fold wrote (filters, folded biases)
    for n in sorted(set(jscope._vars)):
        want = np.asarray(jscope.find_var(n).get_tensor().array)
        got = scope.find_var(n).get_tensor().array.numpy()
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=FOLD_RTOL * scale, err_msg=n)
    # the materialized programs agree too
    got = [op.type for op in g.to_program().global_block().ops]
    want = [op.type for op in jg.to_program().global_block().ops]
    assert got == want


def test_fc_fuse_counts_on_the_cases():
    counts = {}
    for case in ("conv_bn_nchw", "residual_and_shared_mul", "row_bias"):
        prog, _ = CASES[case](fluid)
        g = ir.FcFusePass().apply(IrGraph(prog))
        types = [o.op_type() for o in g.all_op_nodes()]
        counts[case] = (types.count("fc"), types.count("mul"),
                        types.count("relu"))
    # the residual add of two activations and the mul read twice stay
    assert counts == {"conv_bn_nchw": (2, 0, 0),
                      "residual_and_shared_mul": (1, 2, 0),
                      "row_bias": (1, 0, 0)}


# -- tests/test_ir_passes.py's cases, through the port -----------------------

def _conv_bn_program():
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = fluid.layers.data("x", shape=[3, 8, 8], dtype="float32")
        conv = fluid.layers.conv2d(x, num_filters=4, filter_size=3,
                                   padding=1, bias_attr=False)
        out = fluid.layers.batch_norm(conv, is_test=True)
        fluid.layers.reduce_mean(out)
    return prog, startup, out.name


class TestGraphPatternDetector:
    def test_detects_conv_bn(self):
        prog, _, _ = _conv_bn_program()
        d = GraphPatternDetector()
        d.op_node("conv", "conv2d")
        d.op_node("bn", "batch_norm")
        d.edge_out("conv", "Output", "conv_out")
        d.edge_in("bn", "X", "conv_out")
        matches = list(d.detect(IrGraph(prog)))
        assert len(matches) == 1
        assert matches[0]["conv"].op_type() == "conv2d"
        assert matches[0]["bn"].op_type() == "batch_norm"
        assert isinstance(matches[0]["conv_out"], str)

    def test_no_match_when_edge_broken(self):
        prog, _, _ = _conv_bn_program()
        d = GraphPatternDetector()
        d.op_node("conv", "conv2d")
        d.op_node("mean", "reduce_mean")
        # reduce_mean reads the BN output, not the conv output
        d.edge_out("conv", "Output", "v")
        d.edge_in("mean", "X", "v")
        assert list(d.detect(IrGraph(prog))) == []

    def test_predicate_filters(self):
        prog, _, _ = _conv_bn_program()
        d = GraphPatternDetector()
        d.op_node("bn", "batch_norm",
                  predicate=lambda op: not op.attr("is_test"))
        assert list(d.detect(IrGraph(prog))) == []


class TestConvBnFuse:
    def test_fold_matches_unfused_outputs(self):
        prog, startup, out_name = _conv_bn_program()
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        # nonzero BN statistics, so the fold is really tested
        rng = np.random.RandomState(7)
        for v in prog.global_block().vars.values():
            if v.persistable and ("mean" in v.name or "variance" in v.name
                                  or "batch_norm" in v.name):
                t = scope.find_var(v.name).get_tensor()
                t.set(torch.from_numpy(rng.uniform(
                    0.5, 1.5, tuple(t.array.shape)).astype("float32")))
        x = rng.randn(2, 3, 8, 8).astype(np.float32)
        ref = exe.run(prog, feed={"x": x}, fetch_list=[out_name],
                      scope=scope)[0]
        graph = IrGraph(prog.clone(for_test=True))
        graph = PassRegistry._passes["conv_bn_fuse_pass"](
            scope=scope).apply(graph)
        fused = graph.to_program()
        types = [op.type for op in fused.global_block().ops]
        assert "batch_norm" not in types, types
        out = exe.run(fused, feed={"x": x}, fetch_list=[out_name],
                      scope=scope)[0]
        np.testing.assert_allclose(np.asarray(ref), np.asarray(out),
                                   rtol=2e-4, atol=2e-5)


class TestConvBnFuseSharedFilter:
    def test_shared_filter_not_folded(self):
        prog, startup = _shared_filter(fluid)
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
        before = scope.find_var("shared_w").get_tensor().array.clone()
        g = IrGraph(prog.clone(for_test=True))
        g = PassRegistry._passes["conv_bn_fuse_pass"](scope=scope).apply(g)
        types = [op.op_type() for op in g.all_op_nodes()]
        assert types.count("batch_norm") == 2  # untouched
        assert torch.equal(scope.find_var("shared_w").get_tensor().array,
                           before)


class TestDiagnosticPasses:
    def test_graph_check_pass_ok(self):
        prog, _, _ = _conv_bn_program()
        apply_pass(prog, "graph_check_pass")

    def test_graph_check_pass_catches_undefined_read(self):
        prog, _, _ = _conv_bn_program()
        g = IrGraph(prog)
        g.create_op_node("relu", {}, {"X": ["no_such_var"]},
                         {"Out": ["dangling"]})
        with pytest.raises(ValueError, match="no_such_var"):
            PassRegistry._passes["graph_check_pass"]().apply(g)

    def test_memory_estimation_report(self):
        prog, _, _ = _conv_bn_program()
        p = PassRegistry._passes["memory_estimation_pass"](batch_size=8)
        p.apply(IrGraph(prog))
        rep = p.report
        assert rep["peak_activation_bytes"] > 0
        assert rep["persistable_bytes"] > 0
        assert rep["n_vars"] > 3
        jprog, _ = CASES["conv_bn_nchw"](jfluid)
        prog, _ = CASES["conv_bn_nchw"](fluid)
        jp = jir.PassRegistry._passes["memory_estimation_pass"](batch_size=8)
        jp.apply(jir.IrGraph(jprog))
        p = PassRegistry._passes["memory_estimation_pass"](batch_size=8)
        p.apply(IrGraph(prog))
        assert p.report == jp.report


def test_pass_registry_and_pipeline():
    assert sorted(PassRegistry._passes) == sorted(jir.PassRegistry._passes)
    with pytest.raises(KeyError, match="not registered"):
        PassRegistry.get("no_such_pass")
    prog, startup = _conv_bn(fluid)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    new, applied = ir.apply_passes(
        prog.clone(for_test=True),
        ["conv_bn_fuse_pass", "fc_fuse_pass", "graph_check_pass"],
        scope=scope)
    assert [p.name for p in applied] == ["conv_bn_fuse_pass",
                                         "fc_fuse_pass", "graph_check_pass"]
    assert [op.type for op in new.global_block().ops] == [
        "conv2d", "reshape2", "fc", "fc"]


def test_graph_viz_pass_writes_dot(tmp_path):
    prog, _, _ = _conv_bn_program()
    PassRegistry._passes["graph_viz_pass"](
        save_path=str(tmp_path), graph_name="g").apply(IrGraph(prog))
    text = (tmp_path / "g.dot").read_text()
    assert text.startswith("digraph g {") and "conv2d" in text


# -- fc ----------------------------------------------------------------------

def _run_op(op_type, ins, attrs):
    jinfo = JaxOps.instance().get(op_type)
    jattrs = dict(jinfo.attrs)
    jattrs.update(attrs)
    j = jinfo.fn({k: jnp.asarray(v) for k, v in ins.items()}, jattrs)
    pinfo = OpInfoMap.instance().get(op_type)
    pattrs = dict(pinfo.attrs)
    pattrs.update(attrs)
    pattrs[DEVICE_ATTR] = CPU
    p = pinfo.fn({k: torch.from_numpy(np.array(v)) for k, v in ins.items()},
                 pattrs)
    return ({k: np.asarray(v) for k, v in j.items() if v is not None},
            {k: v.detach().numpy() for k, v in p.items() if v is not None})


def _close(got, want, name):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=name)


FC_CASES = [((4, 6), 1, "relu", True), ((2, 3, 6), 2, "", True),
            ((2, 3, 2, 3), 2, "relu", False), ((5, 6), 1, "", False)]


@pytest.mark.parametrize("case", FC_CASES, ids=lambda c: "x%s_k%d_%s_%s" % (
    c[0], c[1], c[2] or "none", "bias" if c[3] else "nobias"))
def test_fc_matches_the_jax_op_forward_and_grad(case):
    shape, k, act, bias = case
    rng = np.random.RandomState(sum(shape) + k)
    lead = int(np.prod(shape[:k]))
    kdim = int(np.prod(shape[k:]))
    ins = {"Input": rng.randn(*shape).astype("float32"),
           "W": rng.randn(kdim, 5).astype("float32")}
    if bias:
        ins["Bias"] = rng.randn(5).astype("float32")
    attrs = {"in_num_col_dims": k, "activation_type": act}
    j, p = _run_op("fc", ins, attrs)
    _close(p["Out"], j["Out"], "Out")
    assert p["Out"].shape == tuple(shape[:k]) + (5,)
    gins = dict(ins)
    gins["Out@GRAD"] = rng.randn(*j["Out"].shape).astype("float32")
    jg, pg = _run_op("fc_grad", gins, attrs)
    assert set(pg) == set(jg) and pg
    for slot in jg:
        _close(pg[slot], jg[slot], slot)
    assert lead * 5 == p["Out"].size


def test_fc_gives_the_chains_bits():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(4, 3, 8).astype("float32"))
    w = torch.from_numpy(rng.randn(8, 6).astype("float32"))
    b = torch.from_numpy(rng.randn(6).astype("float32"))
    reg = OpInfoMap.instance()
    mul = reg.get("mul").fn({"X": x, "Y": w}, {"x_num_col_dims": 2,
                                               "y_num_col_dims": 1})["Out"]
    add = reg.get("elementwise_add").fn({"X": mul, "Y": b},
                                        {"axis": 2})["Out"]
    chain = reg.get("relu").fn({"X": add}, {})["Out"]
    fc = reg.get("fc").fn({"Input": x, "W": w, "Bias": b},
                          {"in_num_col_dims": 2,
                           "activation_type": "relu"})["Out"]
    assert torch.equal(fc, chain)
    with pytest.raises(NotImplementedError, match="gelu"):
        reg.get("fc").fn({"Input": x, "W": w, "Bias": b},
                         {"in_num_col_dims": 2, "activation_type": "gelu"})
