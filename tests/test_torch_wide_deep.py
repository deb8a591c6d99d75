"""Wide&Deep (bench.py's north-star config 5) in the port, against the JAX
package, on the CPU.

(a) ``concat`` and ``slice``, the op types the model added, against the
    JAX ops of the same name on the same inputs, forward and grad (the
    auto-VJP against ``jax.vjp`` with the same output grad): ``concat``
    over axes 0, 1 and -1; ``slice`` with negative and overlong bounds,
    several axes, a negative axis and ``decrease_axis``. Within 1e-5 of
    the output's scale; ``concat``'s ``AxisTensor`` raises.
(b) ``models.build_wide_deep(2048)`` is bench.py's ``_build_wide_deep``
    program op for op (main and startup, attrs included), with its 34
    parameters of 41,629,794 elements under one Adam instance, and the
    feeds of ``random_batch`` are bench.py's.
(c) A narrow Wide&Deep (vocab 1000, 4 sparse slots, 13 dense features,
    batch 64), built by one script against either package, trained 3
    Adam steps (lr 1e-3) through both from the JAX startup's
    persistables: losses within 1e-5 relative (1.7e-7 measured: float32
    sums in another order), step-1 grads and moments within 1e-4 of their scale
    (at least 1e-3), parameters within 2 lr a step, as in
    ``test_torch_training.py``.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as fluid
from paddle_tpu.core.registry import OpInfoMap as JaxOps
from paddle_tpu_torch.core.registry import DEVICE_ATTR, OpInfoMap
from paddle_tpu_torch.models.wide_deep import WIDE_DEEP, random_batch

WD = sys.modules["paddle_tpu_torch.models.wide_deep"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
NARROW = dict(batch=64, vocab=1000, slots=4, dense_dim=13)


def _port_op(op_type, ins, attrs):
    info = OpInfoMap.instance().get(op_type)
    a = dict(info.attrs)
    a.update(attrs)
    a[DEVICE_ATTR] = torch.device("cpu")
    return info.fn(ins, a)


def _jax_op(op_type, ins, attrs):
    info = JaxOps.instance().get(op_type)
    a = dict(info.attrs)
    a.update(attrs)
    return info.fn(ins, a)


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=name)


CONCAT = [((2, 3), (4, 3), 0), ((2, 3, 4), (2, 5, 4), 1),
          ((3, 2), (3, 7), -1), ((2, 2, 1), (2, 2, 3), -1)]


@pytest.mark.parametrize("shapes", CONCAT, ids=lambda s: "axis%d_%s" % (
    s[2], "x".join(map(str, s[1]))))
def test_concat_matches_the_jax_op(shapes):
    a_shape, b_shape, axis = shapes
    rng = np.random.RandomState(len(a_shape) + axis)
    xs = [rng.randn(*a_shape).astype("float32"),
          rng.randn(*b_shape).astype("float32"),
          rng.randn(*a_shape).astype("float32")]
    attrs = {"axis": axis}
    want = _jax_op("concat", {"X": [jnp.asarray(x) for x in xs],
                              "AxisTensor": None}, attrs)["Out"]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    got = _port_op("concat", {"X": leaves, "AxisTensor": None}, attrs)["Out"]
    _close(got.detach().numpy(), want, "Out")
    g = rng.randn(*want.shape).astype("float32")
    _, vjp = jax.vjp(lambda *v: _jax_op("concat", {"X": list(v),
                                                   "AxisTensor": None},
                                        attrs)["Out"],
                     *[jnp.asarray(x) for x in xs])
    jgrads = vjp(jnp.asarray(g))
    grad_ins = {"X": [torch.from_numpy(x) for x in xs], "AxisTensor": None,
                "Out@GRAD": torch.from_numpy(g)}
    pgrads = _port_op("concat_grad", grad_ins, attrs)["X@GRAD"]
    for i, (pg, jg) in enumerate(zip(pgrads, jgrads)):
        _close(pg.numpy(), jg, "X@GRAD[%d]" % i)


def test_concat_axis_tensor_raises():
    x = torch.ones(2, 2)
    with pytest.raises(NotImplementedError, match="AxisTensor"):
        _port_op("concat", {"X": [x, x], "AxisTensor": torch.tensor([0])},
                 {"axis": 0})


SLICE = [
    dict(axes=[1], starts=[2], ends=[3]),
    dict(axes=[0, 2], starts=[-3, 1], ends=[-1, 100]),
    dict(axes=[1], starts=[-100], ends=[2]),
    dict(axes=[-1], starts=[1], ends=[4]),
    dict(axes=[1], starts=[4], ends=[2]),        # empty
    dict(axes=[0, 1], starts=[1, 3], ends=[2, 4], decrease_axis=[0, 1]),
    dict(axes=[2], starts=[-1], ends=[10000], decrease_axis=[2]),
]


@pytest.mark.parametrize("attrs", SLICE, ids=lambda a: "%s_%s_%s%s" % (
    a["axes"], a["starts"], a["ends"],
    "_dec%s" % a["decrease_axis"] if "decrease_axis" in a else ""))
def test_slice_matches_the_jax_op(attrs):
    rng = np.random.RandomState(len(str(attrs)))
    x = rng.randn(4, 6, 5).astype("float32")
    want = _jax_op("slice", {"Input": jnp.asarray(x)}, attrs)["Out"]
    got = _port_op("slice", {"Input": torch.from_numpy(x)}, attrs)["Out"]
    _close(got.numpy(), want, "Out")
    g = rng.randn(*want.shape).astype("float32")
    _, vjp = jax.vjp(lambda v: _jax_op("slice", {"Input": v}, attrs)["Out"],
                     jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    pg = _port_op("slice_grad", {"Input": torch.from_numpy(x),
                                 "Out@GRAD": torch.from_numpy(g)},
                  attrs)["Input@GRAD"]
    _close(pg.numpy(), jg, "Input@GRAD")


def test_slice_and_concat_layers_emit_the_jax_layers_ops():
    seqs = []
    for pkg in (jfluid, fluid):
        main = pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main,
                                                        pkg.Program()):
            x = pkg.data(name="x", shape=[4, 6], dtype="float32")
            a = pkg.layers.slice(x, axes=[1], starts=[-4], ends=[99])
            pkg.layers.concat([a, x], axis=-1)
        seqs.append([(op.type, op.inputs, op.outputs, op.attrs)
                     for op in main.global_block().ops])
        assert [v.shape for v in main.global_block().vars.values()
                if v.name.startswith("concat")] == [(4, 10)]
    assert seqs[0] == seqs[1]


def _bench():
    sys.path.insert(0, REPO)
    import bench

    return bench


def _op_seq(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in program.global_block().ops]


def test_build_wide_deep_is_bench_pys_program():
    with jfluid.unique_name.guard():
        jmain, jstartup, jloss, V, S, DD = _bench()._build_wide_deep(2048)
    main, startup, loss, params_grads = WD.build_wide_deep(2048)
    assert (V, S, DD) == (WIDE_DEEP["vocab"], WIDE_DEEP["slots"],
                          WIDE_DEEP["dense_dim"])
    assert _op_seq(main) == _op_seq(jmain)
    assert _op_seq(startup) == _op_seq(jstartup)
    assert loss.name == jloss.name
    assert len(params_grads) == 34
    assert sum(int(np.prod(p.shape)) for p, _ in params_grads) == 41629794
    types = [op.type for op in main.global_block().ops]
    assert types.count("adam") == 34
    assert {"concat", "concat_grad", "slice"} <= set(types)
    assert "slice_grad" not in types  # the ids take no grad
    assert fluid.models.build_wide_deep is WD.build_wide_deep
    assert fluid.models.random_batch is WD.random_batch


def test_random_batch_is_bench_pys_feed():
    feed = random_batch(np.random.RandomState(0), 16)
    rng = np.random.RandomState(0)
    want = {"dense": rng.rand(16, 13).astype("float32"),
            "sparse": rng.randint(0, 100000, (16, 26)).astype("int64"),
            "label": rng.randint(0, 2, (16, 1)).astype("int64")}
    assert feed.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(feed[k], want[k])
        assert feed[k].dtype == want[k].dtype


def build(pkg, batch=NARROW["batch"], vocab=NARROW["vocab"],
          slots=NARROW["slots"], dense_dim=NARROW["dense_dim"]):
    """bench.py's Wide&Deep script under ``pkg``, narrow."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        dense = pkg.data(name="dense", shape=[batch, dense_dim],
                         dtype="float32")
        sparse = pkg.data(name="sparse", shape=[batch, slots], dtype="int64")
        label = pkg.data(name="label", shape=[batch, 1], dtype="int64")
        pred = pkg.models.wide_deep(dense, sparse, vocab_size=vocab)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        _, pg = pkg.optimizer.AdamOptimizer(LR).minimize(loss)
    return main, startup, loss, pg


def _persistables(main, scope):
    out = {}
    for v in main.global_block().vars.values():
        var = scope.find_var(v.name) if v.persistable else None
        if var is not None and var.is_initialized():
            out[v.name] = np.array(var.get_tensor(), dtype=np.float32)
    return out


def _feeds():
    rng = np.random.RandomState(5)
    out = [random_batch(rng, NARROW["batch"], NARROW["vocab"],
                        NARROW["slots"], NARROW["dense_dim"])
           for _ in range(3)]
    out[0]["sparse"][:3, 0] = 7  # a repeated id: its rows' grads must sum
    return out


def test_narrow_builder_is_the_script():
    main = WD.build_wide_deep(NARROW["batch"], NARROW["vocab"],
                              NARROW["slots"], NARROW["dense_dim"],
                              learning_rate=LR, seed=1)[0]
    assert _op_seq(main) == _op_seq(build(fluid)[0])


def test_three_adam_steps_match_the_jax_package(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FUSED_OPTIMIZER", raising=False)
    monkeypatch.delenv("PADDLE_TPU_FUSED_EPILOGUE", raising=False)
    runs = {}
    init = None
    for name, pkg in (("jax", jfluid), ("port", fluid)):
        main, startup, loss, pg = build(pkg)
        grad_names = [g.name for _, g in pg]
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        if init is None:
            with pkg.scope_guard(scope):
                exe.run(startup)
            init = _persistables(main, scope)
        else:
            fluid.io.scope_from_numpy(scope, init, fluid.CPUPlace())
        losses, grads, states = [], None, []
        for i, feed in enumerate(_feeds()):
            res = exe.run(main, feed=feed, scope=scope,
                          fetch_list=[loss] + (grad_names if i == 0 else []))
            losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
            if i == 0:
                grads = [np.asarray(r) for r in res[1:]]
            states.append(_persistables(main, scope))
        runs[name] = (grad_names, losses, grads, states)
    grad_names, jl, jg, js = runs["jax"]
    _, pl, pgr, ps = runs["port"]
    assert np.isfinite(pl).all()
    for a, b in zip(pl, jl):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (pl, jl)
    for name, a, b in zip(grad_names, pgr, jg):
        scale = max(float(np.abs(b).max()), GRAD_FLOOR)
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=name)
    for step, (want, got) in enumerate(zip(js, ps), 1):
        assert want.keys() == got.keys()
        for name in want:
            if "moment" in name:
                atol = GRAD_RTOL * max(float(np.abs(want[name]).max()),
                                       GRAD_FLOOR)
            else:
                atol = 2 * LR * step
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=atol, err_msg=name)
