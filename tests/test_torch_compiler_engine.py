"""The whole-program route (``paddle_tpu_torch/core/compiler_engine.py``)
against the JAX package's compiler engine, on the CPU.

(a) ``_analyze``, ``_fold_plan`` and ``untraceable_reasons`` give the same
    sets and indices as ``paddle_tpu.core.compiler_engine`` on the same
    programs built through both packages: narrow BERT masked-LM (whose
    ``range`` folds), WMT with lengths, gpt, ResNet-50 NHWC and an MLP;
    and on the cases of ``tests/test_const_fold.py``: a range over a
    constant folds and runs as the interpreter runs it, a range over a
    fed value keeps the program on the interpreter (a fallback, counted),
    a fallback of 64 or more ops warns, and a var that a hand-built
    sub-block writes is not folded.
(b) Three Adam steps of narrow BERT and WMT (lengths) through the port's
    default ``Executor.run`` on ``CPUPlace()``, from the JAX startup's
    persistables, against the JAX package's compiled ``Executor.run``:
    losses within 1e-6 relative (float32 products and sums in another
    order: 1.0e-7 measured); parameters within 1e-5 of their scale, the
    scale at least 1 (a bias that starts at zero moves by Adam's sign of
    a near-zero grad, which rounding can flip: 6e-6 absolute measured
    after three steps); moments within 1e-5 of their scale, at least
    1e-3. The same steps through the port's own interpreter give the same
    bits, and the counters read one compile, three steps, no capture and
    no fallback.
(c) Fetches of successive steps are distinct, the scope holds the updated
    state after each step, and a persistable replaced between steps is
    the one the next step reads.
(d) ``AsyncDeviceFeeder`` keeps the JAX feeder's contract on both
    packages with the same batches, and its batches feed ``Executor.run``
    as numpy feeds do.
"""
import os
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
from paddle_tpu.core import compiler_engine as jce
from paddle_tpu.core.native_feed import AsyncDeviceFeeder as JaxFeeder
import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import compiler_engine as pce
from paddle_tpu_torch.core.native_feed import AsyncDeviceFeeder
from paddle_tpu_torch.core.tensor import LoDTensor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_resnet_training as RT  # noqa: E402
import test_torch_training as GT  # noqa: E402
import test_torch_transformer_training as TT  # noqa: E402

LOSS_RTOL = 1e-6
PARAM_RTOL = 1e-5
PARAM_SCALE_FLOOR = 1.0
MOMENT_RTOL = 1e-5
MOMENT_SCALE_FLOOR = 1e-3


@pytest.fixture(autouse=True)
def _knob_off(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FUSED_OPTIMIZER", raising=False)


def _mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[8, 4], dtype="float32")
        y = pkg.data(name="y", shape=[8, 1], dtype="float32")
        h = pkg.layers.fc(x, size=16, act="relu")
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(
            pred - y, pred - y))
        pkg.optimizer.SGDOptimizer(0.05).minimize(loss)
    return main, startup, loss


def _mlp_feed(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 4).astype("float32")
    return {"x": x, "y": x.sum(1, keepdims=True).astype("float32")}


def _range_program(pkg):
    """``test_const_fold.py``'s program: a gather at ``range``-derived
    flat indices, trained by SGD."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[4, 6], dtype="float32")
        idx = pkg.layers.range(0, 4, 1, "int64")
        flat = pkg.layers.reshape(x, [24])
        base = pkg.layers.elementwise_mul(
            idx, pkg.layers.fill_constant([4], "int64", 6))
        loss = pkg.layers.mean(pkg.layers.gather(flat, base))
    return main, startup, loss


def _runtime_range_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        n = pkg.data(name="n", shape=[1], dtype="int64")
        idx = pkg.layers.range(0, n, 1, "int64")
    return main, idx


def _big_fallback_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        n = pkg.data(name="n", shape=[1], dtype="int64")
        h = pkg.layers.cast(n, "float32")
        for _ in range(70):
            h = pkg.layers.scale(h, scale=1.0)
        pkg.layers.range(0, n, 1, "int64")  # host, unfoldable
    return main, h


def _loop_program(pkg):
    """A var set by fill_constant and rewritten inside a hand-built
    while sub-block, then a range over it."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        i = pkg.layers.fill_constant([1], "int64", 0)
        cond = pkg.layers.fill_constant([1], "bool", True)
        sub = pkg.framework.Block(main, len(main.blocks), 0)
        main.blocks.append(sub)
        sub.append_op("scale", inputs={"X": [i]}, outputs={"Out": [i]},
                      attrs={"scale": 1.0, "bias": 1.0}, infer_shape=False)
        main.global_block().append_op(
            "while", inputs={"X": [i], "Condition": [cond]}, outputs={},
            attrs={"sub_block": sub}, infer_shape=False)
        pkg.layers.range(0, i, 1, "int64")
    return main


def _program(pkg, name):
    if name == "bert":
        return TT.build_bert(pkg)[0]
    if name == "wmt_lengths":
        return TT.build_wmt(pkg, True)[0]
    if name == "gpt":
        return GT.build_gpt(pkg)[0]
    if name == "resnet50_nhwc":
        return RT.build(pkg, RT.CONFIGS["resnet50_nhwc"])[0]
    if name == "mlp":
        return _mlp(pkg)[0]
    if name == "range":
        return _range_program(pkg)[0]
    if name == "runtime_range":
        return _runtime_range_program(pkg)[0]
    if name == "big_fallback":
        return _big_fallback_program(pkg)[0]
    return _loop_program(pkg)


ANALYZED = ["bert", "wmt_lengths", "gpt", "resnet50_nhwc", "mlp", "range",
            "runtime_range", "big_fallback", "loop"]
BLOCKED = {"runtime_range": ["range (host)"],
           "big_fallback": ["range (host)"], "loop": ["range (host)"]}


@pytest.mark.parametrize("name", ANALYZED)
def test_analysis_matches_the_jax_package(name):
    jmain, pmain = _program(jfluid, name), _program(fluid, name)
    assert [op.type for op in pmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert pce._analyze(pmain) == jce._analyze(jmain)
    jb, pb = jmain.global_block(), pmain.global_block()
    assert pce._fold_plan(pb) == jce._fold_plan(jb)
    # "loop" holds a while: a while blocks only for what its body holds,
    # in both packages
    assert jce.untraceable_reasons(jb) == BLOCKED.get(name, [])
    assert pce.untraceable_reasons(pb) == BLOCKED.get(name, [])
    folds = {"bert": 1, "range": 1}.get(name, 0)
    assert len(pce._fold_plan(pb)[0]) == folds
    if name == "loop":
        sub_j, sub_p = jmain.blocks[1], pmain.blocks[1]
        assert fluid.framework.block_rw(sub_p) == jce._block_rw(sub_j)
        i_name = pmain.global_block().ops[0].output("Out")[0]
        assert i_name in fluid.framework.block_rw(pb)[0]


def _reset():
    pce.reset_counters()


def test_folded_range_runs_as_the_interpreter_and_the_jax_package():
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(4, 6).astype("float32")}
    jmain, jstartup, jloss = _range_program(jfluid)
    with jfluid.scope_guard(jfluid.Scope()):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup)
        (want,) = jexe.run(jmain, feed=feed, fetch_list=[jloss])
    main, startup, loss = _range_program(fluid)
    got = {}
    for mode in ("compiled", "interp"):
        exe = fluid.Executor(fluid.CPUPlace())
        if mode == "interp":
            exe._can_whole_compile = lambda p: False
        _reset()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        (got[mode],) = exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope)
        if mode == "compiled":
            assert pce.counters()["executor.compile_fallbacks"] == 0
    assert got["compiled"].tobytes() == got["interp"].tobytes()
    np.testing.assert_allclose(got["compiled"], want, rtol=1e-6)


def test_range_over_a_fed_value_interprets_and_counts_a_fallback():
    main, idx = _runtime_range_program(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    _reset()
    for n in (5, 3):
        (v,) = exe.run(main, feed={"n": np.array([n], dtype="int64")},
                       fetch_list=[idx], scope=fluid.Scope())
        np.testing.assert_array_equal(np.ravel(v), np.arange(n))
    c = pce.counters()
    assert c["executor.compile_fallbacks"] == 1  # once per version
    assert c["executor.steps"] == c["executor.compiles"] == 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_big_fallback_program_warns(pkg):
    p = jfluid if pkg == "jax" else fluid
    main, h = _big_fallback_program(p)
    scope = p.Scope()
    with p.scope_guard(scope):
        exe = p.Executor(p.CPUPlace())
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            (v,) = exe.run(main, feed={"n": np.array([3], dtype="int64")},
                           fetch_list=[h])
    assert any("op-by-op" in str(x.message) and "range (host)"
               in str(x.message) for x in w)
    np.testing.assert_array_equal(np.ravel(v), [3.0])


def test_lod_feed_takes_the_interpreter_with_a_warning():
    main, startup, loss = _mlp(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = _mlp_feed(0)
    with pytest.raises(NotImplementedError, match="LoD feeds"):
        pce._stage_feeds({"x": LoDTensor(torch.from_numpy(feed["x"]),
                                         [[0, 3, 8]])})
    _reset()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        exe.run(main, scope=scope, fetch_list=[loss], feed={
            "x": LoDTensor(torch.from_numpy(feed["x"]), [[0, 3, 8]]),
            "y": feed["y"]})
    assert any("LoD feeds use the interpreter" in str(x.message) for x in w)
    assert pce.counters()["executor.compile_fallbacks"] == 1
    assert pce.counters()["executor.steps"] == 0


# -- (b) three Adam steps against the JAX package and the interpreter ------

def _train_port(script, init, interpret):
    main, startup, loss, _ = TT.build(fluid, script)
    exe = fluid.Executor(fluid.CPUPlace())
    exe._core.rng.seed = 1
    scope = fluid.Scope()
    fluid.io.scope_from_numpy(scope, init, fluid.CPUPlace())
    losses, states = [], []
    for feed in TT.feeds(script):
        if interpret:
            (l,) = exe._core.run_program(main, scope, feed, [loss])
        else:
            (l,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(np.asarray(l).copy())
        states.append(TT.persistables(main, scope))
    return losses, states


@pytest.mark.parametrize("script", ["bert", "wmt_lengths"])
def test_three_adam_steps_match_jax_and_the_interpreter(script):
    _, init, jlosses, _, jstates = TT._train_jax(script)
    _reset()
    losses, states = _train_port(script, init, interpret=False)
    c = pce.counters()
    assert (c["executor.compiles"], c["executor.steps"],
            c["executor.jit_traces"], c["executor.compile_fallbacks"]) \
        == (1, 3, 0, 0)
    for got, want in zip(losses, jlosses):
        got = float(got.reshape(-1)[0])
        assert abs(got - want) <= LOSS_RTOL * abs(want), (losses, jlosses)
    for jstate, pstate in zip(jstates, states):
        assert set(pstate) == set(jstate)
        for name, want in jstate.items():
            moment = "moment" in name or "pow_acc" in name
            floor = MOMENT_SCALE_FLOOR if moment else PARAM_SCALE_FLOOR
            rtol = MOMENT_RTOL if moment else PARAM_RTOL
            scale = max(float(np.abs(want).max()), floor)
            np.testing.assert_allclose(pstate[name], want, rtol=0,
                                       atol=rtol * scale, err_msg=name)
    ilosses, istates = _train_port(script, init, interpret=True)
    assert [x.tobytes() for x in ilosses] == [x.tobytes() for x in losses]
    for istate, pstate in zip(istates, states):
        assert {n: v.tobytes() for n, v in istate.items()} == \
            {n: v.tobytes() for n, v in pstate.items()}


# -- (c) fetches, the scope's state, a replaced persistable -----------------

def test_fetches_stay_distinct_and_the_scope_holds_the_state():
    main, startup, loss = _mlp(fluid)
    w = main.all_parameters()[0].name
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    outs = []
    for step in range(3):
        res = exe.run(main, feed=_mlp_feed(step), fetch_list=[loss, w],
                      scope=scope, return_numpy=False)
        held = scope.find_var(w).get_tensor().numpy()
        np.testing.assert_array_equal(res[1].numpy(), held)
        outs.append([r.numpy().copy() for r in res])
    for a, b in zip(outs, outs[1:]):
        assert not np.array_equal(a[0], b[0])
        assert not np.array_equal(a[1], b[1])
    # the fetched tensors of step 1 still hold step 1's values
    assert outs[0][0].tobytes() != outs[2][0].tobytes()


def test_a_replaced_persistable_is_read_by_the_next_step():
    main, startup, loss = _mlp(fluid)
    w = main.all_parameters()[0].name
    runs = {}
    for mode in ("compiled", "interp"):
        exe = fluid.Executor(fluid.CPUPlace())
        if mode == "interp":
            exe._can_whole_compile = lambda p: False
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=_mlp_feed(0), fetch_list=[loss], scope=scope)
        fluid.io.scope_from_numpy(
            scope, {w: np.full(scope.find_var(w).get_tensor().shape(), 0.25,
                               "float32")}, fluid.CPUPlace())
        runs[mode] = exe.run(main, feed=_mlp_feed(1), fetch_list=[loss, w],
                             scope=scope)
    assert runs["compiled"][0].tobytes() == runs["interp"][0].tobytes()
    assert runs["compiled"][1].tobytes() == runs["interp"][1].tobytes()
    # the update started from 0.25 everywhere
    assert np.abs(runs["compiled"][1] - 0.25).max() < 0.1


# -- (d) the async feeder ---------------------------------------------------

def _feeder(pkg, batches, depth=2):
    if pkg == "jax":
        return JaxFeeder(iter(batches), depth=depth)
    return AsyncDeviceFeeder(iter(batches), depth=depth,
                             device=fluid.CPUPlace())


def _batches(n=5):
    rng = np.random.RandomState(0)
    return [{"x": rng.rand(4, 4).astype("f4"), "y": np.int64([i])}
            for i in range(n)]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_async_feed_knob_defaults_off(pkg, monkeypatch):
    from paddle_tpu.core import native_feed as jnf
    from paddle_tpu_torch.core import native_feed as pnf

    enabled = (jnf if pkg == "jax" else pnf).async_feed_enabled
    monkeypatch.delenv("PADDLE_TPU_ASYNC_FEED", raising=False)
    assert not enabled()
    for raw, want in (("1", True), ("on", True), ("0", False), ("", False)):
        monkeypatch.setenv("PADDLE_TPU_ASYNC_FEED", raw)
        assert enabled() == want, raw


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_feeder_keeps_order(pkg):
    batches = _batches()
    with _feeder(pkg, batches) as fdr:
        got = [(np.asarray(b["x"]).copy(), int(np.asarray(b["y"])[0]))
               for b in fdr]
    assert [g[1] for g in got] == [0, 1, 2, 3, 4]
    for (x, _), b in zip(got, batches):
        np.testing.assert_array_equal(x, b["x"])


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_feeder_depth_bounds_the_queue(pkg, depth):
    pulled = []

    def gen():
        for b in _batches(20):
            pulled.append(1)
            yield b

    fdr = (JaxFeeder(gen(), depth=depth) if pkg == "jax" else
           AsyncDeviceFeeder(gen(), depth=depth, device=fluid.CPUPlace()))
    deadline = time.monotonic() + 5
    while len(pulled) < depth and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    # depth staged in the queue, one more held by the blocked put
    assert depth <= len(pulled) <= depth + 1
    assert int(np.asarray(next(fdr)["y"])[0]) == 0
    fdr.close()
    assert not fdr._thread.is_alive()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_feeder_close_mid_stream_joins_the_thread(pkg):
    fdr = _feeder(pkg, _batches(100), depth=1)
    next(fdr)
    t0 = time.perf_counter()
    fdr.close()
    assert time.perf_counter() - t0 < 2.0
    assert not fdr._thread.is_alive()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_feeder_reraises_the_producers_error(pkg):
    def gen():
        yield {"x": np.zeros((2, 2), "f4")}
        raise RuntimeError("reader exploded")

    fdr = (JaxFeeder(gen()) if pkg == "jax" else
           AsyncDeviceFeeder(gen(), device=fluid.CPUPlace()))
    next(fdr)
    with pytest.raises(RuntimeError, match="reader exploded"):
        next(fdr)
    fdr.close()
    assert not fdr._thread.is_alive()


def test_feeder_batches_feed_the_executor_unchanged():
    feeds = [_mlp_feed(s) for s in range(3)]
    losses = {}
    for mode in ("numpy", "feeder"):
        main, startup, loss = _mlp(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        src = (feeds if mode == "numpy" else
               AsyncDeviceFeeder(iter(feeds), device=fluid.CPUPlace()))
        losses[mode] = [exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0].tobytes() for f in src]
    assert losses["feeder"] == losses["numpy"]
    assert len(set(losses["numpy"])) == 3
    assert threading.active_count() < 50
