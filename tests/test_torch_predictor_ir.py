"""The port's predictor with its IR passes on (the default), held to the
JAX predictor, and its zero-copy surface, on the CPU.

- A narrow BERT encoder (2 layers, 2 heads, d_model 32, d_ff 64, T 16,
  with ``src_lengths``) and a narrow NHWC ResNet (a 3x3 stem and two
  bottlenecks, the first with a projection shortcut, batch norms with
  seeded nonzero running statistics, under
  ``FLAGS_use_pallas_conv=all``, so the port's routed convs run K5's plain
  version) are saved by each package from the same seeded persistables
  and loaded by the port's predictor and by the JAX predictor, passes on.
  Both rewritten programs hold the same op list (no ``batch_norm`` left,
  ``fc`` where ``mul -> elementwise_add`` stood) and the answers agree
  within ``TOL`` = 1e-5 of the output's scale (float32 sums in other
  orders), as they do with the port's passes switched off.
- The rollback: when the rewritten program loses a fetch target (a pass
  made to drop it), the predictor keeps the program as loaded and puts the
  folded filters back, so it answers as with the passes off.
- A program with control-flow sub-blocks (a While loop) runs as saved
  (the JAX predictor raises on it).
- The zero-copy cases of ``tests/test_serving.py:470-620`` through the
  port: one predictor shared by 8 threads, concurrent constructions,
  two predictors on two threads, concurrent zero-copy callers, and the
  staging state and run lock.
"""
import importlib
import tempfile
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu.inference as jinf
from paddle_tpu import ir as jir
from paddle_tpu.models import transformer as jtransformer

import paddle_tpu_torch as fluid
import paddle_tpu_torch.inference as pinf
from paddle_tpu_torch import ir
from paddle_tpu_torch.models import transformer as ptransformer

# the models packages export a ``resnet`` function under the module's name
jresnet = importlib.import_module("paddle_tpu.models.resnet")
presnet = importlib.import_module("paddle_tpu_torch.models.resnet")

TOL = 1e-5
T, VOCAB = 16, 101
BERT = dict(num_layers=2, num_heads=2, d_model=32, d_ff=64)


# -- the two models, built by either package ---------------------------------

def _bert(pkg, transformer):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.data(name="src_ids", shape=[-1, T], dtype="int64")
        pos = pkg.data(name="pos_ids", shape=[-1, T], dtype="int64")
        lens = pkg.data(name="lengths", shape=[-1], dtype="int32")
        enc = transformer.transformer_encoder(
            src, pos, VOCAB, max_len=64, is_test=True, src_lengths=lens,
            **BERT)
    return main, startup, ["src_ids", "pos_ids", "lengths"], enc


def _resnet(pkg, resnet):
    """A 3x3 stem to 128 channels and two bottlenecks of 32 (x4): the
    convs that read 128 channels (K5 takes Cin % 128 == 0) route to K5;
    the answer is the logits."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data(name="img", shape=[-1, 8, 8, 3], dtype="float32")
        x = resnet._conv_bn(img, 128, 3, 1, act="relu", is_test=True,
                            data_format="NHWC")
        x = resnet._bottleneck(x, 32, 2, is_test=True, data_format="NHWC")
        x = resnet._bottleneck(x, 32, 1, is_test=True, data_format="NHWC")
        pool = pkg.layers.pool2d(x, pool_type="avg", global_pooling=True,
                                 data_format="NHWC")
        out = pkg.layers.fc(pool, 10)
    return main, startup, ["img"], out


MODELS = {"bert": (_bert, jtransformer, ptransformer),
          "resnet": (_resnet, jresnet, presnet)}


def _values(prog, seed):
    """Seeded persistables: batch-norm variances in [0.5, 1.5], scales
    near 1, the rest N(0, 0.1) (He-scaled for conv filters)."""
    rng = np.random.RandomState(seed)
    block = prog.global_block()
    bn = {s: set() for s in ("Variance", "Scale")}
    for op in block.ops:
        if op.type == "batch_norm":
            for s in bn:
                bn[s].update(op.input(s))
    vals = {}
    for name in sorted(block.vars):
        v = block.vars[name]
        if not v.persistable or v.shape is None:
            continue
        shape = tuple(int(s) for s in v.shape)
        if name in bn["Variance"]:
            a = rng.uniform(0.5, 1.5, shape)
        elif name in bn["Scale"]:
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif len(shape) == 4:
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        else:
            a = 0.1 * rng.randn(*shape)
        vals[name] = a.astype("float32")
    return vals


def _save(pkg, model, dirname, seed=0):
    build, jmod, pmod = MODELS[model]
    main, startup, feeds, out = build(pkg, jmod if pkg is jfluid else pmod)
    vals = _values(main, seed)
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(scope):
        exe.run(startup)
        for n, a in vals.items():
            t = scope.var(n).get_tensor()
            if pkg is jfluid:
                t._array = jnp.asarray(a)
            else:
                t.set(torch.from_numpy(a.copy()))
        pkg.io.save_inference_model(dirname, feeds, [out], exe,
                                    main_program=main.clone(for_test=True))


def _feeds(model, seed, rows):
    rng = np.random.RandomState(seed)
    if model == "bert":
        return {"src_ids": rng.randint(0, VOCAB, (rows, T)).astype("int64"),
                "pos_ids": np.tile(np.arange(T), (rows, 1)).astype("int64"),
                "lengths": rng.randint(1, T + 1, rows).astype("int32")}
    return {"img": rng.randn(rows, 8, 8, 3).astype("float32")}


def _port(dirname, ir_optim=True):
    cfg = pinf.AnalysisConfig(dirname)
    cfg.disable_gpu()
    cfg.switch_ir_optim(ir_optim)
    return pinf.create_paddle_predictor(cfg)


def _jax(dirname):
    cfg = jinf.AnalysisConfig(dirname)
    cfg.disable_gpu()
    return jinf.create_paddle_predictor(cfg)


def _types(pred):
    return [op.type for op in pred._program.global_block().ops]


def _near(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


@pytest.fixture()
def pallas_conv_all(monkeypatch):
    """FLAGS_use_pallas_conv=all, and a count of the routed convs (K5's
    plain version on the CPU)."""
    from paddle_tpu_torch.ops import conv_ops

    calls = []
    real = conv_ops.k5.conv2d_bn_act

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(conv_ops.k5, "conv2d_bn_act", counted)
    fluid.set_flags({"FLAGS_use_pallas_conv": "all"})
    yield calls
    fluid.set_flags({"FLAGS_use_pallas_conv": "off"})


@pytest.mark.parametrize("saver", ["jax", "port"])
@pytest.mark.parametrize("model", ["bert", "resnet"])
def test_port_predictor_with_passes_matches_the_jax_predictor(
        model, saver, tmp_path, pallas_conv_all):
    d = str(tmp_path)
    _save(jfluid if saver == "jax" else fluid, model, d)
    port, port_off, jax_pred = _port(d), _port(d, False), _jax(d)
    assert _types(port) == _types(jax_pred)
    types = _types(port)
    assert "batch_norm" not in types and "fc" in types
    if model == "resnet":
        assert "batch_norm" in _types(port_off)
        assert types.count("conv2d") == 8
    else:
        assert types.count("mul") == 0
    for seed, rows in ((1, 1), (2, 3)):
        feed = _feeds(model, seed, rows)
        (want,) = (t.data for t in jax_pred.run(feed))
        del pallas_conv_all[:]
        (got,) = (t.data for t in port.run(feed))
        routed = len(pallas_conv_all)
        (off,) = (t.data for t in port_off.run(feed))
        if model == "resnet":
            # the 1x1 convs that read 128 channels, folded or not
            assert routed == 3 and len(pallas_conv_all) == 6
        assert got.shape == want.shape and np.isfinite(got).all()
        _near(got, want)
        _near(got, off)


def test_rollback_keeps_the_loaded_program_and_weights(tmp_path,
                                                       monkeypatch):
    d = str(tmp_path)
    _save(fluid, "resnet", d)
    off = _port(d, False)
    filters = {n: off._scope.find_var(n).get_tensor().array.clone()
               for n in off._scope.local_var_names()
               if n.startswith("conv2d")}
    fetch = off.get_output_names()[0]
    real = ir.FcFusePass.apply

    def losing(self, graph):
        graph = real(self, graph)
        graph.safe_remove_nodes([graph.var_node(fetch)])
        return graph

    monkeypatch.setattr(ir.FcFusePass, "apply", losing)
    pred = _port(d)
    assert _types(pred) == _types(off)          # the program as loaded
    assert "batch_norm" in _types(pred)
    for n, w in filters.items():                # the folds undone
        assert torch.equal(pred._scope.find_var(n).get_tensor().array, w)
    feed = _feeds("resnet", 3, 2)
    np.testing.assert_array_equal(pred.run(feed)[0].data,
                                  off.run(feed)[0].data)


def _while_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[-1, 4], dtype="float32")
        h = pkg.layers.fc(x, 4)
        i = pkg.layers.fill_constant([1], "int64", 0)
        n = pkg.layers.fill_constant([1], "int64", 3)
        acc = pkg.layers.elementwise_add(h, h)
        cond = pkg.layers.less_than(i, n)
        loop = pkg.layers.While(cond)
        with loop.block():
            pkg.layers.assign(pkg.layers.elementwise_add(acc, h), acc)
            pkg.layers.increment(i, in_place=True)
            pkg.layers.less_than(i, n, cond=cond)
    return main, startup, acc


def test_a_program_with_sub_blocks_runs_as_saved(tmp_path):
    """The port's predictor runs a program with a While as saved. Both
    packages' ``IrGraph`` take one block, and the JAX predictor, passes on
    by default, hands a loaded program to it and so raises on such a
    program (ROADMAP queue 3)."""
    jmain, _, _ = _while_program(jfluid)
    with pytest.raises(NotImplementedError, match="single-block"):
        jir.IrGraph(jmain)
    main, startup, acc = _while_program(fluid)
    with pytest.raises(NotImplementedError, match="single-block"):
        ir.IrGraph(main)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(str(tmp_path), ["x"], [acc], exe,
                                      main_program=main)
    pred, off = _port(str(tmp_path)), _port(str(tmp_path), False)
    assert len(pred._program.blocks) > 1
    assert "mul" in _types(pred) and "fc" not in _types(pred)
    assert _types(pred) == _types(off)
    feed = {"x": np.arange(8, dtype="float32").reshape(2, 4)}
    np.testing.assert_array_equal(pred.run(feed)[0].data,
                                  off.run(feed)[0].data)


def test_a_saved_while_that_rewrites_the_fetch_answers_as_unsaved(
        tmp_path, monkeypatch):
    """``_while_program``'s fetch ``acc`` is rewritten by the loop's body.
    The port's save keeps the ``while`` and what it reads, so the
    reloaded model answers bitwise as the unsaved program does (2h + 3h).
    The JAX package's save keeps the ops up to ``acc``'s first writer
    only: its reloaded model has no ``while`` and answers 2h (loaded with
    its verifier off, which refuses the dead body's reads)."""
    feed = {"x": np.arange(8, dtype="float32").reshape(2, 4) - 3.5}
    main, startup, acc = _while_program(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    (want,) = exe.run(main, feed=feed, fetch_list=[acc], scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(str(tmp_path / "port"), ["x"], [acc],
                                      exe, main_program=main)
        prog, feeds, fetches = fluid.io.load_inference_model(
            str(tmp_path / "port"), exe)
        (got,) = exe.run(prog, feed=feed, fetch_list=fetches)
    assert "while" in [op.type for op in prog.global_block().ops]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for ir_optim in (True, False):
        np.testing.assert_array_equal(
            _port(str(tmp_path / "port"), ir_optim).run(feed)[0].data,
            np.asarray(want))
    # the JAX package's save of the same program from the same weights
    jmain, jstartup, jacc = _while_program(jfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    for v in jmain.global_block().vars.values():
        if v.persistable and scope.find_var(v.name) is not None:
            jscope.var(v.name).get_tensor()._array = jnp.asarray(
                np.asarray(scope.find_var(v.name).get_tensor()))
    (jwant,) = jexe.run(jmain, feed=feed, fetch_list=[jacc], scope=jscope)
    np.testing.assert_allclose(np.asarray(jwant), np.asarray(want),
                               rtol=1e-6)
    monkeypatch.setenv("PADDLE_TPU_VERIFY_IR", "0")
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(str(tmp_path / "jax"), ["x"], [jacc],
                                       jexe, main_program=jmain)
        jprog, _, jfetches = jfluid.io.load_inference_model(
            str(tmp_path / "jax"), jexe)
        (jgot,) = jexe.run(jprog, feed=feed, fetch_list=jfetches)
    assert "while" not in [op.type for op in jprog.global_block().ops]
    h = np.asarray(jwant) / 5.0
    np.testing.assert_allclose(np.asarray(jgot), 2.0 * h, rtol=1e-6)


# -- tests/test_serving.py's zero-copy cases, through the port --------------

def _build_predictor(tmpdir, dim=6, classes=3):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[-1, dim], dtype="float32")
        pred = fluid.layers.fc(fluid.layers.fc(x, 8, act="relu"),
                               classes, act="softmax")
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(tmpdir, ["x"], [pred], exe,
                                      main_program=main)
    return _port(tmpdir), pred.name


def test_shared_predictor_concurrent_run_is_safe():
    with tempfile.TemporaryDirectory() as d:
        predictor, _ = _build_predictor(d)
        refs = {i: predictor.run({"x": np.full((2, 6), float(i),
                                               "float32")})[0].data
                for i in range(8)}
        errors = []

        def worker(i):
            out = predictor.run({"x": np.full((2, 6), float(i),
                                              "float32")})[0].data
            if not np.allclose(out, refs[i], rtol=1e-5):
                errors.append(i)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, "cross-request clobbering on threads %s" % errors


def test_concurrent_predictor_construction_isolated():
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        p_ref1, _ = _build_predictor(d1, dim=6, classes=3)
        p_ref2, _ = _build_predictor(d2, dim=4, classes=2)
        x1 = np.full((2, 6), 0.3, "float32")
        x2 = np.full((2, 4), -0.3, "float32")
        ref1 = p_ref1.run({"x": x1})[0].data
        ref2 = p_ref2.run({"x": x2})[0].data
        errors = []

        def construct_and_check(d, x, ref):
            try:
                out = pinf.create_predictor(_config(d)).run({"x": x})[0].data
                if not np.allclose(out, ref, rtol=1e-5):
                    errors.append("wrong outputs from %s" % d)
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

        threads = [threading.Thread(target=construct_and_check, args=a)
                   for a in ((d1, x1, ref1), (d2, x2, ref2)) * 2]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[:3]


def _config(d):
    cfg = pinf.AnalysisConfig(d)
    cfg.disable_gpu()
    return cfg


def test_two_predictors_concurrent_runs_use_own_scopes():
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        p1, _ = _build_predictor(d1, dim=6, classes=3)
        p2, _ = _build_predictor(d2, dim=4, classes=2)
        x1 = np.full((2, 6), 0.5, "float32")
        x2 = np.full((2, 4), -0.5, "float32")
        ref1 = p1.run({"x": x1})[0].data
        ref2 = p2.run({"x": x2})[0].data
        errors = []

        def hammer(p, x, ref):
            for _ in range(10):
                out = p.run({"x": x})[0].data
                if not np.allclose(out, ref, rtol=1e-5):
                    errors.append(out.shape)

        threads = [threading.Thread(target=hammer, args=a)
                   for a in ((p1, x1, ref1), (p2, x2, ref2)) * 2]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[:3]


def test_concurrent_zero_copy_callers_are_isolated():
    with tempfile.TemporaryDirectory() as d:
        predictor, _ = _build_predictor(d)
        out_name = predictor.get_output_names()[0]
        barrier = threading.Barrier(4, timeout=30)
        errors = []

        def caller(i):
            x = np.full((2, 6), float(i), "float32")
            ref = predictor.run({"x": x})[0].data
            predictor.get_input_handle("x").copy_from_cpu(x)
            barrier.wait()  # everyone staged before anyone runs
            predictor.zero_copy_run()
            out = predictor.get_output_handle(out_name).copy_to_cpu()
            if not np.allclose(np.asarray(out), ref, rtol=1e-5):
                errors.append(i)

        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, "caller(s) %s read another caller's results" \
            % errors


def test_zero_copy_state_initialized_and_locked():
    with tempfile.TemporaryDirectory() as d:
        predictor, _ = _build_predictor(d)
        assert predictor._staged == {}
        assert predictor._results == {}
        assert predictor._run_lock is not None
        inp = predictor.get_input_tensor("x")
        with pytest.raises(RuntimeError, match="not staged"):
            predictor.zero_copy_run()
        inp.reshape([2, 6])
        inp.copy_from_cpu(np.ones(12, "float32"))
        assert inp.shape() == [2, 6]
        predictor.zero_copy_run()
        out = predictor.get_output_tensor(
            predictor.get_output_names()[0])
        assert np.asarray(out.copy_to_cpu()).shape == (2, 3)
        assert out.shape() == [2, 3]
        with pytest.raises(RuntimeError, match="output tensor"):
            out.copy_from_cpu(np.ones((2, 6), "float32"))
        with pytest.raises(RuntimeError, match="input tensor"):
            inp.copy_to_cpu()
        with pytest.raises(KeyError, match="no input"):
            predictor.get_input_tensor("y")
        with pytest.raises(KeyError, match="no output"):
            predictor.get_output_handle("y")
