"""``TracedLayer`` and dygraph-to-static in the port against the JAX
package, on the CPU.

Twins of ``tests/test_dygraph_advanced.py:63-137``: trace a layer, save it
with ``save_inference_model``, load and serve it in the predictor;
``declarative`` against the eager function; the translator switched off;
``ProgramTranslator().get_program``. Each runs the same script through
both packages from the same numpy weights and inputs. Then a traced model
crosses the packages both ways: saved by one, served by the other's
predictor, in both formats (the JSON one and the reference's protobuf
``__model__`` + ``__params__``, ``core/proto_format.py``).

Tolerances: 1e-5 relative, 1e-6 absolute (float32 GEMMs in another
order; the protobuf format rounds nothing: it stores float32).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.inference import AnalysisConfig as JConfig
from paddle_tpu.inference import create_predictor as jcreate
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor

TOL = dict(rtol=1e-5, atol=1e-6)


def _linear(pkg, din, dout, seed, act=None):
    layer = pkg.dygraph.Linear(din, dout, act=act)
    rng = np.random.RandomState(seed)
    layer.weight.set_value(rng.randn(din, dout).astype("float32"))
    layer.bias.set_value(rng.randn(dout).astype("float32"))
    return layer


def _x(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype("float32")


def _trace(pkg, place=None):
    """(traced outputs, TracedLayer, op types) of a Linear(4, 2)."""
    guard = pkg.dygraph.guard(place) if place is not None \
        else pkg.dygraph.guard()
    with guard:
        layer = _linear(pkg, 4, 2, seed=0)
        x = pkg.dygraph.to_variable(_x(0, (3, 4)))
        outs, traced = pkg.dygraph.TracedLayer.trace(layer, [x])
        ref = np.asarray(outs[0].numpy())
        again = np.asarray(traced([x])[0].numpy()) \
            if pkg is fluid else None
    return ref, traced, [op.type for op in
                         traced.program.global_block().ops], again


def _config(make, dirname, names):
    cfg = make(dirname)
    if names:
        cfg.set_prog_file(names["model_filename"])
        cfg.set_params_file(names["params_filename"])
    cfg.disable_gpu()
    return cfg


def _serve_port(dirname, x, **names):
    cfg = _config(AnalysisConfig, dirname, names)
    pred = create_paddle_predictor(cfg)
    (out,) = pred.run({pred.get_input_names()[0]: x})
    return np.asarray(out.data)


def _serve_jax(dirname, x, **names):
    cfg = _config(JConfig, dirname, names)
    pred = jcreate(cfg)
    (out,) = pred.run({pred.get_input_names()[0]: x})
    return out.as_ndarray()


def test_trace_save_load_serve(tmp_path):
    jref, jtraced, jtypes, _ = _trace(jfluid)
    ref, traced, types, again = _trace(fluid, fluid.CPUPlace())
    assert types == jtypes and "matmul" in types
    np.testing.assert_allclose(ref, jref, **TOL)
    # the traced layer's call runs the recorded program
    np.testing.assert_allclose(again, ref, **TOL)
    traced.save_inference_model(str(tmp_path))
    np.testing.assert_allclose(_serve_port(str(tmp_path), _x(0, (3, 4))),
                               ref, **TOL)


def _reduced(pkg, layer):
    def f(x):
        return pkg.layers.reduce_sum(layer(x), dim=-1)
    return f


def _scaled(pkg):
    def f(x):
        return pkg.layers.scale(x, scale=3.0)
    return f


def test_declarative_matches_eager():
    res = {}
    for pkg, place in ((jfluid, None), (fluid, fluid.CPUPlace())):
        guard = pkg.dygraph.guard(place) if place is not None \
            else pkg.dygraph.guard()
        with guard:
            f = _reduced(pkg, _linear(pkg, 4, 3, seed=1, act="tanh"))
            static_f = pkg.dygraph.declarative(f)
            x = _x(1, (2, 4))
            eager = np.asarray(f(pkg.dygraph.to_variable(x)).numpy())
            s1 = np.asarray(static_f(pkg.dygraph.to_variable(x)).numpy())
            s2 = np.asarray(static_f(pkg.dygraph.to_variable(x)).numpy())
        np.testing.assert_allclose(s1, eager, **TOL)
        np.testing.assert_allclose(s2, s1, rtol=1e-6)
        res[pkg.__name__] = s1
    np.testing.assert_allclose(res["paddle_tpu_torch"], res["paddle_tpu"],
                               **TOL)


def test_translator_disable_falls_back_to_eager():
    from paddle_tpu_torch.dygraph import ProgramTranslator

    calls = []
    with fluid.dygraph.guard(fluid.CPUPlace()):
        @fluid.dygraph.declarative
        def f(x):
            calls.append(1)
            return fluid.layers.scale(x, scale=2.0)

        x = fluid.dygraph.to_variable(np.ones(2, dtype="float32"))
        ProgramTranslator().enable(False)
        try:
            out = f(x)
        finally:
            ProgramTranslator().enable(True)
        assert len(f._cache) == 0  # the function ran as written
        out2 = f(x)
        assert len(f._cache) == 1
    np.testing.assert_allclose(np.asarray(out.numpy()), [2.0, 2.0])
    np.testing.assert_allclose(np.asarray(out2.numpy()), [2.0, 2.0])
    assert len(calls) == 2  # once eagerly, once to build the program
    assert ProgramTranslator() is ProgramTranslator()


def test_get_program():
    from paddle_tpu.dygraph import ProgramTranslator as JTranslator
    from paddle_tpu_torch.dygraph import ProgramTranslator

    types = {}
    for pkg, tr, place in ((jfluid, JTranslator, None),
                           (fluid, ProgramTranslator, fluid.CPUPlace())):
        guard = pkg.dygraph.guard(place) if place is not None \
            else pkg.dygraph.guard()
        with guard:
            prog = tr().get_program(_scaled(pkg), pkg.dygraph.to_variable(
                np.ones(2, dtype="float32")))
        types[pkg.__name__] = [op.type for op in prog.global_block().ops]
    assert "scale" in types["paddle_tpu_torch"]
    assert types["paddle_tpu_torch"] == types["paddle_tpu"]


@pytest.mark.parametrize("fmt", ["json", "protobuf"])
def test_traced_model_crosses_the_packages(tmp_path, fmt):
    names = {} if fmt == "json" else dict(model_filename="__model__",
                                          params_filename="__params__")
    x = _x(0, (3, 4))
    jref, jtraced, _, _ = _trace(jfluid)
    ref, traced, _, _ = _trace(fluid, fluid.CPUPlace())
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    if names:
        from paddle_tpu import io as jio

        # the JAX TracedLayer writes its default format only: save its
        # recorded program and weights through its io with the names
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            for p in jtraced._params:
                scope.var(p.name).get_tensor()._array = p._array
            blk = jtraced.program.global_block()
            jio.save_inference_model(
                jdir, jtraced._feed_names,
                [blk.var(n) for n in jtraced._fetch_names],
                jfluid.Executor(jfluid.CPUPlace()),
                main_program=jtraced.program, **names)
    else:
        jtraced.save_inference_model(jdir)
    traced.save_inference_model(pdir, **names)
    np.testing.assert_allclose(_serve_port(jdir, x, **names), jref,
                               **TOL)
    np.testing.assert_allclose(_serve_jax(pdir, x, **names), ref, **TOL)
    np.testing.assert_allclose(ref, jref, **TOL)
