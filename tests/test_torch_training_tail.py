"""The rest of the training path's small modules, the port against the
JAX package on the CPU.

- The layers the port adds over ops it registers (``elementwise_max``,
  ``elementwise_pow``, ``gelu``, ``reduce_prod`` / ``_all`` / ``_any``,
  ``zeros``, ``ones``, ``zeros_like``, ``sums``, ``while_loop``, ``shape``,
  ``size``, ``is_empty``), ``split`` with ``nets.glu``,
  ``nets.scaled_dot_product_attention``, ``sequence_reverse``, and the
  ``sequence_scatter`` op: each program is built by one script under both
  packages (the same ops, slots and attrs) and runs from the JAX
  startup's persistables to the same outputs, and where it trains, the
  same grads.
- ``uniform_random`` and ``gaussian_random`` build the same ops; their
  draws (torch's generator, not ``jax.random``) are held to their
  distribution.
- ``merge_selected_rows`` and ``get_tensor_from_selected_rows`` over an
  ``is_sparse`` embedding's grad give the JAX package's rows.
- ``ExponentialMovingAverage``, ``ModelAverage`` and
  ``LookaheadOptimizer``: three SGD steps, then ``apply()`` swaps in the
  averages and ``restore()`` swaps the trained parameters back, as in the
  JAX package.
- ``cudnn_lstm`` at T 64, forward and grads against the JAX op (its step
  loop runs over ``unbind``).

Tolerances: values and grads within 1e-5 of each tensor's scale, as the
other op tests; the random draws' mean and deviation within 0.02 of the
distribution's over 40,000 draws (eight standard errors and more).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid

import test_torch_lr_schedule as LS  # noqa: E402
import test_torch_rnn as RNN  # noqa: E402
from test_torch_dynamic_rnn import Held, close  # noqa: E402
from test_torch_rnn_search import block_ops  # noqa: E402


def run_both(build, feed, seed=51):
    """``build(pkg) -> (main, startup, fetch vars)`` under both packages,
    the JAX startup carried into the port, one run each; returns (JAX
    fetches, port fetches, (JAX main, port main))."""
    jmain, jstart, jfetch = build(jfluid)
    pmain, pstart, pfetch = build(fluid)
    assert block_ops(pmain) == block_ops(jmain)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe._core.rng.seed = seed
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    pexe = fluid.Executor(fluid.CPUPlace())
    pscope = fluid.Scope()
    pexe.run(pstart, scope=pscope)
    LS.carry(jmain, jscope, pmain, pscope)
    out = []
    for pkg, exe, main, scope, fetch in (
            (jfluid, jexe, jmain, jscope, jfetch),
            (fluid, pexe, pmain, pscope, pfetch)):
        out.append([Held(h) for h in exe.run(
            main, feed=feed(pkg) if callable(feed) else feed,
            fetch_list=fetch, scope=scope, return_numpy=False)])
    return out[0], out[1], (jmain, pmain)


def program(pkg, body, train=True):
    """A program over x [4, 6] and y [4, 6] (trainable through an ``fc``
    each, so grads reach the layer under test): ``body(pkg, x, y)`` returns
    the vars to fetch; with ``train`` the sum of their means and y's is
    the loss and x's and y's weight grads are fetched too."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x0 = pkg.data(name="x", shape=[4, 6], dtype="float32")
        y0 = pkg.data(name="y", shape=[4, 6], dtype="float32")
        x = L.fc(x0, size=6, param_attr=pkg.ParamAttr(name="wx"),
                 bias_attr=False)
        y = L.fc(y0, size=6, param_attr=pkg.ParamAttr(name="wy"),
                 bias_attr=False)
        outs = list(body(pkg, x, y))
        fetch = list(outs)
        if train:
            # every output, and y, reach the loss: both weights get grads
            loss = L.sums([L.mean(o) for o in outs] + [L.mean(y)])
            pkg.backward.append_backward(loss)
            fetch += ["wx@GRAD", "wy@GRAD"]
    return main, startup, fetch


def feed_xy(seed=52):
    rng = np.random.RandomState(seed)
    return {"x": rng.uniform(0.5, 1.5, (4, 6)).astype("float32"),
            "y": rng.uniform(0.5, 1.5, (4, 6)).astype("float32")}


def _sdpa(pkg, x, y):
    L = pkg.layers
    kv = L.reshape(y, [2, 2, 6])
    return [pkg.nets.scaled_dot_product_attention(L.reshape(x, [2, 2, 6]),
                                                  kv, kv, num_heads=2)]


LAYERS = {
    "elementwise_max": (lambda p, x, y: [p.layers.elementwise_max(x, y)],
                        True),
    "elementwise_pow": (lambda p, x, y: [p.layers.elementwise_pow(
        p.layers.abs(x), p.layers.scale(p.layers.abs(y), scale=0.5))], True),
    "gelu": (lambda p, x, y: [p.layers.gelu(x)], True),
    "reduce_prod": (lambda p, x, y: [p.layers.reduce_prod(p.layers.scale(
        p.layers.abs(x), scale=0.5, bias=0.5), dim=1)], True),
    "reduce_all_any": (lambda p, x, y: [
        p.layers.cast(p.layers.reduce_all(p.layers.greater_than(x, y),
                                          dim=1), "float32"),
        p.layers.reduce_any(p.layers.greater_than(x, y))], False),
    "zeros_ones_sums": (lambda p, x, y: [
        p.layers.sums([x, y, p.layers.ones([4, 6], "float32"),
                       p.layers.zeros([4, 6], "float32")]),
        p.layers.zeros_like(x)], True),
    "shape_size_is_empty": (lambda p, x, y: [
        p.layers.shape(x), p.layers.size(y), p.layers.is_empty(x)], False),
    "split": (lambda p, x, y: p.layers.split(x, [2, 4], dim=1)
              + p.layers.split(y, 3, dim=-1), True),
    "glu": (lambda p, x, y: [p.nets.glu(x, dim=-1)], True),
    "scaled_dot_product_attention": (_sdpa, True),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_the_jax_package(case):
    body, train = LAYERS[case]
    j, p, _ = run_both(lambda pkg: program(pkg, body, train), feed_xy())
    assert len(j) == len(p)
    for k, (a, b) in enumerate(zip(p, j)):
        close(a.array, b.array, "%s fetch %d" % (case, k))


def loop_program(pkg):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        i = L.zeros([1], "int64")
        s = L.fill_constant([1], "float32", 1.0)
        ten = L.fill_constant([1], "int64", 10)
        i, s = L.while_loop(
            lambda i, s: L.less_than(i, ten),
            lambda i, s: [L.increment(i, 1, in_place=False),
                          L.elementwise_add(L.scale(s, 1.5),
                                            L.cast(i, "float32"))],
            [i, s])
    return main, startup, [i, s]


def test_while_loop_matches_the_jax_package():
    j, p, _ = run_both(loop_program, {})
    want = 1.0
    for k in range(10):
        want = want * 1.5 + k
    for a, b in zip(p, j):
        close(a.array, b.array, "loop vars")
    close(p[1].array, [want], "s against the closed form")
    assert int(p[0].array.reshape(-1)[0]) == 10


def reverse_scatter_program(pkg):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        seq = pkg.data(name="seq", shape=[-1, 3], dtype="float32",
                       lod_level=1)
        seq.stop_gradient = False
        rev = L.sequence_reverse(L.scale(seq, 2.0))
        rev.shape = (-1, 3)  # the JAX layer leaves it unset
        x = pkg.data(name="x", shape=[3, 5], dtype="float32")
        x.stop_gradient = False
        ids = pkg.data(name="ids", shape=[-1, 1], dtype="int64",
                       lod_level=1)
        upd = pkg.data(name="upd", shape=[-1, 1], dtype="float32",
                       lod_level=1)
        upd.stop_gradient = False
        blk = main.current_block()
        out = blk.create_var(name="scattered", dtype="float32",
                             shape=(3, 5))
        blk.append_op("sequence_scatter",
                      {"X": [x], "Ids": [ids], "Updates": [upd]},
                      {"Out": [out]}, {}, infer_shape=False)
        loss = L.elementwise_add(L.reduce_sum(L.square(rev)),
                                 L.reduce_sum(L.square(out)))
        pkg.backward.append_backward(loss)
    return main, startup, [rev, out, "seq@GRAD", "x@GRAD", "upd@GRAD"]


def test_sequence_reverse_and_scatter_match_the_jax_package():
    rng = np.random.RandomState(53)

    def feed(pkg):
        def lod(a, lens):
            return pkg.create_lod_tensor(np.asarray(a), [lens])

        return {"seq": lod(rng_seq, [2, 3, 1]), "x": x,
                "ids": lod(np.array([[0], [4], [2], [2], [1]]), [2, 0, 3]),
                "upd": lod(rng_upd, [2, 0, 3])}

    rng_seq = rng.randn(6, 3).astype("float32")
    x = rng.randn(3, 5).astype("float32")
    rng_upd = rng.randn(5, 1).astype("float32")
    j, p, _ = run_both(reverse_scatter_program, feed)
    for name, a, b in zip(["reversed", "scattered", "seq@GRAD", "x@GRAD",
                           "upd@GRAD"], p, j):
        close(a.array, b.array, name)
    close(p[0].array, 2 * rng_seq[[1, 0, 4, 3, 2, 5]], "reversed rows")
    assert p[0].lod() == [[0, 2, 5, 6]]
    want = x.copy()
    want[0, [0, 4]] += rng_upd[:2, 0]
    np.add.at(want[2], [2, 2, 1], rng_upd[2:, 0])
    close(p[1].array, want, "scattered against numpy")


def random_program(pkg):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        u = L.uniform_random([200, 200], min=-2.0, max=3.0, seed=7)
        g = L.gaussian_random([200, 200], mean=1.0, std=2.0, seed=7)
    return main, startup, [u, g]


def test_random_layers_build_the_jax_ops_and_draw_their_distribution():
    assert block_ops(random_program(fluid)[0]) == \
        block_ops(random_program(jfluid)[0])
    main, _, fetch = random_program(fluid)
    u, g = fluid.Executor(fluid.CPUPlace()).run(main, fetch_list=fetch)
    assert u.shape == g.shape == (200, 200)
    assert u.min() >= -2.0 and u.max() < 3.0
    assert abs(u.mean() - 0.5) < 0.02
    assert abs(u.std() - 5.0 / np.sqrt(12.0)) < 0.02
    assert abs(g.mean() - 1.0) < 0.02 and abs(g.std() - 2.0) < 0.02


def sparse_rows_program(pkg):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data(name="ids", shape=[6, 1], dtype="int64")
        emb = L.embedding(ids, size=[10, 4], is_sparse=True,
                          param_attr=pkg.ParamAttr(name="emb_w"))
        loss = L.mean(L.square(emb))
        pkg.backward.append_backward(loss)
        grad = main.global_block().var("emb_w@GRAD")
        merged = L.merge_selected_rows(grad)
        dense = L.get_tensor_from_selected_rows(merged)
    return main, startup, [dense]


def test_selected_rows_layers_match_the_jax_package():
    """The sparse grad of ids [3, 1, 3, 7, 1, 3]: merged, three rows (1,
    3, 7), their summed grads."""
    feed = {"ids": np.array([[3], [1], [3], [7], [1], [3]], "int64")}
    j, p, _ = run_both(sparse_rows_program, feed)
    assert p[0].array.shape == (3, 4)
    close(p[0].array, j[0].array, "merged rows")


def averaged_program(pkg, kind):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="x", shape=[8, 3], dtype="float32")
        y = pkg.data(name="y", shape=[8, 1], dtype="float32")
        pred = L.fc(L.fc(x, size=5, act="tanh",
                         param_attr=pkg.ParamAttr(name="w1"),
                         bias_attr=pkg.ParamAttr(name="b1")),
                    size=1, param_attr=pkg.ParamAttr(name="w2"),
                    bias_attr=False)
        loss = L.mean(L.square(L.elementwise_sub(pred, y)))
        opt = pkg.optimizer
        if kind == "lookahead":
            opt.LookaheadOptimizer(opt.SGD(0.1), alpha=0.5,
                                   k=2).minimize(loss)
            avg = None
        else:
            opt.SGD(0.1).minimize(loss)
            if kind == "ema":
                avg = opt.ExponentialMovingAverage(0.8)
                avg.update()
            else:
                avg = opt.ModelAverage(0.15)
    return main, startup, loss, avg


PARAMS = ["w1", "b1", "w2"]


def averaged_run(pkg, kind, init):
    """Three SGD steps; ``init`` (every persistable after the JAX
    startup, the slow weights among them) is set over the port's
    startup."""
    main, startup, loss, avg = averaged_program(pkg, kind)
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    rng = np.random.RandomState(54)
    with pkg.scope_guard(scope):
        exe.run(startup)
        if init is None:
            init = LS.persistables(main, scope)
        for n, v in init.items():
            pv = main.global_block()._find_var_recursive(n)
            scope.var(n).get_tensor().set(
                v.astype(str(pv.dtype)) if str(pv.dtype).startswith("int")
                else v)
        losses = []
        for _ in range(3):
            x = rng.randn(8, 3).astype("float32")
            (l,) = exe.run(main, feed={"x": x, "y": x[:, :1] * 2.0},
                           fetch_list=[loss])
            losses.append(float(np.ravel(l)[0]))

        def params():
            return {n: np.array(scope.find_var(n).get_tensor())
                    for n in PARAMS}

        trained, applied = params(), None
        if avg is not None:
            with avg.apply(exe):
                applied = params()
            restored = params()
            for n in PARAMS:
                np.testing.assert_array_equal(restored[n], trained[n])
    return init, losses, trained, applied


@pytest.mark.parametrize("kind", ["ema", "model_average", "lookahead"])
def test_parameter_averaging_matches_the_jax_package(kind):
    """Three SGD steps from the same parameters: the same losses and
    parameters, the same averages under ``apply()``, and the trained
    parameters back after it."""
    assert block_ops(averaged_program(fluid, kind)[0]) == \
        block_ops(averaged_program(jfluid, kind)[0])
    init, jl, jt, ja = averaged_run(jfluid, kind, None)
    _, pl, pt, pa = averaged_run(fluid, kind, init)
    close(pl, jl, "losses")
    for n in PARAMS:
        close(pt[n], jt[n], "trained " + n)
        if ja is not None:
            close(pa[n], ja[n], "applied " + n)
            assert np.abs(pa[n] - pt[n]).max() > 1e-6, n


def test_cudnn_lstm_at_t64_matches_the_jax_op():
    """Two bidirectional layers over 64 steps: forward and grads."""
    rng = RNN._rng("cudnn_lstm_t64")
    T, N, D, H = 64, 3, 4, 6
    ins = RNN._cudnn_lstm_ins(rng, T, N, D, H, 2, True)
    attrs = {"hidden_size": H, "num_layers": 2, "is_bidirec": True,
             "input_size": D, "max_len": T}
    RNN._check("cudnn_lstm", ins, attrs, outs=("Out", "LastH", "LastC"))
