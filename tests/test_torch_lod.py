"""The LoD slice of the port against the JAX package on the CPU.

Every sequence op of ``paddle_tpu/ops/sequence_ops.py`` (and its padded
twin), ``sequence_conv`` (plain and with trainable padding), ``lod_reset``
and the LoD ``lstm`` / ``gru`` ops run in a small program built by one
script under both packages, over ragged batches of five sequences of 1-7
rows made from a seed with numpy; both interpreters run it from the JAX
startup's persistables. The outputs must agree with each one's LoD, and so
must the grads of ``mean(out * out)`` with respect to every float input
and parameter: within ``OP_RTOL`` of each tensor's largest magnitude
(floored at ``OP_FLOOR``). Both sides sum rows in other orders (JAX's
segment sums and XLA's dots against ``index_add`` and torch's matmul), so
the limit is a few float32 roundings of the largest value. Ids are
compared by value: the JAX package (x64 off) keeps int32, the port int64.

``sequence_pool(MAX / MIN)`` runs over integer-valued rows, so ties are
frequent: the port must split a tied maximum's gradient as
``jax.ops.segment_max``'s VJP does.

Then ``create_lod_tensor`` and ``DataFeeder`` against the JAX package's,
and both of the Fluid book's understand_sentiment nets (``stacked_lstm_net``
and ``convolution_net``, ``is_sparse=True``, ``Adagrad(0.002)``) at a
narrow width, three steps through both packages' ``Executor.run`` from the
JAX startup's persistables: the losses within 1e-4 relative, the dense
grads within 1e-4 of their scale (floored at 1e-3), the sparse embedding
grad's rows equal and its values within the same limit
(``tests/test_torch_book_training.py``'s limits).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid

LENS = [3, 1, 7, 2, 5]
D = 4
OP_RTOL = 1e-5
OP_FLOOR = 1e-3
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3


def lod_of(lens):
    return [int(v) for v in np.concatenate([[0], np.cumsum(lens)])]


def ragged(pkg, arr, lens):
    return pkg.create_lod_tensor(arr, [list(lens)])


def carry(jmain, jscope, pscope):
    """Every initialised persistable of the JAX run into the port's scope
    (int32 counters made int64)."""
    arrays = {}
    for v in jmain.global_block().vars.values():
        var = jscope.find_var(v.name) if v.persistable else None
        if var is None or not var.is_initialized():
            continue
        a = np.asarray(var.get_tensor())
        arrays[v.name] = a.astype(np.int64) if a.dtype == np.int32 else a
    fluid.io.scope_from_numpy(pscope, arrays, fluid.CPUPlace())


def close(got, want, rtol=OP_RTOL, floor=OP_FLOOR, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=what)
        return
    scale = max(float(np.abs(want).max(initial=0.0)), floor)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def run_both(build, feeds, backward=True):
    """``build(pkg) -> (main, startup, outs, wrt)`` under both packages;
    with ``backward`` the loss is mean(out * out) over the first output and
    the grads of ``wrt`` (names) are fetched too. Both interpreters run
    from the JAX startup's persistables; returns (JAX fetches, port
    fetches), LoDTensors."""
    res = []
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            outs, wrt = build(pkg)
            fetch = list(outs)
            if backward:
                o = outs[0]
                loss = pkg.layers.mean(pkg.layers.elementwise_mul(o, o))
                pkg.backward.append_backward(loss)
                fetch += [n + "@GRAD" for n in wrt]
        res.append((pkg, main, startup, fetch))
    (jp, jmain, jstartup, jfetch), (pp, pmain, _, pfetch) = res
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    pexe, pscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    carry(jmain, jscope, pscope)
    want = jexe._core.run_program(jmain, jscope, feeds(jfluid), jfetch,
                                  return_numpy=False)
    got = pexe._core.run_program(pmain, pscope, feeds(fluid), pfetch,
                                 return_numpy=False)
    return want, got


def check_fetches(want, got):
    for i, (w, g) in enumerate(zip(want, got)):
        wl = [list(level) for level in getattr(w, "lod", lambda: [])()]
        gl = [list(level) for level in getattr(g, "lod", lambda: [])()]
        assert gl == wl, (i, gl, wl)
        close(np.asarray(g), np.asarray(w), what="fetch %d" % i)


def _rows(rng, lens, width=D, ints=False):
    n = sum(lens)
    if ints:  # few distinct values: ties in every long sequence
        return rng.randint(-2, 3, (n, width)).astype("float32")
    return rng.randn(n, width).astype("float32")


def _data(pkg, name, shape, dtype="float32", lod_level=1, grad=True):
    v = pkg.data(name=name, shape=shape, dtype=dtype, lod_level=lod_level)
    v.stop_gradient = not grad
    return v


# -- the LoD ops: forward, output LoD and grads -------------------------------

def _pool(pool):
    def build(pkg):
        x = _data(pkg, "x", [-1, D])
        return [pkg.layers.sequence_pool(x, pool)], ["x"]
    ints = pool in ("MAX", "MIN")
    return build, lambda rng: {"x": (_rows(rng, LENS, ints=ints), LENS)}


def _softmax():
    def build(pkg):
        x = _data(pkg, "x", [-1, 1])
        return [pkg.layers.sequence_softmax(x)], ["x"]
    return build, lambda rng: {"x": (_rows(rng, LENS, 1), LENS)}


def _expand(x_ragged):
    def build(pkg):
        x = _data(pkg, "x", [-1, D], lod_level=1 if x_ragged else 0)
        y = _data(pkg, "y", [-1, 1], grad=False)
        return [pkg.layers.sequence_expand(x, y)], ["x"]

    def make(rng):
        x = (_rows(rng, [2, 1, 3, 1, 2]), [2, 1, 3, 1, 2]) if x_ragged \
            else rng.randn(len(LENS), D).astype("float32")
        return {"x": x, "y": (_rows(rng, LENS, 1), LENS)}
    return build, make


def _expand_as():
    def build(pkg):
        x = _data(pkg, "x", [-1, D], lod_level=0)
        y = _data(pkg, "y", [-1, 1], grad=False)
        return [pkg.layers.sequence_expand_as(x, y)], ["x"]
    return build, lambda rng: {
        "x": rng.randn(len(LENS), D).astype("float32"),
        "y": (_rows(rng, LENS, 1), LENS)}


def _pad(maxlen):
    def build(pkg):
        x = _data(pkg, "x", [-1, D])
        pad = _data(pkg, "pad", [1], lod_level=0)
        out, length = pkg.layers.sequence_pad(x, pad, maxlen=maxlen)
        return [out, length], ["x", "pad"]
    return build, lambda rng: {"x": (_rows(rng, LENS), LENS),
                               "pad": np.array([0.5], "float32")}


def _unpad():
    def build(pkg):
        x = _data(pkg, "x", [-1, 7, D], lod_level=0)
        length = _data(pkg, "len", [-1], dtype="int64", lod_level=0,
                       grad=False)
        return [pkg.layers.sequence_unpad(x, length)], ["x"]
    return build, lambda rng: {
        "x": rng.randn(len(LENS), 7, D).astype("float32"),
        "len": np.array(LENS, "int64")}


def _reshape(new_dim):
    def build(pkg):
        x = _data(pkg, "x", [-1, D])
        return [pkg.layers.sequence_reshape(x, new_dim)], ["x"]
    return build, lambda rng: {"x": (_rows(rng, LENS), LENS)}


def _concat():
    other = [2, 4, 1, 1, 3]

    def build(pkg):
        a = _data(pkg, "a", [-1, D])
        b = _data(pkg, "b", [-1, D])
        return [pkg.layers.sequence_concat([a, b])], ["a", "b"]
    return build, lambda rng: {"a": (_rows(rng, LENS), LENS),
                               "b": (_rows(rng, other), other)}


def _im2sequence():
    def build(pkg):
        x = _data(pkg, "x", [-1, 2, 5, 6], lod_level=0)
        out = pkg.layers.im2sequence(x, filter_size=[2, 3], stride=[1, 2],
                                     padding=[1, 0])
        out.shape = (-1, 2 * 2 * 3)  # the layer infers no shape
        return [out], ["x"]
    return build, lambda rng: {"x": rng.randn(2, 2, 5, 6).astype("float32")}


def _conv(trainable):
    def build(pkg):
        x = _data(pkg, "x", [-1, D])
        blk = pkg.default_main_program().global_block()
        filt = pkg.layers.create_parameter([3 * D, 5], "float32",
                                           name="conv_f")
        ins = {"X": [x], "Filter": [filt]}
        if trainable:
            ins["PaddingData"] = [pkg.layers.create_parameter(
                [2, D], "float32", name="conv_pad",
                default_initializer=pkg.initializer.NormalInitializer())]
        out = blk.create_var(name="conv_out", dtype="float32")
        blk.append_op("sequence_conv", inputs=ins, outputs={"Out": [out]},
                      attrs={"contextLength": 3, "contextStart": -1,
                             "paddingTrainable": trainable})
        return [out], ["x", "conv_f"] + (["conv_pad"] if trainable else [])
    return build, lambda rng: {"x": (_rows(rng, LENS), LENS)}


def _conv_layer():
    def build(pkg):
        x = _data(pkg, "x", [-1, D])
        return [pkg.nets.sequence_conv_pool(x, num_filters=6, filter_size=4,
                                            act="tanh", pool_type="sqrt")], \
            ["x"]
    return build, lambda rng: {"x": (_rows(rng, LENS), LENS)}


def _lstm(peepholes, reverse, init):
    n = len(LENS)

    def build(pkg):
        x = _data(pkg, "x", [-1, 4 * D])
        kw = {}
        if init:
            kw["h_0"] = _data(pkg, "h0", [n, D], lod_level=0)
            kw["c_0"] = _data(pkg, "c0", [n, D], lod_level=0)
        hidden, cell = pkg.layers.dynamic_lstm(
            x, size=4 * D, use_peepholes=peepholes, is_reverse=reverse,
            bias_attr=pkg.ParamAttr(
                initializer=pkg.initializer.NormalInitializer(scale=0.5)),
            **kw)
        return [hidden, cell], ["x"] + (["h0", "c0"] if init else []) + \
            ["lstm.w_0", "lstm.w_1"]

    def make(rng):
        f = {"x": (_rows(rng, LENS, 4 * D), LENS)}
        if init:
            f["h0"] = rng.randn(n, D).astype("float32")
            f["c0"] = rng.randn(n, D).astype("float32")
        return f
    return build, make


def _gru(origin, reverse):
    def build(pkg):
        x = _data(pkg, "x", [-1, 3 * D])
        h0 = _data(pkg, "h0", [len(LENS), D], lod_level=0)
        hidden = pkg.layers.dynamic_gru(
            x, size=D, is_reverse=reverse, origin_mode=origin, h_0=h0,
            bias_attr=pkg.ParamAttr(
                initializer=pkg.initializer.NormalInitializer(scale=0.5)))
        return [hidden], ["x", "h0", "gru.w_0", "gru.w_1"]
    return build, lambda rng: {"x": (_rows(rng, LENS, 3 * D), LENS),
                               "h0": rng.randn(len(LENS), D).astype(
                                   "float32")}


OP_CASES = {
    **{"pool_" + p.lower(): _pool(p) for p in
       ("SUM", "AVERAGE", "SQRT", "MAX", "MIN", "LAST", "FIRST")},
    "softmax": _softmax(),
    "expand_ragged_x": _expand(True),
    "expand_dense_x": _expand(False),
    "expand_as": _expand_as(),
    "pad_to_longest": _pad(None),
    "pad_to_9": _pad(9),
    "unpad": _unpad(),
    "reshape_wider": _reshape(2 * D),
    "reshape_narrower": _reshape(D // 2),
    "concat": _concat(),
    "im2sequence": _im2sequence(),
    "conv": _conv(False),
    "conv_trainable_padding": _conv(True),
    "sequence_conv_pool": _conv_layer(),
    **{"lstm_%s_%s_%s" % (p, r, i): _lstm(p == "peep", r == "rev",
                                          i == "h0c0")
       for p in ("peep", "nopeep") for r in ("fwd", "rev")
       for i in ("h0c0", "zero")},
    **{"gru_%s_%s" % (o, r): _gru(o == "origin", r == "rev")
       for o in ("origin", "plain") for r in ("fwd", "rev")},
}


def _feeds(make, seed):
    def feeds(pkg):
        rng = np.random.RandomState(seed)
        out = {}
        for name, v in make(rng).items():
            out[name] = ragged(pkg, *v) if isinstance(v, tuple) else v
        return out
    return feeds


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_sequence_op_matches_the_jax_package(case):
    build, make = OP_CASES[case]
    want, got = run_both(build, _feeds(make, 3))
    check_fetches(want, got)


# host ops without a grad: forward and output LoD only
def _slice():
    def build(pkg):
        x = _data(pkg, "x", [-1, D])
        off = _data(pkg, "off", [-1, 1], dtype="int64", lod_level=0)
        ln = _data(pkg, "ln", [-1, 1], dtype="int64", lod_level=0)
        return [pkg.layers.sequence_slice(x, off, ln)], []
    return build, lambda rng: {
        "x": (_rows(rng, LENS), LENS),
        "off": np.array([[1], [0], [2], [0], [4]], "int64"),
        "ln": np.array([[2], [1], [5], [1], [1]], "int64")}


def _ids(rng):
    return (rng.randint(0, 6, (sum(LENS), 1)).astype("int64"), LENS)


def _enumerate():
    def build(pkg):
        x = _data(pkg, "x", [-1, 1], dtype="int64", grad=False)
        return [pkg.layers.sequence_enumerate(x, win_size=3, pad_value=9)], []
    return build, lambda rng: {"x": _ids(rng)}


def _erase():
    def build(pkg):
        x = _data(pkg, "x", [-1, 1], dtype="int64", grad=False)
        return [pkg.layers.sequence_erase(x, tokens=[0, 3])], []
    return build, lambda rng: {"x": _ids(rng)}


def _lod_reset(how):
    def build(pkg):
        x = _data(pkg, "x", [-1, D], lod_level=0)
        if how == "attr":
            out = pkg.layers.lod_reset(x, target_lod=lod_of(LENS))
        else:
            y = _data(pkg, "y", [-1, 1], dtype="int64",
                      lod_level=1 if how == "y_lod" else 0, grad=False)
            out = pkg.layers.lod_reset(x, y=y)
        return [out, pkg.layers.sequence_pool(out, "sum")], []

    def make(rng):
        f = {"x": _rows(rng, LENS)}
        if how == "y_lod":
            f["y"] = (rng.randint(0, 5, (sum(LENS), 1)).astype("int64"), LENS)
        elif how == "y_values":
            f["y"] = np.array(lod_of(LENS), "int64").reshape(-1, 1)
        return f
    return build, make


HOST_CASES = {"slice": _slice(), "enumerate": _enumerate(),
              "erase": _erase(), "lod_reset_attr": _lod_reset("attr"),
              "lod_reset_y_lod": _lod_reset("y_lod"),
              "lod_reset_y_values": _lod_reset("y_values")}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_sequence_host_op_matches_the_jax_package(case):
    build, make = HOST_CASES[case]
    want, got = run_both(build, _feeds(make, 4), backward=False)
    check_fetches(want, got)


# -- the padded twins (the lowering's ops) ------------------------------------

T_PAD = 8


def _padded(op, pool=None, n_in=1):
    def build(pkg):
        blk = pkg.default_main_program().global_block()
        xs = [_data(pkg, "x%d" % k, [len(LENS), T_PAD, D], lod_level=0)
              for k in range(n_in)]
        lns = [_data(pkg, "len%d" % k, [len(LENS)], dtype="int64",
                     lod_level=0, grad=False) for k in range(n_in)]
        ins = {"X": xs if op == "sequence_concat_padded" else [xs[0]],
               "Length": lns if op == "sequence_concat_padded"
               else [lns[0]]}
        attrs = {}
        wrt = ["x%d" % k for k in range(n_in)]
        if op == "sequence_pool_padded":
            attrs = {"pooltype": pool, "pad_value": 0.25}
        if op == "sequence_conv_padded":
            ins["Filter"] = [pkg.layers.create_parameter(
                [3 * D, 5], "float32", name="pconv_f")]
            attrs = {"contextLength": 3, "contextStart": -1}
            wrt.append("pconv_f")
        if op == "sequence_expand_padded":
            ins["X"] = [_data(pkg, "xd", [len(LENS), D], lod_level=0)]
            ins["Y"] = [xs[0]]
            wrt = ["xd"]
        if op == "sequence_pad_padded":
            ins["PadValue"] = [_data(pkg, "pad", [1], lod_level=0)]
            attrs = {"padded_length": 6}
            wrt.append("pad")
        out = blk.create_var(name="out", dtype="float32")
        outs = {"Out": [out]}
        if op == "sequence_concat_padded":
            outs["OutLength"] = [blk.create_var(name="olen",
                                                dtype="int64")]
        if op == "sequence_pad_padded":
            outs["Length"] = [blk.create_var(name="plen", dtype="int64")]
        blk.append_op(op, inputs=ins, outputs=outs, attrs=attrs)
        return [out] + outs.get("OutLength", []) + outs.get("Length", []), \
            wrt

    def make(rng):
        f = {}
        for k in range(n_in):
            f["x%d" % k] = rng.randint(-2, 3, (len(LENS), T_PAD, D)).astype(
                "float32") if pool in ("MAX", "MIN") else \
                rng.randn(len(LENS), T_PAD, D).astype("float32")
            lens = np.array(LENS, "int64") if k == 0 else \
                np.array([2, 0, 8, 1, 3], "int64")
            f["len%d" % k] = lens
        f["xd"] = rng.randn(len(LENS), D).astype("float32")
        f["pad"] = np.array([0.5], "float32")
        return f
    return build, make


PADDED_CASES = {
    **{"pool_" + p.lower(): _padded("sequence_pool_padded", p) for p in
       ("SUM", "AVERAGE", "SQRT", "MAX", "MIN", "LAST", "FIRST")},
    "softmax": _padded("sequence_softmax_padded"),
    "conv": _padded("sequence_conv_padded"),
    "expand": _padded("sequence_expand_padded"),
    "pad": _padded("sequence_pad_padded"),
    "unpad": _padded("sequence_unpad_padded"),
    "concat": _padded("sequence_concat_padded", n_in=2),
}


@pytest.mark.parametrize("case", sorted(PADDED_CASES))
def test_padded_twin_matches_the_jax_package(case):
    build, make = PADDED_CASES[case]
    want, got = run_both(build, _feeds(make, 5))
    check_fetches(want, got)


# -- LoD propagation through the interpreter -----------------------------

def test_lod_rides_through_rank_safe_ops_and_the_grad_ops_see_it():
    """ids -> embedding -> fc (mul, elementwise_add) -> tanh -> pool: every
    intermediate carries the feed's LoD in both packages, none of the
    parameters or their grads do, and the pool's grad op pools by the
    sequences (a grad that saw one sequence would differ)."""
    def build(pkg):
        ids = _data(pkg, "ids", [-1, 1], dtype="int64", grad=False)
        emb = pkg.layers.embedding(ids, size=[11, D],
                                   param_attr=pkg.ParamAttr(name="emb"))
        h = pkg.layers.fc(emb, size=3, act="tanh",
                          param_attr=pkg.ParamAttr(name="fc_w"))
        return [pkg.layers.sequence_pool(h, "average"), emb, h], \
            ["emb", "fc_w"]

    want, got = run_both(build, _feeds(lambda rng: {"ids": _ids(rng)}, 6))
    check_fetches(want, got)
    assert [list(level) for level in got[1].lod()] == [lod_of(LENS)]
    assert [list(level) for level in got[2].lod()] == [lod_of(LENS)]
    assert not got[3].lod() and not got[4].lod()


# -- the helpers: create_lod_tensor, DataFeeder ---------------------------

def test_create_lod_tensor_and_random_ids_match_the_jax_package():
    arr = np.arange(10).reshape(10, 1).astype("int64")
    for pkg in (jfluid, fluid):
        t = pkg.create_lod_tensor(arr, [[4, 6]])
        assert t.lod() == [[0, 4, 10]]
        assert t.recursive_sequence_lengths() == [[4, 6]]
        assert t.has_valid_recursive_sequence_lengths()
        np.testing.assert_array_equal(np.asarray(t.array), arr)
        t2 = pkg.create_lod_tensor([[1, 2, 3], [4]], [[3, 1]])
        assert t2.lod() == [[0, 3, 4]] and t2.shape() == (4, 1)
        with pytest.raises(ValueError):
            pkg.create_lod_tensor(np.zeros((5, 1), "int64"), [[4, 6]])
        with pytest.raises(ValueError):
            pkg.LoDTensor().set(np.zeros((3, 1))).set_lod([[0, 2]])
    got = []
    for pkg in (jfluid, fluid):
        np.random.seed(7)
        t = pkg.create_random_int_lodtensor([[2, 3]], base_shape=[1],
                                            low=0, high=9)
        assert t.lod() == [[0, 2, 5]]
        got.append(np.asarray(t.array).astype(np.int64))
    np.testing.assert_array_equal(got[0], got[1])


def test_data_feeder_matches_the_jax_package():
    rng = np.random.RandomState(8)
    samples = [(rng.randint(0, 50, n).tolist(), [int(rng.randint(2))],
                rng.randn(3).tolist()) for n in LENS]
    out = []
    for pkg in (jfluid, fluid):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            words = pkg.layers.data(name="words", shape=[1], dtype="int64",
                                    lod_level=1)
            label = pkg.layers.data(name="label", shape=[1], dtype="int64")
            dense = pkg.layers.data(name="dense", shape=[3],
                                    dtype="float32")
            feeder = pkg.DataFeeder(feed_list=[words, label, dense],
                                    place=pkg.CPUPlace())
        out.append(feeder.feed(samples))
    (jf, pf) = out
    assert pf["words"].lod() == jf["words"].lod() == [lod_of(LENS)]
    np.testing.assert_array_equal(np.asarray(pf["words"].array),
                                  np.asarray(jf["words"].array))
    for name in ("label", "dense"):
        assert pf[name].dtype == jf[name].dtype
        np.testing.assert_array_equal(pf[name], jf[name])
    from paddle_tpu_torch import data_feeder

    with pytest.raises(TypeError):
        data_feeder.check_dtype("int32", "x", ["float32"], "op")
    with pytest.raises(TypeError):
        data_feeder.check_type(1, "x", str, "op")


# -- the book's understand_sentiment nets ---------------------------------

BOOK = dict(vocab=60, emb=16, hid=32, stacked=3, classes=2, batch=6)
BOOK_STEPS = 3
BOOK_LR = 0.002


def sentiment_net(pkg, net, cfg=BOOK, is_sparse=True, lr=BOOK_LR):
    """The Fluid book's understand_sentiment scripts (chapter 06,
    ``train_stacked_lstm.py`` / ``train_conv.py``) under ``pkg``: (main,
    startup, loss, the dense grads' names, the embedding's grad name)."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 1
    L = pkg.layers
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        data = L.data(name="words", shape=[1], dtype="int64", lod_level=1)
        label = L.data(name="label", shape=[1], dtype="int64")
        emb = L.embedding(input=data, size=[cfg["vocab"], cfg["emb"]],
                          is_sparse=is_sparse)
        if net == "conv":
            conv_3 = pkg.nets.sequence_conv_pool(
                input=emb, num_filters=cfg["hid"], filter_size=3,
                act="tanh", pool_type="sqrt")
            conv_4 = pkg.nets.sequence_conv_pool(
                input=emb, num_filters=cfg["hid"], filter_size=4,
                act="tanh", pool_type="sqrt")
            pred = L.fc(input=[conv_3, conv_4], size=cfg["classes"],
                        act="softmax")
        else:
            fc1 = L.fc(input=emb, size=cfg["hid"])
            lstm1, _ = L.dynamic_lstm(input=fc1, size=cfg["hid"])
            inputs = [fc1, lstm1]
            for i in range(2, cfg["stacked"] + 1):
                fc = L.fc(input=inputs, size=cfg["hid"])
                lstm, _ = L.dynamic_lstm(input=fc, size=cfg["hid"],
                                         is_reverse=(i % 2) == 0)
                inputs = [fc, lstm]
            fc_last = L.sequence_pool(input=inputs[0], pool_type="max")
            lstm_last = L.sequence_pool(input=inputs[1], pool_type="max")
            pred = L.fc(input=[fc_last, lstm_last], size=cfg["classes"],
                        act="softmax")
        loss = L.mean(L.cross_entropy(input=pred, label=label))
        _, params_grads = pkg.optimizer.AdagradOptimizer(
            learning_rate=lr).minimize(loss)
    grads = [g.name for p, g in params_grads if "embedding" not in p.name]
    emb_grad = [g.name for p, g in params_grads if "embedding" in p.name][0]
    return main, startup, loss, grads, emb_grad


def sentiment_batches(pkg, cfg=BOOK, steps=BOOK_STEPS, seed=9, max_len=7):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        lens = rng.randint(1, max_len + 1, cfg["batch"])
        ids = rng.randint(0, cfg["vocab"], (int(lens.sum()), 1))
        out.append({"words": pkg.create_lod_tensor(ids.astype("int64"),
                                                   [lens.tolist()]),
                    "label": rng.randint(0, cfg["classes"],
                                         (cfg["batch"], 1)).astype("int64")})
    return out


def _train(pkg, net, scope, exe, main, loss, grads, emb_grad):
    losses, dense, sparse = [], [], []
    for feed in sentiment_batches(pkg):
        # fetching the sparse grad keeps it in the scope (dense here)
        res = exe.run(main, feed=feed, fetch_list=[loss, emb_grad] + grads,
                      scope=scope)
        losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
        dense.append([np.asarray(r) for r in res[2:]])
        sr = scope.find_var(emb_grad).raw()
        sparse.append((list(sr.rows()), np.asarray(sr.get_tensor().array),
                       sr.height()))
    return losses, dense, sparse


@pytest.mark.parametrize("net", ["stacked_lstm", "conv"])
def test_sentiment_net_trains_as_the_jax_package(net):
    jmain, jstartup, jloss, jgrads, jemb = sentiment_net(jfluid, net)
    pmain, pstartup, ploss, pgrads, pemb = sentiment_net(fluid, net)
    assert pgrads == jgrads and pemb == jemb
    # the same program op for op (the fc over LoD and over a list of
    # inputs included), attrs and all
    for want, got in ((jmain, pmain), (jstartup, pstartup)):
        assert [(op.type, op.inputs, op.outputs, dict(op.attrs))
                for op in got.global_block().ops] == \
            [(op.type, op.inputs, op.outputs, dict(op.attrs))
             for op in want.global_block().ops]
    assert "lookup_table_sparse_grad" in \
        [op.type for op in pmain.global_block().ops]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    pexe, pscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    carry(jmain, jscope, pscope)
    want = _train(jfluid, net, jscope, jexe, jmain, jloss, jgrads, jemb)
    got = _train(fluid, net, pscope, pexe, pmain, ploss, pgrads, pemb)
    for step in range(BOOK_STEPS):
        lj, lp = want[0][step], got[0][step]
        assert np.isfinite(lp) and abs(lp - lj) <= LOSS_RTOL * abs(lj), \
            (step, got[0], want[0])
        for name, gj, gp in zip(jgrads, want[1][step], got[1][step]):
            close(gp, gj, GRAD_RTOL, GRAD_FLOOR, "%s step %d" % (name, step))
        (jrows, jvals, jh), (prows, pvals, ph) = want[2][step], got[2][step]
        assert prows == jrows and ph == jh
        close(pvals, jvals, GRAD_RTOL, GRAD_FLOOR, "emb rows %d" % step)
    for name in ("embedding.w_0", "fc.w_0"):
        close(np.asarray(pscope.find_var(name).get_tensor()),
              np.asarray(jscope.find_var(name).get_tensor()), GRAD_RTOL,
              GRAD_FLOOR, name)
