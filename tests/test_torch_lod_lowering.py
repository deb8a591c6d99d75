"""The LoD lowering (``core/lod_lowering``) in the port, on the CPU.

A ragged-text program (LoD ids -> embedding -> sequence ops -> fc ->
loss -> sgd, the sentiment and word2vec book shapes) takes the
whole-program route through a lowered clone whose sequence ops are their
padded twins, fed the ids padded to a power-of-two bucket and their
lengths. The cases of ``tests/test_lod_lowering.py`` (the JAX package's
own) run through the port: lowered and interpreted give the same losses
and parameters, within 1e-6 relative (the padded twins sum the same rows
in another order); each also against the JAX package's lowered run, as
``tests/test_torch_lod.py`` holds ops (1e-5 of scale). Bucketing keeps a
run of batches on one padded shape. Each decline is named and counted:
LoD of two levels, an op that reads ragged data and is not rank-safe, a
fetch of a ragged var, the sparse embedding's host op.
"""
import warnings

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import compiler_engine as ce
from paddle_tpu_torch.core import lod_lowering

from test_torch_lod import close

V, E, C = 30, 8, 4
RTOL = 1e-6
JAX_RTOL = 1e-5


def _ragged(pkg, rng, n_seq, max_len=12, lo=1):
    lens = rng.randint(lo, max_len + 1, n_seq)
    vals = rng.randint(0, V, (int(lens.sum()), 1)).astype("int64")
    return pkg.create_lod_tensor(vals, [lens.tolist()])


def _emb(pkg, ids, name):
    return pkg.layers.embedding(ids, size=[V, E],
                                param_attr=pkg.ParamAttr(name=name))


def _head(pkg, x, lab):
    pred = pkg.layers.fc(x, size=C, act="softmax",
                         param_attr=pkg.ParamAttr(name="fc_w"))
    return pkg.layers.mean(pkg.layers.cross_entropy(pred, lab))


def _pool_net(pool):
    def build(pkg):
        ids = pkg.data(name="ids", shape=[-1, 1], dtype="int64", lod_level=1)
        lab = pkg.data(name="lab", shape=[-1, 1], dtype="int64")
        return _head(pkg, pkg.layers.sequence_pool(_emb(pkg, ids, "emb_w"),
                                                   pool_type=pool), lab)

    def feeds(pkg, rng):
        return {"ids": _ragged(pkg, rng, 6),
                "lab": rng.randint(0, C, (6, 1)).astype("int64")}
    return build, feeds, ["emb_w", "fc_w"]


def _conv_net():
    def build(pkg):
        ids = pkg.data(name="ids", shape=[-1, 1], dtype="int64", lod_level=1)
        lab = pkg.data(name="lab", shape=[-1, 1], dtype="int64")
        conv = pkg.layers.sequence_conv(
            _emb(pkg, ids, "emb_w"), num_filters=6, filter_size=3,
            act="tanh", param_attr=pkg.ParamAttr(name="conv_w"))
        return _head(pkg, pkg.layers.sequence_pool(conv, pool_type="MAX"),
                     lab)

    def feeds(pkg, rng):
        return {"ids": _ragged(pkg, rng, 6, 10, 2),
                "lab": rng.randint(0, C, (6, 1)).astype("int64")}
    return build, feeds, ["emb_w", "conv_w", "fc_w"]


def _mt_chain():
    """Dense encoder state expanded over the ragged target, re-padded,
    unpadded and pooled (the book MT decoder's shape)."""
    def build(pkg):
        L = pkg.layers
        src = pkg.data(name="src", shape=[-1, 1], dtype="int64", lod_level=1)
        tgt = pkg.data(name="tgt", shape=[-1, 1], dtype="int64", lod_level=1)
        lab = pkg.data(name="lab", shape=[-1, 1], dtype="int64")
        enc = L.sequence_pool(_emb(pkg, src, "semb_w"), pool_type="LAST")
        temb = _emb(pkg, tgt, "temb_w")
        mix = L.elementwise_add(temb, L.sequence_expand(enc, temb))
        padded = L.sequence_pad(mix, L.fill_constant([1], "float32", 0.0),
                                maxlen=16)
        unpadded = L.sequence_unpad(padded[0], padded[1])
        return _head(pkg, L.sequence_pool(unpadded, pool_type="AVERAGE"),
                     lab)

    def feeds(pkg, rng):
        return {"src": _ragged(pkg, rng, 6, 10, 2),
                "tgt": _ragged(pkg, rng, 6, 10, 2),
                "lab": rng.randint(0, C, (6, 1)).astype("int64")}
    return build, feeds, ["semb_w", "temb_w", "fc_w"]


def _concat_net():
    def build(pkg):
        a = pkg.data(name="a", shape=[-1, 1], dtype="int64", lod_level=1)
        b = pkg.data(name="b", shape=[-1, 1], dtype="int64", lod_level=1)
        lab = pkg.data(name="lab", shape=[-1, 1], dtype="int64")
        cat = pkg.layers.sequence_concat([_emb(pkg, a, "ea_w"),
                                          _emb(pkg, b, "eb_w")])
        return _head(pkg, pkg.layers.sequence_pool(cat, "AVERAGE"), lab)

    def feeds(pkg, rng):
        return {"a": _ragged(pkg, rng, 6, 10, 2),
                "b": _ragged(pkg, rng, 6, 10, 2),
                "lab": rng.randint(0, C, (6, 1)).astype("int64")}
    return build, feeds, ["ea_w", "eb_w", "fc_w"]


CASES = {**{"pool_" + p.lower(): _pool_net(p)
            for p in ("AVERAGE", "MAX", "LAST", "SQRT")},
         "sequence_conv": _conv_net(), "mt_expand_pad_unpad": _mt_chain(),
         "sequence_concat": _concat_net()}


def _program(pkg, build, lr=0.1):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        loss = build(pkg)
        pkg.optimizer.SGDOptimizer(lr).minimize(loss)
    return main, startup, loss


def _run(pkg, build, feeds, params, init=None, route="default", steps=3):
    """Losses and final params of ``steps`` SGD steps; ``route`` is the
    executor's default or the interpreter."""
    main, startup, loss = _program(pkg, build)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    exe.run(startup, scope=scope)
    if init is not None:
        fluid.io.scope_from_numpy(scope, init, fluid.CPUPlace())
    if pkg is fluid:
        ce.reset_counters()
    start = {n: np.asarray(scope.find_var(n).get_tensor()) for n in params}
    rng = np.random.RandomState(1)
    losses = []
    for _ in range(steps):
        feed = feeds(pkg, rng)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if route == "interp":
                (l,) = exe._core.run_program(main, scope, feed, [loss])
            else:
                (l,) = exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope)
        losses.append(float(np.ravel(l)[0]))
    final = {n: np.asarray(scope.find_var(n).get_tensor()) for n in params}
    return losses, final, start, exe


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowered_program_matches_the_interpreter_and_the_jax_package(case):
    build, feeds, params = CASES[case]
    jl, jp, init, jexe = _run(jfluid, build, feeds, params)
    assert any(v not in (None, False)
               for v in jexe._lod_lowered_cache.values()), case
    pl, pp, _, pexe = _run(fluid, build, feeds, params, init)
    c = ce.counters()
    assert (c["lod_lowering.lowered"], c["lod_lowering.declines"],
            c["executor.compile_fallbacks"], c["executor.steps"]) == \
        (1, 0, 0, 3), (c, ce.declines())
    il, ip, _, _ = _run(fluid, build, feeds, params, init, route="interp")
    np.testing.assert_allclose(pl, il, rtol=RTOL, atol=0)
    np.testing.assert_allclose(pl, jl, rtol=JAX_RTOL, atol=0)
    for n in params:
        assert not np.allclose(pp[n], init[n]), "%s never moved" % n
        close(pp[n], ip[n], RTOL, 1e-3, n)
        close(pp[n], jp[n], JAX_RTOL, 1e-3, n)


def test_bucketing_keeps_one_padded_shape_and_one_step_function():
    """Batches whose longest sequence lands in one power-of-two bucket
    pad to one shape, so on the card they replay one graph; the lengths
    are a feed, never a constant of the step."""
    build, _, _ = _pool_net("AVERAGE")
    main, startup, loss = _program(fluid, build)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(2)
    ce.reset_counters()
    shapes = set()
    for max_len in (9, 11, 14, 16):
        feed = {"ids": _ragged(fluid, rng, 6, max_len, max_len),
                "lab": rng.randint(0, C, (6, 1)).astype("int64")}
        lowered, padded = exe._lod_lowered(main, feed, [loss])
        shapes.add((tuple(padded["ids"].shape),
                    tuple(padded["ids@SEQ_LEN"].shape)))
        np.testing.assert_array_equal(padded["ids@SEQ_LEN"].numpy(),
                                      feed["ids"].recursive_sequence_lengths(
                                      )[0])
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert shapes == {((6, 16, 1), (6,))}
    c = ce.counters()
    assert (c["executor.compiles"], c["executor.steps"],
            c["lod_lowering.lowered"]) == (1, 4, 1)
    assert [lod_lowering.bucket_len(n) for n in (1, 8, 9, 16, 17, 464)] \
        == [8, 8, 16, 16, 32, 512]


def _decline_case(pkg, what):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        if what == "multi_level":
            x = pkg.data(name="x", shape=[-1, 1], dtype="float32",
                         lod_level=2)
            out = L.mean(L.sequence_pool(x, pool_type="SUM"))
        elif what == "softmax_mean":
            x = pkg.data(name="x", shape=[-1, 1], dtype="float32",
                         lod_level=1)
            out = L.mean(L.sequence_softmax(x))
        elif what == "fc_over_lod":
            x = pkg.data(name="x", shape=[-1, 1], dtype="float32",
                         lod_level=1)
            out = L.mean(L.sequence_pool(L.fc(x, size=3), "SUM"))
    return main, startup, out


DECLINES = {
    "multi_level": ([[0, 2, 4], [0, 3, 5, 9, 11]], 16.5,
                    "feed: multi-level LoD"),
    "softmax_mean": ([[0, 3, 11]], 2.0 / 11.0,
                     "mean: unsupported op consumes ragged data"),
    "fc_over_lod": ([[0, 3, 11]], None,
                    "mul: unsupported op consumes ragged data"),
}


@pytest.mark.parametrize("what", sorted(DECLINES))
def test_a_declined_lowering_is_named_counted_and_interpreted(what):
    lod, want, reason = DECLINES[what]
    vals = np.arange(1, lod[-1][-1] + 1, dtype="float32").reshape(-1, 1)
    got = []
    for pkg in (jfluid, fluid):
        main, startup, out = _decline_case(pkg, what)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        if pkg is jfluid:
            # the JAX startup's weights come from its executor's RNG, which
            # draws its seed from numpy's global state unless it is set:
            # pinned, the case no longer depends on what ran before it
            exe._core.rng.seed = 90
        exe.run(startup, scope=scope)
        if pkg is fluid:
            init = {v.name: np.asarray(jscope.find_var(v.name).get_tensor())
                    for v in jmain.global_block().vars.values()
                    if v.persistable}
            fluid.io.scope_from_numpy(scope, init, fluid.CPUPlace())
            ce.reset_counters()
        t = pkg.LoDTensor().set(vals).set_lod(lod)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for _ in range(2):
                (v,) = exe.run(main, feed={"x": t}, fetch_list=[out],
                               scope=scope)
        got.append(float(np.ravel(v)[0]))
        jmain, jscope = main, scope
    c = ce.counters()
    assert c["lod_lowering.declines"] == 1 and ce.declines() == {reason: 1}
    assert c["executor.compile_fallbacks"] == 1 and \
        c["lod_lowering.lowered"] == 0
    assert any("LoD lowering declined" in str(x.message) and reason
               in str(x.message) for x in w)
    if want is not None:
        np.testing.assert_allclose(got[1], want, rtol=1e-6)
    np.testing.assert_allclose(got[1], got[0], rtol=1e-6)


def test_a_ragged_fetch_declines_that_call_only():
    build, feeds, _ = _pool_net("AVERAGE")
    main, startup, loss = _program(fluid, build)
    emb = [op for op in main.global_block().ops
           if op.type == "lookup_table"][0].output("Out")[0]
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(3)
    ce.reset_counters()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exe.run(main, feed=feeds(fluid, rng), fetch_list=[loss], scope=scope)
        feed = feeds(fluid, rng)
        l, e = exe.run(main, feed=feed, fetch_list=[loss, emb], scope=scope,
                       return_numpy=False)
        exe.run(main, feed=feeds(fluid, rng), fetch_list=[loss], scope=scope)
    assert e.lod() == feed["ids"].lod()  # the interpreter's ragged rows
    assert ce.declines() == {"fetch: ragged var " + emb: 1}
    assert ce.counters()["executor.steps"] == 2


def test_sparse_embedding_declines_by_its_host_op():
    def build(pkg):
        ids = pkg.data(name="ids", shape=[-1, 1], dtype="int64", lod_level=1)
        lab = pkg.data(name="lab", shape=[-1, 1], dtype="int64")
        emb = pkg.layers.embedding(ids, size=[V, E], is_sparse=True)
        return _head(pkg, pkg.layers.sequence_pool(emb, "SUM"), lab)

    main, startup, loss = _program(fluid, build)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    ce.reset_counters()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exe.run(main, feed={"ids": _ragged(fluid, np.random.RandomState(4),
                                           5),
                            "lab": np.zeros((5, 1), "int64")},
                fetch_list=[loss], scope=scope)
    assert ce.declines() == {
        "lookup_table_sparse_grad: unsupported op consumes ragged data": 1}


def test_param_never_carries_sequence_lod():
    """A batch whose token count equals the vocabulary: the table grad's
    rows match the LoD, yet no persistable may carry it (a later batch of
    another total must still run)."""
    build, feeds, _ = _pool_net("AVERAGE")
    main, startup, loss = _program(fluid, build)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(4)
    t = fluid.create_lod_tensor(rng.randint(0, V, (V, 1)).astype("int64"),
                                [[15, V - 15]])
    exe._core.run_program(main, scope, {
        "ids": t, "lab": rng.randint(0, C, (2, 1)).astype("int64")}, [loss])
    for v in main.global_block().vars.values():
        if v.persistable and scope.find_var(v.name) is not None:
            assert not scope.find_var(v.name).get_tensor().lod(), v.name
    (l,) = exe._core.run_program(main, scope, {
        "ids": _ragged(fluid, rng, 5, 7),
        "lab": rng.randint(0, C, (5, 1)).astype("int64")}, [loss])
    assert np.isfinite(float(np.ravel(l)[0]))
