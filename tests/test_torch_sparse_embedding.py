"""Sparse embedding grads (SelectedRows) in the port against the JAX
package on the CPU.

``embedding(is_sparse=True)``'s grad is a ``SelectedRows`` (rows the
looked-up ids, values the output grad's rows, ``padding_idx`` rows
dropped) made by the host op ``lookup_table_sparse_grad``; ``sum`` over
two of them concatenates them; ``sgd`` moves only the touched rows and
``momentum`` / ``adam`` / ``adagrad`` / ``rmsprop`` make it dense first;
the other update ops raise on one; ``merge_selected_rows`` sums duplicate
rows; ``FLAGS_check_nan_inf`` checks its values. A small Wide&Deep-shaped
net (two sparse tables, one read twice) trains three steps through both
packages from the JAX startup's persistables, and the port's sparse run
against its own dense run: losses within 1e-5 relative, parameters within
1e-5 of their scale (floored at 1e-3): a handful of float32 roundings
apart (duplicate rows sum in other orders). With
``PADDLE_TPU_FUSED_OPTIMIZER=flat`` the dense parameters' sgd ops fuse
into one ``fused_optimizer`` op (K4's plain version here) and the sparse
tables' stay out of it.
"""
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.tensor import SelectedRows

from test_torch_lod import close

VOCAB, EMB, BATCH, STEPS = 40, 8, 8, 3
RTOL, FLOOR = 1e-5, 1e-3
KNOB = "PADDLE_TPU_FUSED_OPTIMIZER"


def _sparse_grad_program(pkg, padding_idx=None):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data(name="ids", shape=[6, 1], dtype="int64")
        emb = pkg.layers.embedding(ids, size=[VOCAB, EMB], is_sparse=True,
                                   padding_idx=padding_idx,
                                   param_attr=pkg.ParamAttr(name="w_sr"))
        w = pkg.data(name="wt", shape=[6, EMB], dtype="float32")
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(emb, w))
        pkg.backward.append_backward(loss)
    return main, startup, loss


@pytest.mark.parametrize("padding_idx", [None, 5])
def test_sparse_grad_is_selected_rows_as_in_the_jax_package(padding_idx):
    ids = np.array([[3], [5], [3], [7], [0], [5]], "int64")
    wt = np.random.RandomState(0).randn(6, EMB).astype("float32")
    got = []
    for pkg in (jfluid, fluid):
        main, startup, loss = _sparse_grad_program(pkg, padding_idx)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        dense, = exe.run(main, feed={"ids": ids, "wt": wt},
                         fetch_list=["w_sr@GRAD"], scope=scope)
        g = scope.find_var("w_sr@GRAD").raw()
        got.append((g.rows(), np.asarray(g.get_tensor().array), g.height(),
                    np.asarray(dense)))
    (jr, jv, jh, jd), (pr, pv, ph, pd) = got
    assert isinstance(g, SelectedRows)
    keep = [i for i in ids.ravel().tolist() if i != padding_idx]
    assert pr == jr == keep and ph == jh == VOCAB
    close(pv, jv, RTOL, FLOOR)
    expect = np.zeros((VOCAB, EMB), "float32")
    for k, i in enumerate(ids.ravel()):
        if i != padding_idx:
            expect[i] += wt[k] / (6 * EMB)
    close(pd, expect, RTOL, FLOOR)
    close(pd, jd, RTOL, FLOOR)


def wide_deep(pkg, is_sparse, make_opt):
    """Two tables (the deep one read by two lookups, so its grads sum),
    a dense tower and a wide term."""
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    L = pkg.layers
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data(name="ids", shape=[BATCH, 1], dtype="int64")
        ids2 = pkg.data(name="ids2", shape=[BATCH, 1], dtype="int64")
        dense = pkg.data(name="dense", shape=[BATCH, 4], dtype="float32")
        label = pkg.data(name="label", shape=[BATCH, 1], dtype="int64")
        emb = L.embedding(ids, size=[VOCAB, EMB], is_sparse=is_sparse,
                          param_attr=pkg.ParamAttr(name="t_emb"))
        emb2 = L.embedding(ids2, size=[VOCAB, EMB], is_sparse=is_sparse,
                           param_attr=pkg.ParamAttr(name="t_emb"))
        wide = L.embedding(ids, size=[VOCAB, 2], is_sparse=is_sparse,
                           param_attr=pkg.ParamAttr(name="t_wide"))
        deep = L.concat([emb, emb2, dense], axis=1)
        deep = L.fc(deep, size=16, act="relu",
                    param_attr=pkg.ParamAttr(name="d1"))
        deep = L.fc(deep, size=2, param_attr=pkg.ParamAttr(name="d2"))
        logit = L.elementwise_add(deep, wide)
        loss = L.mean(L.cross_entropy(L.softmax(logit), label))
        make_opt(pkg).minimize(loss)
    return main, startup, loss


def _feeds():
    """One batch (ids from 6 rows, so rows repeat), STEPS times."""
    rng = np.random.RandomState(7)
    return [{"ids": rng.randint(0, 6, (BATCH, 1)).astype("int64"),
             "ids2": rng.randint(0, 6, (BATCH, 1)).astype("int64"),
             "dense": rng.randn(BATCH, 4).astype("float32"),
             "label": rng.randint(0, 2, (BATCH, 1)).astype("int64")}] * STEPS


OPTIMIZERS = {
    "sgd": lambda p: p.optimizer.SGD(learning_rate=0.1),
    "adagrad": lambda p: p.optimizer.AdagradOptimizer(learning_rate=0.1),
    "adam": lambda p: p.optimizer.AdamOptimizer(learning_rate=0.05),
    "momentum": lambda p: p.optimizer.MomentumOptimizer(
        learning_rate=0.1, momentum=0.9),
    "rmsprop": lambda p: p.optimizer.RMSPropOptimizer(learning_rate=0.01),
}
PARAMS = ("t_emb", "t_wide", "d1", "d2")


def _train(pkg, is_sparse, opt, init=None):
    """(main, the startup's persistables, losses, final parameters); the
    port starts from ``init``, the JAX startup's persistables."""
    main, startup, loss = wide_deep(pkg, is_sparse, OPTIMIZERS[opt])
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    if init is None:
        exe.run(startup, scope=scope)
        init = {v.name: np.asarray(scope.find_var(v.name).get_tensor())
                for v in main.global_block().vars.values()
                if v.persistable and scope.find_var(v.name) is not None}
        init = {n: a.astype(np.int64) if a.dtype == np.int32 else a
                for n, a in init.items()}
    else:
        fluid.io.scope_from_numpy(scope, init, fluid.CPUPlace())
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for f in _feeds()]
    params = {n: np.asarray(scope.find_var(n).get_tensor()) for n in PARAMS}
    return main, init, losses, params


@pytest.fixture
def knob():
    old = os.environ.pop(KNOB, None)
    yield
    os.environ.pop(KNOB, None)
    if old is not None:
        os.environ[KNOB] = old


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_sparse_training_matches_the_jax_package_and_dense(opt, knob):
    _, init, jlosses, jparams = _train(jfluid, True, opt)
    pmain, _, plosses, pparams = _train(fluid, True, opt, init)
    ops = [op.type for op in pmain.global_block().ops]
    assert ops.count("lookup_table_sparse_grad") == 3
    dmain, _, dlosses, dparams = _train(fluid, False, opt, init)
    assert "lookup_table_sparse_grad" not in \
        [op.type for op in dmain.global_block().ops]
    for got in (plosses, dlosses):
        np.testing.assert_allclose(got, jlosses, rtol=RTOL, atol=0)
    for n in PARAMS:
        close(pparams[n], jparams[n], RTOL, FLOOR, n)
        close(dparams[n], pparams[n], RTOL, FLOOR, n)
    assert plosses[-1] < plosses[0]


def test_fused_sgd_leaves_the_sparse_tables_out(knob):
    """K4's pass groups the dense sgd updates and spares the sparse
    ones: each table keeps its own sgd op over a SelectedRows grad. (The
    tables' names sort after the dense parameters', so their update ops
    come after the group's: the pass, as the JAX package's, keeps a group
    whose members another op reading the rate lies between apart.)"""
    _, init, jlosses, jparams = _train(jfluid, True, "sgd")
    os.environ[KNOB] = "flat"
    pmain, _, plosses, pparams = _train(fluid, True, "sgd", init)
    ops = pmain.global_block().ops
    fused = [op for op in ops if op.type == "fused_optimizer"]
    assert len(fused) == 1
    assert sorted(fused[0].input("Param")) == ["d1", "d2", "fc.w_0",
                                               "fc.w_1"]
    sgd = sorted(op.input("Param")[0] for op in ops if op.type == "sgd")
    assert sgd == ["t_emb", "t_wide"]
    assert pmain.global_block().var("t_emb@GRAD").type == "selected_rows"
    np.testing.assert_allclose(plosses, jlosses, rtol=RTOL, atol=0)
    for n in PARAMS:
        close(pparams[n], jparams[n], RTOL, FLOOR, n)


@pytest.mark.parametrize("opt", ["adamax", "lamb", "adadelta"])
def test_update_ops_without_a_sparse_form_raise(opt):
    make = {"adamax": lambda p: p.optimizer.AdamaxOptimizer(0.1),
            "lamb": lambda p: p.optimizer.LambOptimizer(0.1),
            "adadelta": lambda p: p.optimizer.AdadeltaOptimizer(0.1)}[opt]
    for pkg in (jfluid, fluid):
        main, startup, loss = wide_deep(pkg, True, make)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(Exception) as err:
            exe.run(main, feed=_feeds()[0], fetch_list=[loss], scope=scope)
        if pkg is fluid:
            assert "takes no SelectedRows" in str(err.value)


def _merge_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data(name="ids", shape=[6, 1], dtype="int64")
        emb = pkg.layers.embedding(ids, size=[VOCAB, EMB], is_sparse=True,
                                   param_attr=pkg.ParamAttr(name="w_sr"))
        w = pkg.data(name="wt", shape=[6, EMB], dtype="float32")
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(emb, w))
        pkg.backward.append_backward(loss)
        blk = main.global_block()
        out = blk.create_var(name="merged", type="selected_rows")
        blk.append_op("merge_selected_rows", inputs={"X": ["w_sr@GRAD"]},
                      outputs={"Out": [out]}, infer_shape=False)
    return main, startup


def test_merge_selected_rows_matches_the_jax_package():
    ids = np.array([[3], [5], [3], [7], [0], [5]], "int64")
    wt = np.random.RandomState(1).randn(6, EMB).astype("float32")
    got = []
    for pkg in (jfluid, fluid):
        main, startup = _merge_program(pkg)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed={"ids": ids, "wt": wt}, fetch_list=["merged"],
                scope=scope)
        m = scope.find_var("merged").raw()
        got.append((list(m.rows()), np.asarray(m.get_tensor().array)))
    assert got[1][0] == got[0][0] == [0, 3, 5, 7]
    close(got[1][1], got[0][1], RTOL, FLOOR)


def _check_nan_inf_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        w = pkg.layers.create_parameter([VOCAB, EMB], "float32", name="w")
        ids = pkg.data(name="ids", shape=[4, 1], dtype="int64")
        og = pkg.data(name="og", shape=[4, EMB], dtype="float32")
        blk = main.global_block()
        g = blk.create_var(name="w@GRAD", type="selected_rows")
        blk.append_op("lookup_table_sparse_grad",
                      inputs={"W": [w], "Ids": [ids], "Out@GRAD": [og]},
                      outputs={"W@GRAD": [g]}, infer_shape=False)
    return main, startup


def test_check_nan_inf_walks_selected_rows_values():
    og = np.ones((4, EMB), "float32")
    og[2, 3] = np.inf
    feed = {"ids": np.array([[1], [2], [3], [4]], "int64"), "og": og}
    for pkg, err in ((jfluid, jfluid.enforce.EnforceNotMet),
                     (fluid, EnforceNotMet)):
        main, startup = _check_nan_inf_program(pkg)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        pkg.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(err, match="Inf/Nan"):
                exe.run(main, feed=feed, fetch_list=[], scope=scope)
            exe.run(main, feed={"ids": feed["ids"],
                                "og": np.ones((4, EMB), "float32")},
                    fetch_list=[], scope=scope)
        finally:
            pkg.set_flags({"FLAGS_check_nan_inf": False})
