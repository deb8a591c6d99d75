"""The book's ops in the port against the JAX package's, on the CPU:
``square_error_cost``, ``squared_l2_distance``, ``cos_sim``,
``linear_chain_crf``, ``crf_decoding``, ``chunk_eval``, ``accuracy``,
``auc`` and ``depthwise_conv2d``.

Each is registered with the JAX op's slots, attrs and grad kind. Float
outputs and grads are held within 1e-5 of the output's scale (the largest
magnitude, at least 1), as the port's other op tests (``_check`` of
``tests/test_torch_rnn.py``): the CRF's grads for Emission and
Transition, ``cos_sim`` with a zero row (its floor makes the cosine 0);
integer outputs exactly: Viterbi paths with and without ``Label``, chunk
counts in all four schemes with excluded types and ``SeqLength``, top-1
and top-5 accuracy. ``auc``'s statistics are exact; its area within 1e-6,
as the JAX package computes it in float32 (x64 off) where the port keeps
the reference's float64. A ``conv2d(groups=C, use_cudnn=False)`` program
(the layer emits ``depthwise_conv2d``) gives the JAX package's fetch and
filter grad in NCHW and NHWC.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.core.registry import OpInfoMap as JaxOps
from paddle_tpu_torch.core import compiler_engine as ce
from paddle_tpu_torch.core.registry import OpInfoMap

import test_torch_lr_schedule as LS  # noqa: E402
from test_torch_rnn import (  # noqa: E402
    _check, _close, _f, _grad_kind, _rng, _run, _slots)

OPS = ["square_error_cost", "squared_l2_distance", "cos_sim",
       "linear_chain_crf", "crf_decoding", "chunk_eval", "accuracy", "auc",
       "depthwise_conv2d", "save", "load", "save_combine", "load_combine"]


@pytest.mark.parametrize("op_type", OPS)
def test_op_is_registered_as_in_the_jax_package(op_type):
    j, p = JaxOps.instance().get(op_type), OpInfoMap.instance().get(op_type)
    assert _slots(p.inputs) == _slots(j.inputs)
    assert _slots(p.outputs) == _slots(j.outputs)
    assert p.attrs == j.attrs
    assert (p.host_fn is None) == (j.host_fn is None)
    assert _grad_kind(OpInfoMap.instance(), op_type) == \
        _grad_kind(JaxOps.instance(), op_type)


def test_square_error_cost_and_squared_l2_distance():
    rng = _rng("sqerr")
    x, y = _f(rng, 6, 3), _f(rng, 6, 3)
    _check("square_error_cost", {"X": x, "Y": y}, {})
    _check("squared_l2_distance", {"X": x, "Y": y}, {},
           outs=("Out",))


def test_cos_sim_with_a_zero_row():
    rng = _rng("cos")
    x, y = _f(rng, 5, 4), _f(rng, 5, 4)
    x[2] = 0.0
    p = _check("cos_sim", {"X": x, "Y": y}, {}, grad=False)
    assert p["Out"][2, 0] == 0.0
    # the grads where no row is zero (at a zero row both packages take
    # sqrt's grad at 0)
    x[2] = 1.0
    _check("cos_sim", {"X": x, "Y": y}, {}, outs=("Out",))


@pytest.mark.parametrize("shape", [(3, 7, 4), (6, 5)])
def test_linear_chain_crf_and_its_grads(shape):
    rng = _rng("crf", shape)
    K = shape[-1]
    em = _f(rng, *shape)
    trans = _f(rng, K + 2, K) * 0.5
    label = rng.randint(0, K, shape[:-1]).astype("int64")
    _check("linear_chain_crf",
           {"Emission": em, "Transition": trans, "Label": label}, {},
           outs=("LogLikelihood",))


@pytest.mark.parametrize("with_label", [False, True])
def test_crf_decoding_with_and_without_label(with_label):
    rng = _rng("viterbi", with_label)
    B, T, K = 4, 9, 5
    em = _f(rng, B, T, K)
    em[0, 3, :2] = em[0, 3, 2]  # a planted tie: the first maximum wins
    ins = {"Emission": em, "Transition": _f(rng, K + 2, K)}
    if with_label:
        ins["Label"] = rng.randint(0, K, (B, T)).astype("int64")
    j, p = _run("crf_decoding", ins, {})
    assert p["ViterbiPath"].dtype == np.int64
    np.testing.assert_array_equal(p["ViterbiPath"],
                                  np.asarray(j["ViterbiPath"]))


def _host_op(pkg, op_type, ins, outs, attrs, feed, lod=None):
    prog = pkg.Program()
    blk = prog.global_block()
    for slot, names in list(ins.items()) + list(outs.items()):
        for n in names:
            blk.create_var(name=n, dtype="int64")
    blk.append_op(op_type, inputs=ins, outputs=outs, attrs=attrs,
                  infer_shape=False)
    feed = dict(feed)
    for name, l in (lod or {}).items():
        feed[name] = pkg.create_lod_tensor(feed[name], [l], pkg.CPUPlace())
    exe = pkg.Executor(pkg.CPUPlace())
    fetch = [n for ns in outs.values() for n in ns]
    return [np.asarray(v) for v in exe.run(prog, feed=feed,
                                           fetch_list=fetch,
                                           scope=pkg.Scope())]


CHUNK_OUTS = {s: [s.lower().replace("-", "_")] for s in (
    "Precision", "Recall", "F1-Score", "NumInferChunks", "NumLabelChunks",
    "NumCorrectChunks")}


@pytest.mark.parametrize("scheme,ntype", [("IOB", 3), ("IOE", 2),
                                          ("IOBES", 2), ("plain", 4)])
@pytest.mark.parametrize("form", ["dense", "seq_length", "lod"])
def test_chunk_eval_in_every_scheme(scheme, ntype, form):
    rng = _rng("chunk", scheme, form)
    ntag = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    B, T = 4, 12
    hi = ntag * ntype + 1
    lab = rng.randint(0, hi, (B, T)).astype("int64")
    inf = np.where(rng.rand(B, T) < 0.7, lab,
                   rng.randint(0, hi, (B, T))).astype("int64")
    ins = {"Inference": ["inf"], "Label": ["lab"]}
    feed, lod = {"inf": inf, "lab": lab}, None
    if form == "seq_length":
        ins["SeqLength"] = ["len"]
        feed["len"] = rng.randint(3, T + 1, B).astype("int64")
    elif form == "lod":
        lens = [3, 5, 2, 2]
        feed = {"inf": inf.reshape(-1, 1)[:12], "lab": lab.reshape(-1, 1)[:12]}
        lod = {"inf": lens, "lab": lens}
    attrs = {"chunk_scheme": scheme, "num_chunk_types": ntype,
             "excluded_chunk_types": [1] if ntype > 2 else []}
    j = _host_op(jfluid, "chunk_eval", ins, CHUNK_OUTS, attrs, feed, lod)
    ce.reset_counters()
    p = _host_op(fluid, "chunk_eval", ins, CHUNK_OUTS, attrs, feed, lod)
    for a, b in zip(p, j):
        assert a.dtype == b.dtype or (a.dtype, b.dtype) == (
            np.int64, np.int32)
        np.testing.assert_array_equal(a, b)
    assert j[3][0] > 0 and j[5][0] > 0  # chunks were found and matched
    # a host op: the program takes the interpreter, named and counted
    assert ce.counters()["executor.compile_fallbacks"] == 1
    assert "chunk_eval (host)" in ce.untraceable_reasons(
        _chunk_block(fluid, ins, attrs))


def _chunk_block(pkg, ins, attrs):
    prog = pkg.Program()
    prog.global_block().append_op("chunk_eval", inputs=ins,
                                  outputs=CHUNK_OUTS, attrs=attrs,
                                  infer_shape=False)
    return prog.global_block()


@pytest.mark.parametrize("k", [1, 5])
def test_accuracy_top_k(k):
    rng = _rng("acc", k)
    x = _f(rng, 16, 10)
    label = rng.randint(0, 10, (16, 1)).astype("int64")
    idx = np.argsort(-x, axis=1)[:, :k].astype("int64")
    j, p = _run("accuracy", {"Out": np.sort(x, 1)[:, ::-1][:, :k].copy(),
                             "Indices": idx, "Label": label}, {})
    for slot in ("Accuracy", "Correct", "Total"):
        assert p[slot].dtype == np.asarray(j[slot]).dtype, slot
        np.testing.assert_array_equal(p[slot], j[slot])
    # the layer: top_k then accuracy, through the executor
    outs = []
    for pkg in (jfluid, fluid):
        main = pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, pkg.Program()):
            xv = pkg.data(name="x", shape=[16, 10], dtype="float32")
            lv = pkg.data(name="l", shape=[16, 1], dtype="int64")
            acc = pkg.layers.accuracy(xv, lv, k=k)
        outs.append(np.asarray(pkg.Executor(pkg.CPUPlace()).run(
            main, feed={"x": x, "l": label}, fetch_list=[acc],
            scope=pkg.Scope())[0]))
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize("two_col", [False, True])
def test_auc(two_col):
    rng = _rng("auc", two_col)
    n, nt = 64, 200
    p1 = rng.rand(n).astype("float32")
    pred = np.stack([1 - p1, p1], 1) if two_col else p1
    label = (rng.rand(n) < p1).astype("int64").reshape(n, 1)
    pos = rng.randint(0, 3, nt + 1).astype("int64")
    neg = rng.randint(0, 3, nt + 1).astype("int64")
    j, p = _run("auc", {"Predict": pred, "Label": label, "StatPos": pos,
                        "StatNeg": neg}, {"num_thresholds": nt})
    for slot in ("StatPosOut", "StatNegOut"):
        np.testing.assert_array_equal(p[slot], j[slot])
    assert p["AUC"].dtype == np.float64
    np.testing.assert_allclose(p["AUC"], j["AUC"], rtol=0, atol=1e-6)
    assert 0.5 < p["AUC"][0] < 1.0


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_depthwise_conv2d_op_and_grads(fmt):
    rng = _rng("dw", fmt)
    C = 4
    x = _f(rng, 2, C, 7, 6) if fmt == "NCHW" else _f(rng, 2, 7, 6, C)
    w = _f(rng, 2 * C, 1, 3, 3)
    attrs = {"strides": [2, 1], "paddings": [1, 0], "dilations": [1, 2],
             "groups": C, "data_format": fmt}
    _check("depthwise_conv2d", {"Input": x, "Filter": w}, attrs,
           outs=("Output",))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_a_depthwise_conv2d_layer_program_trains_as_the_jax_package(fmt):
    C = 3

    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            shape = [2, C, 6, 6] if fmt == "NCHW" else [2, 6, 6, C]
            x = pkg.data(name="x", shape=shape, dtype="float32")
            y = pkg.layers.conv2d(x, num_filters=C, filter_size=3,
                                  padding=1, groups=C, use_cudnn=False,
                                  data_format=fmt, bias_attr=False)
            loss = pkg.layers.mean(pkg.layers.square(y))
            _, pg = pkg.optimizer.SGD(0.1).minimize(loss)
        assert "depthwise_conv2d" in [op.type for op in
                                      main.global_block().ops]
        return main, startup, [loss, y] + [g for _, g in pg]

    rng = _rng("dwprog", fmt)
    shape = (2, C, 6, 6) if fmt == "NCHW" else (2, 6, 6, C)
    feeds = [{"x": _f(rng, *shape)} for _ in range(2)]
    (j, jstate), (p, pstate), _ = LS.train_both(build, feeds, jax_seed=5)
    for js, ps in zip(j, p):
        for a, b in zip(ps, js):
            _close(a, b, "fetch")
    for n in jstate:
        _close(pstate[n], jstate[n], n)
