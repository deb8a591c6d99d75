"""The recurrent family of the port against the JAX package, on the CPU.

- The new ops (``squeeze2``, ``unsqueeze2``, ``stack``, ``top_k``,
  ``one_hot``, ``gather_tree``, ``fill_zeros_like``, the logical ops,
  ``lstm_unit``, ``gru_unit``, ``cudnn_lstm``) are registered with the JAX
  package's slots, attrs and grad kind, and their functions (and grad ops)
  give the JAX functions' results on the same seeded inputs. ``top_k``
  breaks planted ties as ``jax.lax.top_k``, lower index first.
- ``rnn`` (with and without ``sequence_length``, reversed, time-major),
  ``StaticRNN``, ``lstm`` (``cudnn_lstm``, bidirectional over 2 layers),
  the seq2seq base model (a stack of two ``LSTMCell``s each side, ``rnn``
  with lengths on both sides, a masked ``softmax_with_cross_entropy``,
  Adam under a global-norm clip) and its beam decode
  (``BeamSearchDecoder`` + ``dynamic_decode``) build the JAX package's
  program from the same script, op for op, and run or train from the JAX
  startup's persistables to the same numbers.
- The JAX package's beam-search oracle cases
  (``tests/test_beam_search.py``) and the book's ``TestUnderstandSentiment``
  and ``TestMachineTranslation`` scripts run through the port.

Tolerances: op outputs within 1e-5 of the output's scale (the largest
magnitude, at least 1), as the other op tests; persistables after the
steps, losses, outputs and beam scores within 1e-5 of each tensor's
scale; beam ids and integer outputs exactly. Integers are compared by
value: the JAX package (x64 off) keeps int64 as int32, and its ``cast``
records such an input as int32 (``in_dtype`` 2 where the port writes 3).
"""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.core.registry import OpInfoMap as JaxOps
from paddle_tpu_torch.core.registry import (DEVICE_ATTR, GENERATOR_ATTR,
                                            OpInfoMap)

import test_torch_lr_schedule as LS  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-5

NEW_OPS = ["squeeze2", "unsqueeze2", "stack", "top_k", "one_hot",
           "gather_tree", "fill_zeros_like", "logical_and", "logical_or",
           "logical_xor", "logical_not", "lstm_unit", "gru_unit",
           "cudnn_lstm"]


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _f(rng, *shape):
    return np.asarray(rng.randn(*shape), dtype="float32")


def _slots(slots):
    return [(s.name, s.duplicable, s.dispensable, s.no_grad) for s in slots]


def _grad_kind(ops, t):
    info = ops.get(t)
    if callable(info.grad):
        return "maker"
    return "op" if ops.has(t + "_grad") else None


@pytest.mark.parametrize("op_type", NEW_OPS)
def test_op_is_registered_as_in_the_jax_package(op_type):
    j, p = JaxOps.instance().get(op_type), OpInfoMap.instance().get(op_type)
    assert _slots(p.inputs) == _slots(j.inputs)
    assert _slots(p.outputs) == _slots(j.outputs)
    assert p.attrs == j.attrs
    assert p.needs_rng == j.needs_rng
    assert _grad_kind(OpInfoMap.instance(), op_type) == \
        _grad_kind(JaxOps.instance(), op_type)


def _to_j(v):
    if isinstance(v, list):
        return [jnp.asarray(x) for x in v]
    return None if v is None else jnp.asarray(v)


def _to_p(v):
    if isinstance(v, list):
        return [torch.from_numpy(np.array(x)) for x in v]
    return None if v is None else torch.from_numpy(np.array(v))


def _np(v):
    if isinstance(v, (list, tuple)):
        return [_np(x) for x in v]
    return np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)


def _run(op_type, ins, attrs):
    """(JAX outputs, port outputs) of ``op_type`` as numpy arrays."""
    jinfo = JaxOps.instance().get(op_type)
    jattrs = dict(jinfo.attrs)
    jattrs.update(attrs)
    j = jinfo.fn({k: _to_j(v) for k, v in ins.items()}, jattrs)
    pinfo = OpInfoMap.instance().get(op_type)
    pattrs = dict(pinfo.attrs)
    pattrs.update(attrs)
    pattrs[DEVICE_ATTR] = CPU
    if pinfo.needs_rng:
        pattrs[GENERATOR_ATTR] = torch.Generator().manual_seed(0)
    p = pinfo.fn({k: _to_p(v) for k, v in ins.items()}, pattrs)
    return ({k: _np(v) for k, v in j.items() if v is not None},
            {k: _np(v) for k, v in p.items() if v is not None})


def _close(got, want, name, tol=TOL):
    if isinstance(want, list):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, "%s[%d]" % (name, i), tol)
        return
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=name)


def _check(op_type, ins, attrs, outs=("Out",), grad=True, seed=0):
    """Forward outputs, then (``grad``) the ``<op_type>_grad`` op of both
    packages with the same random grads of ``outs``."""
    j, p = _run(op_type, ins, attrs)
    assert set(p) == set(j), (sorted(p), sorted(j))
    for slot in j:
        _close(p[slot], j[slot], slot)
    if not grad:
        return p
    gins = dict(ins)
    for k, out in enumerate(outs):
        gins[out + "@GRAD"] = _f(_rng(op_type, seed, k), *j[out].shape)
    jg, pg = _run(op_type + "_grad", gins, attrs)
    assert set(pg) == set(jg) and pg, (sorted(pg), sorted(jg))
    for slot in jg:
        _close(pg[slot], jg[slot], slot)
    return p


SHAPE_CASES = {
    "squeeze2_listed": ("squeeze2", (3, 1, 4, 1), {"axes": [1, -1]}),
    "squeeze2_all": ("squeeze2", (1, 3, 1), {"axes": []}),
    "unsqueeze2": ("unsqueeze2", (3, 4), {"axes": [0, 2]}),
}


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_shape_ops_match_the_jax_ops(case):
    op_type, shape, attrs = SHAPE_CASES[case]
    p = _check(op_type, {"X": _f(_rng(case), *shape)}, attrs)
    assert p["XShape"].shape == (0,) + shape


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_stack_matches_the_jax_op(axis):
    rng = _rng("stack", axis)
    xs = [_f(rng, 3, 4) for _ in range(3)]
    _check("stack", {"X": xs}, {"axis": axis}, outs=("Y",))


def test_top_k_breaks_ties_as_jax():
    """Planted ties: rows of a few distinct values, each repeated; the
    indices must be the lower index first, as jax.lax.top_k and a stable
    descending argsort give them, and the values' grad must land there."""
    rng = _rng("top_k")
    x = rng.choice([-1.0, 0.0, 0.5, 2.0], size=(6, 40)).astype("float32")
    x[0] = 1.0  # one row all equal
    for k in (1, 5, 40):
        p = _check("top_k", {"X": x}, {"k": k}, seed=k)
        want = np.argsort(-x, axis=1, kind="stable")[:, :k]
        np.testing.assert_array_equal(p["Indices"], want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top_k_key_order_over_signs_infinities_and_ties(dtype):
    """The int64 keys order every float as the floats order: negative and
    positive values, infinities, values near zero, repeats; the indices
    are a stable descending sort's, the values those entries'."""
    from paddle_tpu_torch.core.registry import OpInfoMap

    rng = _rng("top_k_keys", dtype)
    fn = OpInfoMap.instance().get("top_k").fn
    for _ in range(5):
        x = rng.choice([-1e9, -3.0, -2.5, 0.0, 1.5, -0.5, 7.0, -1e-30,
                        1e-30, np.inf, -np.inf], size=(5, 300))
        x[:, ::7] = rng.randn(5, 43)
        t = torch.tensor(x, dtype=getattr(torch, dtype))
        xs = t.float().numpy()
        for k in (1, 10, 300):
            out = fn({"X": t}, {"k": k, DEVICE_ATTR: CPU})
            want = np.argsort(-xs, axis=1, kind="stable")[:, :k]
            np.testing.assert_array_equal(out["Indices"].numpy(), want)
            assert out["Out"].dtype == t.dtype
            np.testing.assert_array_equal(out["Out"].float().numpy(),
                                          np.take_along_axis(xs, want, 1))


def test_top_k_on_a_finished_beam_row():
    """A finished beam's row: the end token at 0, every other candidate
    at the same -1e9 plus the beam's score (BeamSearchDecoder's noend
    mask), beside a live beam's scores."""
    V, K = 11, 4
    row = np.full((2 * V,), -1e9 - 3.0, "float32")
    row[1] = -3.0
    row[V:] = _f(_rng("live"), V) - 5.0
    p = _check("top_k", {"X": row[None]}, {"k": K})
    np.testing.assert_array_equal(
        p["Indices"][0], np.argsort(-row, kind="stable")[:K])


def test_one_hot_matches_the_jax_op():
    ids = np.array([[0], [3], [6], [-1], [7]], "int64")  # two out of range
    _check("one_hot", {"X": ids}, {"depth": 7}, grad=False)
    _check("one_hot", {"X": ids.reshape(-1)}, {"depth": 7}, grad=False)


def test_gather_tree_matches_the_jax_op():
    T, B, W = 7, 3, 4
    rng = _rng("gather_tree")
    ids = rng.randint(0, 50, (T, B, W)).astype("int64")
    parents = rng.randint(0, W, (T, B, W)).astype("int64")
    _check("gather_tree", {"Ids": ids, "Parents": parents}, {}, grad=False)


@pytest.mark.parametrize("op_type", ["logical_and", "logical_or",
                                     "logical_xor", "logical_not"])
def test_logical_ops_match_the_jax_ops(op_type):
    rng = _rng(op_type)
    ins = {"X": rng.rand(4, 5) > 0.5}
    if op_type != "logical_not":
        ins["Y"] = rng.rand(4, 5) > 0.5
    p = _check(op_type, ins, {}, grad=False)
    assert p["Out"].dtype == np.bool_


def test_fill_zeros_like_matches_the_jax_op():
    _check("fill_zeros_like", {"X": _f(_rng("fzl"), 3, 2)}, {}, grad=False)


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_unit_matches_the_jax_op(forget_bias):
    rng = _rng("lstm_unit", forget_bias)
    _check("lstm_unit", {"X": _f(rng, 5, 4 * 6), "C_prev": _f(rng, 5, 6)},
           {"forget_bias": forget_bias}, outs=("C", "H"))


@pytest.mark.parametrize("origin_mode", [False, True])
@pytest.mark.parametrize("bias", [True, False])
def test_gru_unit_matches_the_jax_op(origin_mode, bias):
    rng = _rng("gru_unit", origin_mode, bias)
    D = 6
    ins = {"Input": _f(rng, 5, 3 * D), "HiddenPrev": _f(rng, 5, D),
           "Weight": _f(rng, D, 3 * D) * 0.5,
           "Bias": _f(rng, 1, 3 * D) if bias else None}
    _check("gru_unit", ins, {"origin_mode": origin_mode}, outs=("Hidden",))


def _cudnn_lstm_ins(rng, T, N, D, H, layers, bidi):
    ndir = 2 if bidi else 1
    n, din = 0, D
    for _ in range(layers):
        n += ndir * (din * 4 * H + H * 4 * H + 4 * H)
        din = H * ndir
    return {"Input": _f(rng, T, N, D), "InitH": _f(rng, layers * ndir, N, H),
            "InitC": _f(rng, layers * ndir, N, H),
            "W": _f(rng, n) * 0.3}


@pytest.mark.parametrize("layers,bidi", [(2, True), (1, False)])
def test_cudnn_lstm_matches_the_jax_op(layers, bidi):
    rng = _rng("cudnn_lstm", layers, bidi)
    T, N, D, H = 5, 3, 4, 6
    ins = _cudnn_lstm_ins(rng, T, N, D, H, layers, bidi)
    attrs = {"hidden_size": H, "num_layers": layers, "is_bidirec": bidi,
             "input_size": D, "max_len": T}
    p = _check("cudnn_lstm", ins, attrs, outs=("Out", "LastH", "LastC"))
    assert p["Out"].shape == (T, N, H * (2 if bidi else 1))


def test_cudnn_lstm_dropout_draws_one_mask_for_forward_and_grad():
    """Between layers a dropout mask from the executor's generator: the
    grad op, seeded as the forward, re-draws the same mask (its zeros
    give zero grads), and another seed draws another."""
    info = OpInfoMap.instance().get("cudnn_lstm")
    rng = _rng("cudnn_dropout")
    T, N, D, H = 4, 3, 4, 5
    ins = {k: torch.from_numpy(v) for k, v in
           _cudnn_lstm_ins(rng, T, N, D, H, 2, False).items()}
    attrs = dict(info.attrs, hidden_size=H, num_layers=2, dropout_prob=0.5,
                 input_size=D)
    attrs[DEVICE_ATTR] = CPU

    def run(seed):
        a = dict(attrs)
        a[GENERATOR_ATTR] = torch.Generator().manual_seed(seed)
        return info.fn(ins, a)["Out"]

    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    a = dict(attrs, is_test=True)
    no_drop = info.fn(ins, a)["Out"]
    a = dict(attrs, dropout_prob=0.0)
    assert torch.equal(no_drop, info.fn(ins, a)["Out"])


# -- programs: the same script under both packages ---------------------------

def norm_seq(program):
    """op_seq with cast's in_dtype int32 and int64 read as one (the JAX
    package records int64 inputs as int32)."""
    out = []
    for t, i, o, a in LS.op_seq(program):
        if t == "cast" and a.get("in_dtype") == 2:
            a = dict(a, in_dtype=3)
        out.append((t, i, o, a))
    return out


def _close_state(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].astype(want[k].dtype) if np.issubdtype(
            want[k].dtype, np.integer) else got[k], want[k], k, tol)


def both(build, feeds):
    """``build(pkg) -> (main, startup, fetches)`` run under both packages
    from the JAX startup's persistables, drawn from a seed named by the
    build (as ``_rng``), not from whatever numpy's global state the tests
    before left: the programs must be the same, the fetches and
    persistables after each feed within TOL."""
    (j, jstate), (p, pstate), (jmain, pmain) = LS.train_both(
        build, feeds, jax_seed=zlib.crc32(build.__name__.encode()) or 1)
    assert norm_seq(pmain) == norm_seq(jmain)
    for js, ps in zip(j, p):
        for a, b in zip(ps, js):
            _close(a if not np.issubdtype(b.dtype, np.integer)
                   else a.astype(np.int64), b, "fetch")
    _close_state(pstate, jstate)
    return p, pstate


def _rnn_script(seq_len, reverse, time_major, cell="lstm"):
    B, T, D, H = 3, 5, 4, 6

    def build(pkg):
        from importlib import import_module

        R = import_module(pkg.__name__ + ".layers.rnn")
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            shape = [T, B, D] if time_major else [B, T, D]
            x = pkg.data(name="x", shape=shape, dtype="float32")
            lens = pkg.data(name="lens", shape=[B], dtype="int64")
            c = R.LSTMCell(H) if cell == "lstm" else R.GRUCell(H)
            out, states = R.rnn(c, x, sequence_length=lens if seq_len
                                else None, time_major=time_major,
                                is_reverse=reverse)
            loss = pkg.layers.mean(out)
            pkg.optimizer.SGD(0.5).minimize(loss)
        return main, startup, [loss, out] + list(states)

    rng = _rng("rnn", seq_len, reverse, time_major, cell)
    feeds = [{"x": _f(rng, *([T, B, D] if time_major else [B, T, D])),
              "lens": np.array([5, 2, 3], "int64")} for _ in range(2)]
    return build, feeds


RNN_CASES = [(False, False, False, "lstm"), (True, False, False, "lstm"),
             (True, True, False, "lstm"), (False, False, True, "lstm"),
             (True, True, True, "lstm"), (True, False, False, "gru")]


@pytest.mark.parametrize("case", RNN_CASES, ids=lambda c: "%s%s%s_%s" % (
    "lengths_" if c[0] else "", "reverse_" if c[1] else "",
    "time_major" if c[2] else "batch_major", c[3]))
def test_rnn_trains_as_the_jax_package(case):
    both(*_rnn_script(*case))


def test_static_rnn_trains_as_the_jax_package():
    T, B, D, H = 4, 3, 5, 6

    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data(name="x", shape=[T, B, D], dtype="float32")
            x.stop_gradient = False
            rnn = pkg.layers.StaticRNN()
            with rnn.step():
                w = rnn.step_input(x)
                prev = rnn.memory(shape=[-1, H], batch_ref=w)
                h = pkg.layers.fc([w, prev], size=H, act="tanh")
                rnn.update_memory(prev, h)
                rnn.step_output(h)
            out = rnn()
            loss = pkg.layers.mean(out)
            pkg.optimizer.SGD(0.5).minimize(loss)
        return main, startup, [loss, out]

    rng = _rng("static_rnn")
    p, _ = both(build, [{"x": _f(rng, T, B, D)} for _ in range(2)])
    assert p[0][1].shape == (T, B, H)


def test_lstm_layer_bidirectional_two_layers_trains_as_the_jax_package():
    T, B, D, H = 5, 3, 4, 6

    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data(name="x", shape=[T, B, D], dtype="float32")
            h0 = pkg.layers.fill_constant([4, B, H], "float32", 0.0)
            c0 = pkg.layers.fill_constant([4, B, H], "float32", 0.0)
            out, lh, lc = pkg.layers.lstm(x, h0, c0, T, H, num_layers=2,
                                          is_bidirec=True)
            loss = pkg.layers.mean(out)
            pkg.optimizer.SGD(0.5).minimize(loss)
        return main, startup, [loss, out, lh, lc]

    rng = _rng("lstm_layer")
    p, _ = both(build, [{"x": _f(rng, T, B, D)} for _ in range(2)])
    assert p[0][1].shape == (T, B, 2 * H)


# -- the seq2seq base model (PaddleNLP seq2seq, no attention) ----------------

S2S = dict(batch=4, seq=6, hidden=16, layers=2, src_vocab=37, trg_vocab=29)


def stacked_cell(pkg, R, prefix, hidden, layers, dropout, init=None):
    """PaddleNLP's EncoderCell / DecoderCell: LSTMCells stacked, a dropout
    after each when ``dropout`` > 0; the states flat, [h0, c0, h1, c1]."""

    class StackedCell(R.RNNCell):
        def __init__(self):
            self.cells = [R.LSTMCell(
                hidden, param_attr=pkg.ParamAttr(
                    name="%s_l%d_w" % (prefix, i), initializer=init),
                bias_attr=pkg.ParamAttr(
                    name="%s_l%d_b" % (prefix, i), initializer=init))
                for i in range(layers)]

        def call(self, inputs, states):
            new = []
            for i, cell in enumerate(self.cells):
                out, (h, c) = cell.call(inputs, states[2 * i:2 * i + 2])
                inputs = pkg.layers.dropout(
                    out, dropout,
                    dropout_implementation="upscale_in_train") \
                    if dropout > 0 else out
                new += [h, c]
            return inputs, new

        @property
        def state_shape(self):
            return [[hidden]] * (2 * layers)

    return StackedCell()


def seq2seq_train(pkg, cfg, dropout=0.0):
    from importlib import import_module

    R = import_module(pkg.__name__ + ".layers.rnn")
    L = pkg.layers
    B, T, H, NL = cfg["batch"], cfg["seq"], cfg["hidden"], cfg["layers"]
    init = pkg.initializer.UniformInitializer(-0.1, 0.1)
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.data(name="src", shape=[B, T], dtype="int64")
        src_len = pkg.data(name="src_len", shape=[B], dtype="int64")
        trg = pkg.data(name="trg", shape=[B, T], dtype="int64")
        trg_len = pkg.data(name="trg_len", shape=[B], dtype="int64")
        label = pkg.data(name="label", shape=[B, T, 1], dtype="int64")
        src_emb = L.embedding(src, size=[cfg["src_vocab"], H],
                              param_attr=pkg.ParamAttr(
                                  name="source_embedding", initializer=init))
        trg_emb = L.embedding(trg, size=[cfg["trg_vocab"], H],
                              param_attr=pkg.ParamAttr(
                                  name="target_embedding", initializer=init))
        _, enc_final = R.rnn(stacked_cell(pkg, R, "enc", H, NL, dropout,
                                          init),
                             src_emb, sequence_length=src_len)
        dec_out, _ = R.rnn(stacked_cell(pkg, R, "dec", H, NL, dropout, init),
                           trg_emb, initial_states=enc_final,
                           sequence_length=trg_len)
        logits = L.fc(L.reshape(dec_out, [B * T, H]), size=cfg["trg_vocab"],
                      param_attr=pkg.ParamAttr(name="output_w",
                                               initializer=init),
                      bias_attr=False)
        loss = L.softmax_with_cross_entropy(logits,
                                            L.reshape(label, [B * T, 1]))
        mask = L.sequence_mask(trg_len, maxlen=T, dtype="float32")
        loss = L.elementwise_mul(L.reshape(loss, [B, T]), mask)
        loss = L.reduce_sum(L.reduce_mean(loss, dim=[0]))
        pkg.optimizer.AdamOptimizer(
            1e-3, grad_clip=pkg.clip.GradientClipByGlobalNorm(5.0)
        ).minimize(loss)
    return main, startup, loss


def seq2seq_decode(pkg, cfg, beam, steps):
    """The decode program: a new encoder ``rnn`` and a BeamSearchDecoder
    over a new decoder stack, sharing every trained parameter by name."""
    from importlib import import_module

    R = import_module(pkg.__name__ + ".layers.rnn")
    L = pkg.layers
    B, T, H, NL = cfg["batch"], cfg["seq"], cfg["hidden"], cfg["layers"]
    TV = cfg["trg_vocab"]
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.data(name="src", shape=[B, T], dtype="int64")
        src_len = pkg.data(name="src_len", shape=[B], dtype="int64")
        src_emb = L.embedding(src, size=[cfg["src_vocab"], H],
                              param_attr=pkg.ParamAttr(
                                  name="source_embedding"))
        _, enc_final = R.rnn(stacked_cell(pkg, R, "enc", H, NL, 0.0),
                             src_emb, sequence_length=src_len)
        dec = R.BeamSearchDecoder(
            stacked_cell(pkg, R, "dec", H, NL, 0.0), start_token=0,
            end_token=1, beam_size=beam,
            embedding_fn=lambda ids: L.embedding(
                ids, size=[TV, H],
                param_attr=pkg.ParamAttr(name="target_embedding")),
            output_fn=lambda x: L.fc(
                x, size=TV, param_attr=pkg.ParamAttr(name="output_w"),
                bias_attr=False))
        outs, states = R.dynamic_decode(dec, inits=enc_final,
                                        max_step_num=steps)
    return main, startup, [outs, states.log_probs, states.lengths,
                           states.finished]


def seq2seq_feeds(cfg, n, seed=0):
    rng = np.random.RandomState(seed)
    B, T = cfg["batch"], cfg["seq"]
    return [{"src": rng.randint(0, cfg["src_vocab"], (B, T)).astype("int64"),
             "src_len": rng.randint(2, T + 1, B).astype("int64"),
             "trg": rng.randint(0, cfg["trg_vocab"], (B, T)).astype("int64"),
             "trg_len": rng.randint(2, T + 1, B).astype("int64"),
             "label": rng.randint(0, cfg["trg_vocab"],
                                  (B, T, 1)).astype("int64")}
            for _ in range(n)]


def test_seq2seq_trains_three_adam_steps_as_the_jax_package():
    p, _ = both(lambda pkg: (lambda m, s, l: (m, s, [l]))(
        *seq2seq_train(pkg, S2S)), seq2seq_feeds(S2S, 3))
    losses = [float(s[0].reshape(-1)[0]) for s in p]
    assert np.isfinite(losses).all()
    main = seq2seq_train(fluid, S2S)[0]
    ops = [op.type for op in main.global_block().ops]
    # two stacks of two cells, 6 steps each side, forward and grad
    assert ops.count("lstm_unit") == ops.count("lstm_unit_grad") == 24


def test_seq2seq_with_dropout_builds_the_jax_program_and_trains():
    jmain = seq2seq_train(jfluid, S2S, dropout=0.2)[0]
    main, startup, loss = seq2seq_train(fluid, S2S, dropout=0.2)
    assert norm_seq(main) == norm_seq(jmain)
    ops = [op.type for op in main.global_block().ops]
    # a dropout after each cell of each step; the encoder's top output is
    # not read (only its final states are), so 6 take no grad
    assert ops.count("dropout") == 24 and ops.count("dropout_grad") == 18
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = seq2seq_feeds(S2S, 1, seed=5)[0]
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0])
              for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_seq2seq_beam_decode_gives_the_jax_ids():
    feed = seq2seq_feeds(S2S, 1, seed=1)[0]
    feed = {"src": feed["src"], "src_len": feed["src_len"]}
    p, _ = both(lambda pkg: seq2seq_decode(pkg, S2S, beam=3, steps=8),
                [feed])
    ids, scores, lengths, finished = p[0]
    assert ids.shape == (S2S["batch"], 8, 3)
    assert np.isfinite(scores).all() and lengths.max() <= 8


# -- the JAX package's beam-search oracle cases (tests/test_beam_search.py) --

V, H_B, B_B, K_B, T_B = 7, 5, 2, 3, 5
END = 1


def _table_decode(table, time_major=True, name="tab"):
    from paddle_tpu_torch.layers.rnn import (BeamSearchDecoder, RNNCell,
                                             dynamic_decode)

    class TableCell(RNNCell):
        """Next-token logits from the current token through a [V, V]
        table."""

        def __init__(self, table_var):
            self.table = table_var

        def call(self, inputs, states):
            L = fluid.layers
            flat = L.reshape(inputs, [B_B * K_B])
            return L.matmul(L.one_hot(flat, V), self.table), states

    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        tab = fluid.layers.create_parameter(
            [V, V], "float32", name=name,
            default_initializer=fluid.initializer.NumpyArrayInitializer(
                table))
        init = fluid.layers.fill_constant([B_B, H_B], "float32", 0.0)
        dec = BeamSearchDecoder(TableCell(tab), start_token=0,
                                end_token=END, beam_size=K_B)
        outs, states = dynamic_decode(dec, inits=[init], max_step_num=T_B,
                                      output_time_major=time_major)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return [np.asarray(x) for x in exe.run(
        prog, scope=scope, fetch_list=[outs, states.log_probs,
                                       states.finished, states.lengths])]


def _np_beam_search(table, start, end, steps):
    """tests/test_beam_search.py's numpy oracle."""
    def log_softmax(x):
        m = x.max(-1, keepdims=True)
        return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))

    lp = np.full((B_B, K_B), -1e9, np.float64)
    lp[:, 0] = 0.0
    tok = np.full((B_B, K_B), start, np.int64)
    finished = np.zeros((B_B, K_B), bool)
    all_tokens, all_parents = [], []
    for _ in range(steps):
        step_lp = np.log(np.exp(log_softmax(
            table[tok].astype(np.float64))) + 1e-20)
        noend = np.full((V,), -1e9)
        noend[end] = 0.0
        step_lp = np.where(finished[..., None], noend[None, None], step_lp)
        flat = (step_lp + lp[..., None]).reshape(B_B, K_B * V)
        idx = np.argsort(-flat, axis=1, kind="stable")[:, :K_B]
        lp = np.take_along_axis(flat, idx, axis=1)
        parent, tok = idx // V, idx % V
        finished = np.take_along_axis(finished, parent, axis=1) | (tok == end)
        all_tokens.append(tok)
        all_parents.append(parent)
    ids, parents = np.stack(all_tokens), np.stack(all_parents)
    out = np.zeros_like(ids)
    beams = np.tile(np.arange(K_B)[None], (B_B, 1))
    for t in range(steps - 1, -1, -1):
        out[t] = np.take_along_axis(ids[t], beams, axis=1)
        beams = np.take_along_axis(parents[t], beams, axis=1)
    return out, lp


def test_beam_search_matches_the_numpy_oracle():
    table = np.random.RandomState(3).randn(V, V).astype("float32") * 2
    got_ids, got_lp, _, _ = _table_decode(table)
    ref_ids, ref_lp = _np_beam_search(table, 0, END, T_B)
    np.testing.assert_array_equal(got_ids, ref_ids)
    np.testing.assert_allclose(got_lp, ref_lp, rtol=1e-4, atol=1e-4)


def test_finished_beams_emit_end_forever():
    table = np.full((V, V), -5.0, np.float32)
    table[:, END] = 5.0
    got_ids, _, got_fin, got_len = _table_decode(table)
    assert got_fin.all()
    assert (got_ids[1:] == END).all()
    np.testing.assert_array_equal(got_len, [[1, 2, 2]] * B_B)


def test_batch_major_output_shape():
    table = np.random.RandomState(0).randn(V, V).astype("float32")
    o = _table_decode(table, time_major=False, name="tab2")[0]
    assert o.shape == (B_B, T_B, K_B)


# -- the book's recurrent scripts (tests/test_book.py) as twins ------------

def _sentiment(pkg):
    """TestUnderstandSentiment: embedding, an LSTMCell over padded tokens
    with their lengths, max-pool over time, a softmax classifier."""
    from importlib import import_module

    R = import_module(pkg.__name__ + ".layers.rnn")
    Vs, E, H, B, T = 50, 16, 32, 8, 16
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        toks = pkg.data(name="toks", shape=[B, T], dtype="int64")
        lens = pkg.data(name="lens", shape=[B], dtype="int64")
        lab = pkg.data(name="lab", shape=[B, 1], dtype="int64")
        emb = pkg.layers.embedding(toks, size=[Vs, E])
        outs, _ = R.rnn(R.LSTMCell(hidden_size=H), emb, sequence_length=lens)
        pooled = pkg.layers.reduce_max(outs, dim=1)
        pred = pkg.layers.fc(pooled, size=2, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, lab))
        pkg.optimizer.AdamOptimizer(5e-3).minimize(loss)
    return main, startup, [loss]


def test_book_understand_sentiment_trains_as_the_jax_package():
    rng = _rng("sentiment")
    feeds = [{"toks": rng.randint(0, 50, (8, 16)).astype("int64"),
              "lens": rng.randint(1, 17, 8).astype("int64"),
              "lab": rng.randint(0, 2, (8, 1)).astype("int64")}
             for _ in range(3)]
    both(_sentiment, feeds)


MT = dict(B=4, T=6, V=30, E=16, H=32, K=3)


def _mt_train(pkg):
    """TestMachineTranslation's training half: GRUCell encoder and
    decoder, teacher forcing, softmax + cross_entropy."""
    from importlib import import_module

    R = import_module(pkg.__name__ + ".layers.rnn")
    B, T, Vm, E, H = MT["B"], MT["T"], MT["V"], MT["E"], MT["H"]
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.data(name="src", shape=[B, T], dtype="int64")
        trg_in = pkg.data(name="trg_in", shape=[B, T], dtype="int64")
        trg_out = pkg.data(name="trg_out", shape=[B, T], dtype="int64")
        src_emb = L.embedding(src, size=[Vm, E],
                              param_attr=pkg.ParamAttr(name="semb"))
        _, enc_final = R.rnn(R.GRUCell(hidden_size=H, name="enc"), src_emb)
        dec_emb = L.embedding(trg_in, size=[Vm, E],
                              param_attr=pkg.ParamAttr(name="temb"))
        dec_out, _ = R.rnn(R.GRUCell(hidden_size=H, name="dec"), dec_emb,
                           initial_states=enc_final)
        logits = L.fc(L.reshape(dec_out, [B * T, H]), size=Vm,
                      param_attr=pkg.ParamAttr(name="out_w"),
                      bias_attr=False)
        loss = L.mean(L.cross_entropy(L.softmax(logits),
                                      L.reshape(trg_out, [B * T, 1])))
        pkg.optimizer.AdamOptimizer(5e-3).minimize(loss)
    return main, startup, [loss]


def _mt_decode(pkg):
    """TestMachineTranslation's generation half: the trained embeddings,
    encoder projection and output layer shared by name."""
    from importlib import import_module

    R = import_module(pkg.__name__ + ".layers.rnn")
    B, T, Vm, E, H, K = (MT[k] for k in ("B", "T", "V", "E", "H", "K"))
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.data(name="src", shape=[B, T], dtype="int64")
        src_emb = L.embedding(src, size=[Vm, E],
                              param_attr=pkg.ParamAttr(name="semb"))
        enc_cell = R.GRUCell(hidden_size=H, name="enc2")
        enc_cell._proj_attr = pkg.ParamAttr(name="enc_proj_w")
        _, enc_final = R.rnn(enc_cell, src_emb)
        decoder = R.BeamSearchDecoder(
            R.GRUCell(hidden_size=H, name="dec2"), start_token=0,
            end_token=1, beam_size=K,
            embedding_fn=lambda ids: L.embedding(
                ids, size=[Vm, E], param_attr=pkg.ParamAttr(name="temb")),
            output_fn=lambda x: L.fc(
                x, size=Vm, param_attr=pkg.ParamAttr(name="out_w"),
                bias_attr=False))
        outs, _ = R.dynamic_decode(decoder, inits=enc_final, max_step_num=T)
    return main, startup, [outs]


def test_book_machine_translation_trains_and_decodes_as_the_jax_package():
    rng = _rng("mt")
    B, T, Vm = MT["B"], MT["T"], MT["V"]
    feeds = [{k: rng.randint(0, Vm, (B, T)).astype("int64")
              for k in ("src", "trg_in", "trg_out")} for _ in range(3)]
    both(_mt_train, feeds)
    both(_mt_decode, [{"src": feeds[0]["src"]}])


# PaddleNLP seq2seq base (IWSLT'15 en-vi): 2-layer LSTMs of 512, embeddings
# of 512, vocabularies 17191 and 7709, batch 128, sentences cut to 50
S2S_FULL = dict(batch=128, seq=50, hidden=512, layers=2, src_vocab=17191,
                trg_vocab=7709)


def test_seq2seq_at_full_width_builds_the_jax_programs():
    """chip_smoke.py's phases 39-40 at the published width: the training
    program (dropout 0.2, Adam under the clip) and the beam-10 decode of 50
    steps build op for op as in the JAX package (built only, not run), the
    parameters count 25,092,608, and both packages' fusion passes leave
    (ops, fused_bias_act, fused_residual_layer_norm, fused_optimizer) =
    (6095, 0, 0, 1), chip_smoke.SEQ2SEQ_PASSES."""
    import test_torch_recompute as RC
    from paddle_tpu.core import fusion as jfusion
    from paddle_tpu_torch.core import fusion

    jmain = seq2seq_train(jfluid, S2S_FULL, dropout=0.2)[0]
    pmain = seq2seq_train(fluid, S2S_FULL, dropout=0.2)[0]
    assert norm_seq(pmain) == norm_seq(jmain)
    assert sum(int(np.prod(p.shape)) for p in pmain.all_parameters()) == \
        25092608
    jn, pn = RC._passes(jfluid, jfusion, jmain), RC._passes(fluid, fusion,
                                                           pmain)
    assert pn == jn
    types = pn[2]
    assert (len(types), types.count("fused_bias_act"),
            types.count("fused_residual_layer_norm"),
            types.count("fused_optimizer")) == (6095, 0, 0, 1)
    jdec = seq2seq_decode(jfluid, S2S_FULL, beam=10, steps=50)[0]
    pdec = seq2seq_decode(fluid, S2S_FULL, beam=10, steps=50)[0]
    assert norm_seq(pdec) == norm_seq(jdec)
    assert len(pdec.global_block().ops) == 3749
