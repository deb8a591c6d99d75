"""``DynamicRNN`` and the rank-table ops of the port, against the JAX
package and, where the two differ, against an oracle.

- The JAX package's cases (``tests/test_dynamic_rnn.py``, and the two
  ``DynamicRNN`` cases of ``tests/test_while_grad.py``) run through both
  packages from the JAX startup's persistables: outputs, LoDs and grads
  agree, and the numpy and finite-difference oracles of those tests hold
  for the port too.
- Three repairs, where the port takes the reference's semantics and the
  JAX package does not; each test shows the JAX package's result beside
  the port's and holds the port to an oracle:
  1. ``static_input`` shrinks to the sequences still active, so attention
     over ragged targets runs (the JAX package raises in the ``while``)
     and matches a numpy loop over each sequence alone;
  2. ``reorder_lod_tensor_by_rank`` has a grad, so the encoder under
     ``memory(init=)`` and ``static_input`` gets grads (the JAX
     package's stay zero) that match central finite differences, through
     ``while_grad``, which sums the shrunk grads over the trips;
  3. ``shrink_rnn_memory`` keeps whole sequences of a LoD input (the JAX
     package keeps rows), and its grad zero-pads the dropped rows.

Tolerances: outputs and grads within 1e-5 of each tensor's scale (its
largest magnitude, at least 1); the finite differences (float32, step
1e-3) within 5e-3 relative and 1e-4 absolute, as the JAX package's own
test holds them.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid

import test_torch_lr_schedule as LS  # noqa: E402

TOL = 1e-5
FD_EPS, FD_RTOL, FD_ATOL = 1e-3, 5e-3, 1e-4


def close(got, want, what, tol=TOL):
    got, want = np.asarray(got, "float64"), np.asarray(want, "float64")
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, "%s: %.3g off (scale %.3g)" % (what, err,
                                                              scale)


def lod_feed(pkg, x, lengths):
    return pkg.create_lod_tensor(np.asarray(x), [list(map(int, lengths))])


def both(build, feeds, fetch, seed):
    """``build(pkg) -> (main, startup)`` in both packages; the JAX startup
    (its executor seeded) carried into the port; one run of each ``feeds``
    entry; fetched holders (``return_numpy=False``) of the names in
    ``fetch``, a list a run. Returns (jax runs, port runs, port scope,
    port executor, port main)."""
    out = []
    jmain, jstart = build(jfluid)
    pmain, _ = build(fluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe._core.rng.seed = seed
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    pexe = fluid.Executor(fluid.CPUPlace())
    pscope = fluid.Scope()
    LS.carry(jmain, jscope, pmain, pscope)
    for pkg, exe, main, scope in ((jfluid, jexe, jmain, jscope),
                                  (fluid, pexe, pmain, pscope)):
        out.append([[Held(h) for h in exe.run(
            main, feed=f(pkg), fetch_list=fetch, scope=scope,
            return_numpy=False)] for f in feeds])
    return out[0], out[1], pscope, pexe, pmain


class Held:
    """A fetched value copied out of the scope (a fetched persistable is
    the scope's own holder, which the next run overwrites)."""

    def __init__(self, h):
        self.array = np.array(h.array if hasattr(h, "array") else h)
        self._lod = [list(level) for level in h.lod()] \
            if hasattr(h, "lod") else []

    def lod(self):
        return self._lod


def arr(h):
    return np.asarray(h.array if hasattr(h, "array") else h)


# -- the JAX package's cases ------------------------------------------------

D, H = 5, 7
LENGTHS = [4, 1, 3]


def tanh_rnn(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="seq", shape=[-1, D], dtype="float32", lod_level=1)
        drnn = pkg.layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x)
            prev = drnn.memory(shape=[H], value=0.0)
            hidden = pkg.layers.fc(
                [word, prev], size=H, act="tanh",
                param_attr=[pkg.ParamAttr(name="rwx"),
                            pkg.ParamAttr(name="rwh")],
                bias_attr=pkg.ParamAttr(name="rb"))
            drnn.update_memory(prev, hidden)
            drnn.output(hidden)
        out = drnn()
        out.persistable = True  # read back after the run
    return main, startup


def test_tanh_rnn_matches_the_jax_package_and_the_per_sequence_oracle():
    x = np.random.RandomState(3).randn(sum(LENGTHS), D).astype("float32")
    out_name = tanh_rnn(fluid)[0].global_block().ops[-1].output("Out")[0]
    (j,), (p,), scope, _, _ = both(
        tanh_rnn, [lambda pkg: {"seq": lod_feed(pkg, x, LENGTHS)}],
        [out_name], seed=31)
    close(arr(p[0]), arr(j[0]), "output")
    assert p[0].lod() == j[0].lod() == [[0, 4, 5, 8]]
    wx, wh, b = (scope.find_var(n).get_tensor().numpy()
                 for n in ("rwx", "rwh", "rb"))
    want, off = [], 0
    for ln in LENGTHS:
        h = np.zeros(H, "float32")
        for t in range(ln):
            h = np.tanh(x[off + t] @ wx + h @ wh + b)
            want.append(h)
        off += ln
    close(arr(p[0]), np.stack(want), "output against the oracle")


def static_and_init(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="seq2", shape=[-1, 3], dtype="float32",
                     lod_level=1)
        init = pkg.data(name="init", shape=[2, 3], dtype="float32")
        stat = pkg.data(name="stat", shape=[2, 3], dtype="float32",
                        lod_level=1)
        drnn = pkg.layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x)
            prev = drnn.memory(init=init)
            drnn.static_input(stat)
            nxt = pkg.layers.elementwise_add(word, prev)
            drnn.update_memory(prev, nxt)
            drnn.output(nxt)
        drnn()
    return main, startup


def test_static_input_and_init_memory_match_the_jax_package():
    """Running sums seeded by each sequence's ``init`` row; the static
    input (unused, as in the JAX test) shrinks without changing them."""
    rng = np.random.RandomState(9)
    lengths = [1, 3]
    x = rng.randn(4, 3).astype("float32")
    init = rng.randn(2, 3).astype("float32")
    stat = rng.randn(2, 3).astype("float32")
    out_name = static_and_init(fluid)[0].global_block().ops[-1] \
        .output("Out")[0]

    def feed(pkg):
        return {"seq2": lod_feed(pkg, x, lengths), "init": init,
                "stat": lod_feed(pkg, stat, [1, 1])}

    (j,), (p,), _, _, _ = both(static_and_init, [feed], [out_name], seed=32)
    close(arr(p[0]), arr(j[0]), "output")
    assert p[0].lod() == j[0].lod()
    want = [init[0] + x[0], init[1] + x[1], init[1] + x[1] + x[2],
            init[1] + x[1] + x[2] + x[3]]
    close(arr(p[0]), np.stack(want), "output against the oracle")


def trained_rnn(pkg, lr=0.0, input_grad=False, bias=True):
    """The JAX while_grad tests' net: ``lr`` 0 keeps the parameters where
    they are, so repeated runs see one function."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data(name="seq", shape=[-1, 3], dtype="float32",
                     lod_level=1)
        if input_grad:
            x.stop_gradient = False
        drnn = pkg.layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x)
            prev = drnn.memory(shape=[4], value=0.0)
            hidden = pkg.layers.fc(
                [word, prev], size=4, act="tanh",
                param_attr=[pkg.ParamAttr(name="gwx"),
                            pkg.ParamAttr(name="gwh")],
                bias_attr=pkg.ParamAttr(name="gb") if bias else False)
            drnn.update_memory(prev, hidden)
            drnn.output(hidden)
        out = drnn()
        loss = pkg.layers.reduce_mean(
            pkg.layers.sequence_pool(out, pool_type="SUM"))
        loss.persistable = True
        pkg.optimizer.SGDOptimizer(lr).minimize(loss)
    return main, startup


def loss_name(main):
    return [op for op in main.global_block().ops
            if op.type == "reduce_mean"][0].output("Out")[0]


def test_training_through_dynamic_rnn_matches_the_jax_package():
    """The loss and every weight's grad through ``while_grad`` agree with
    the JAX package's; the port's W_x grad matches central differences;
    four SGD steps at rate 0.5 give the JAX package's losses."""
    lengths = [3, 1, 2]
    x = np.random.RandomState(11).randn(6, 3).astype("float32")
    main = trained_rnn(fluid)[0]
    names = [loss_name(main), "gwx@GRAD", "gwh@GRAD", "gb@GRAD"]

    def feed(pkg):
        return {"seq": lod_feed(pkg, x, lengths)}

    (j,), (p,), scope, exe, main = both(trained_rnn, [feed], names, seed=33)
    for name, a, b in zip(names, p, j):
        close(arr(a), arr(b), name)

    def run_loss():
        (l,) = exe.run(main, feed=feed(fluid), fetch_list=[names[0]],
                       scope=scope)
        return float(np.ravel(l)[0])

    g = arr(p[1])
    w = scope.find_var("gwx").get_tensor().numpy().copy()
    for idx in [(0, 0), (1, 2), (2, 3)]:
        sides = []
        for sign in (1, -1):
            w2 = w.copy()
            w2[idx] += sign * FD_EPS
            scope.var("gwx").get_tensor().set(w2)
            sides.append(run_loss())
        scope.var("gwx").get_tensor().set(w)
        np.testing.assert_allclose(g[idx], (sides[0] - sides[1])
                                   / (2 * FD_EPS), rtol=FD_RTOL,
                                   atol=FD_ATOL)

    j4, p4, _, _, _ = both(lambda pkg: trained_rnn(pkg, lr=0.5), [feed] * 4,
                           names[:1], seed=33)
    losses = [[float(np.ravel(arr(r[0]))[0]) for r in runs]
              for runs in (j4, p4)]
    close(losses[1], losses[0], "losses over four SGD steps")
    assert abs(losses[1][-1] - losses[1][0]) > 1e-6


def test_input_grad_is_recomputed_every_run_as_in_the_jax_package():
    """The input's grad array is made fresh each run: three runs give the
    JAX package's grad three times."""
    x = np.random.RandomState(13).randn(4, 3).astype("float32")

    def feed(pkg):
        return {"seq": lod_feed(pkg, x, [2, 2])}

    j, p, _, _, _ = both(lambda pkg: trained_rnn(pkg, input_grad=True,
                                                 bias=False),
                         [feed] * 3, ["seq@GRAD"], seed=34)
    for run in range(3):
        close(arr(p[run][0]), arr(j[0][0]), "seq@GRAD, run %d" % run)


# -- the three repairs --------------------------------------------------------

SRC_LENGTHS = [3, 5, 2]
DA, HA = 4, 6  # encoder rows, decoder state


def attention_rnn(pkg):
    """``simple_attention`` (as RNNsearch's) inside a ``DynamicRNN`` over
    the target, the encoder rows its static inputs."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        enc = pkg.data(name="enc", shape=[-1, DA], dtype="float32",
                       lod_level=1)
        trg = pkg.data(name="trg", shape=[-1, 3], dtype="float32",
                       lod_level=1)
        proj = L.fc(enc, size=HA, bias_attr=False,
                    param_attr=pkg.ParamAttr(name="proj_w"))
        drnn = L.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(trg)
            ev = drnn.static_input(enc)
            pv = drnn.static_input(proj)
            h = drnn.memory(shape=[HA], value=0.0)
            sp = L.fc(h, size=HA, bias_attr=False,
                      param_attr=pkg.ParamAttr(name="state_w"))
            mixed = L.elementwise_add(pv, L.sequence_expand(sp, pv))
            a = L.sequence_softmax(L.fc(mixed, size=1, bias_attr=False,
                                        param_attr=pkg.ParamAttr(
                                            name="att_w")))
            ctx = L.sequence_pool(L.elementwise_mul(
                ev, L.reshape(a, shape=[-1]), axis=0), "sum")
            nh = L.fc(L.concat([ctx, word], axis=1), size=HA, act="tanh",
                      param_attr=pkg.ParamAttr(name="out_w"),
                      bias_attr=pkg.ParamAttr(name="out_b"))
            drnn.update_memory(h, nh)
            drnn.output(nh)
        out = drnn()
        out.persistable = True
    return main, startup


def attention_oracle(scope, enc, trg, trg_lengths):
    w = {n: scope.find_var(n).get_tensor().numpy()
         for n in ("proj_w", "state_w", "att_w", "out_w", "out_b")}
    rows, e_off, t_off = [], 0, 0
    for m, ln in zip(SRC_LENGTHS, trg_lengths):
        e = enc[e_off:e_off + m]
        pr = e @ w["proj_w"]
        h = np.zeros(HA, "float32")
        for t in range(ln):
            s = (pr + h @ w["state_w"]) @ w["att_w"][:, 0]
            a = np.exp(s - s.max())
            a /= a.sum()
            ctx = (a[:, None] * e).sum(0)
            h = np.tanh(np.concatenate([ctx, trg[t_off + t]]) @ w["out_w"]
                        + w["out_b"])
            rows.append(h)
        e_off += m
        t_off += ln
    return np.stack(rows)


def test_attention_over_ragged_targets_matches_a_per_sequence_loop():
    """Repair 1. Targets of lengths [4, 2, 3]: the JAX package's static
    input keeps every sequence while the step's state has shrunk, and its
    ``while`` raises; the port's shrinks, and matches each sequence run
    alone in numpy. With equal lengths the two packages agree."""
    rng = np.random.RandomState(21)
    enc = rng.randn(sum(SRC_LENGTHS), DA).astype("float32")
    out_name = attention_rnn(fluid)[0].global_block().ops[-1] \
        .output("Out")[0]
    for trg_lengths in ([4, 2, 3], [3, 3, 3]):
        trg = rng.randn(sum(trg_lengths), 3).astype("float32")

        def feed(pkg):
            return {"enc": lod_feed(pkg, enc, SRC_LENGTHS),
                    "trg": lod_feed(pkg, trg, trg_lengths)}

        if len(set(trg_lengths)) > 1:
            with pytest.raises(Exception, match="concat|shape|broadcast"):
                both(attention_rnn, [feed], [out_name], seed=35)
            pmain, pstart = attention_rnn(fluid)
            scope = fluid.Scope()
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(pstart, scope=scope)
            (p,) = exe.run(pmain, feed=feed(fluid), fetch_list=[out_name],
                           scope=scope, return_numpy=False)
        else:
            (j,), (p,), scope, _, _ = both(attention_rnn, [feed],
                                           [out_name], seed=35)
            close(arr(p[0]), arr(j[0]), "equal lengths, against JAX")
            p = p[0]
        assert p.lod() == [list(np.cumsum([0] + trg_lengths))]
        close(arr(p), attention_oracle(scope, enc, trg, trg_lengths),
              "lengths %s against the oracle" % trg_lengths)


def boot_rnn(pkg):
    """An encoder (``fc`` over the source rows) whose first rows boot a
    ``DynamicRNN`` through ``memory(init=)`` and whose rows are its
    ``static_input``, summed each step."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.data(name="src", shape=[-1, 3], dtype="float32",
                       lod_level=1)
        trg = pkg.data(name="trg", shape=[-1, 2], dtype="float32",
                       lod_level=1)
        enc = L.fc(src, size=4, act="tanh", bias_attr=False,
                   param_attr=pkg.ParamAttr(name="enc_w"))
        boot = L.fc(L.sequence_pool(enc, "first"), size=4, act="tanh",
                    bias_attr=False, param_attr=pkg.ParamAttr(name="boot_w"))
        drnn = L.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(trg)
            ev = drnn.static_input(enc)
            h = drnn.memory(init=boot)
            nh = L.fc([word, h, L.sequence_pool(ev, "sum")], size=4,
                      act="tanh",
                      param_attr=[pkg.ParamAttr(name="dw_x"),
                                  pkg.ParamAttr(name="dw_h"),
                                  pkg.ParamAttr(name="dw_c")],
                      bias_attr=False)
            drnn.update_memory(h, nh)
            drnn.output(nh)
        loss = L.reduce_mean(L.sequence_pool(drnn(), "sum"))
        loss.persistable = True
        pkg.backward.append_backward(loss)
    return main, startup


def test_encoder_grads_through_init_and_static_input_match_differences():
    """Repair 2. The encoder's weight gets its grad through
    ``reorder_lod_tensor_by_rank_grad`` (memory(init=) and static_input)
    and the ``shrink_rnn_memory`` grads that ``while_grad`` sums over the
    trips: central differences agree, at ragged and at equal target
    lengths. The JAX package computes the same loss at equal lengths, and
    no grad for the encoder."""
    rng = np.random.RandomState(22)
    src_len = [2, 4, 3]
    src = rng.randn(sum(src_len), 3).astype("float32")
    main = boot_rnn(fluid)[0]
    names = [loss_name(main), "enc_w@GRAD", "boot_w@GRAD", "dw_h@GRAD"]
    for trg_len in ([3, 1, 2], [2, 2, 2]):
        trg = rng.randn(sum(trg_len), 2).astype("float32")

        def feed(pkg):
            return {"src": lod_feed(pkg, src, src_len),
                    "trg": lod_feed(pkg, trg, trg_len)}

        if len(set(trg_len)) == 1:
            (j,), (p,), scope, exe, main = both(
                lambda pkg: boot_rnn(pkg), [feed], names[:1] + names[3:],
                seed=36)
            close(arr(p[0]), arr(j[0]), "the loss against JAX")
            close(arr(p[1]), arr(j[1]), "the decoder's grad against JAX")
            jmain = boot_rnn(jfluid)[0]
            assert not any("enc_w@GRAD" in op.output_arg_names
                           for op in jmain.global_block().ops), \
                "the JAX package now makes an encoder grad"
        pmain, pstart = boot_rnn(fluid)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(pstart, scope=scope)
        got = [arr(r) for r in exe.run(pmain, feed=feed(fluid),
                                        fetch_list=names, scope=scope)]
        for pname, g in (("enc_w", got[1]), ("boot_w", got[2])):
            assert np.abs(g).max() > 1e-4, pname
            w = scope.find_var(pname).get_tensor().numpy().copy()
            for idx in [(0, 0), (1, 2), (2, 3)]:
                sides = []
                for sign in (1, -1):
                    w2 = w.copy()
                    w2[idx] += sign * FD_EPS
                    scope.var(pname).get_tensor().set(w2)
                    (l,) = exe.run(pmain, feed=feed(fluid),
                                   fetch_list=names[:1], scope=scope)
                    sides.append(float(np.ravel(l)[0]))
                scope.var(pname).get_tensor().set(w)
                np.testing.assert_allclose(
                    g[idx], (sides[0] - sides[1]) / (2 * FD_EPS),
                    rtol=FD_RTOL, atol=FD_ATOL,
                    err_msg="%s%s at lengths %s" % (pname, idx, trg_len))


def shrink_program(pkg):
    """``shrink_rnn_memory`` of a LoD input at step 1 of a rank table of
    lengths [3, 1, 2], and its grad."""
    main, startup = pkg.Program(), pkg.Program()
    blk = main.global_block()
    for name, dt in (("lens", "float32"), ("x", "float32"), ("i", "int64"),
                     ("table", None), ("out", "float32"),
                     ("out@GRAD", "float32"), ("x@GRAD", "float32")):
        blk.create_var(name=name, dtype=dt, persistable=True)
    blk.append_op("lod_rank_table", {"X": ["lens"]}, {"Out": ["table"]},
                  {"level": 0}, infer_shape=False)
    blk.append_op("shrink_rnn_memory",
                  {"X": ["x"], "RankTable": ["table"], "I": ["i"]},
                  {"Out": ["out"]}, {}, infer_shape=False)
    blk.append_op("shrink_rnn_memory_grad",
                  {"X": ["x"], "Out@GRAD": ["out@GRAD"]},
                  {"X@GRAD": ["x@GRAD"]}, {}, infer_shape=False)
    return main, startup


def test_shrink_rnn_memory_keeps_whole_sequences_of_a_lod_input():
    """Repair 3. At step 1 two sequences are active: of an input whose
    LoD is [[0, 2, 5, 6]] the port keeps the first two sequences, rows
    0-4, with their LoD (the reference's sub-LoD), where the JAX package
    keeps rows 0-1; the grad zero-pads back to six rows either way."""
    x = np.arange(12, dtype="float32").reshape(6, 2)
    got = {}
    for pkg in (jfluid, fluid):
        main, _ = shrink_program(pkg)
        scope = pkg.Scope()
        kept = 5 if pkg is fluid else 2
        feed = {"lens": lod_feed(pkg, np.zeros((6, 1), "float32"),
                                 [3, 1, 2]),
                "x": lod_feed(pkg, x, [2, 3, 1]),
                "i": np.array([1], "int64"),
                "out@GRAD": np.ones((kept, 2), "float32")}
        exe = pkg.Executor(pkg.CPUPlace())
        out, g = exe.run(main, feed=feed, fetch_list=["out", "x@GRAD"],
                         scope=scope, return_numpy=False)
        got[pkg.__name__] = (arr(out), out.lod(), arr(g))
    j, p = got["paddle_tpu"], got["paddle_tpu_torch"]
    np.testing.assert_array_equal(j[0], x[:2])
    np.testing.assert_array_equal(p[0], x[:5])
    assert p[1] == [[0, 2, 5]]
    want = np.zeros((6, 2), "float32")
    want[:5] = 1.0
    np.testing.assert_array_equal(p[2], want)
    np.testing.assert_array_equal(j[2][:2], 1.0)
    np.testing.assert_array_equal(j[2][2:], 0.0)
